"""Interactive 3-D scenes: one self-contained HTML file per demo.

Port of ``ikflow_tpu/viz_interactive.py``. A demo's solutions come from one
batched solver call and its collision capsules (the robot's, as
``config_self_collides`` uses them) from one batched FK call on the
solver's (or ``device``'s) device; the frames are written as one ``.html``
file with a vanilla-JS orbit renderer (drag to rotate, wheel to zoom,
play/pause and a frame slider) that draws the capsules far to near. It
needs no network and no package beyond numpy and torch.

Demos: ``interactive_fk`` (random configurations), ``interactive_oscillate_latent``
(one pose, latent swept on a circle), ``interactive_oscillate_joints`` (every
joint swept through its limits), ``interactive_oscillate_target`` (moving
pose, fixed latents).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ikflow_tpu_torch.config import resolve_device
from ikflow_tpu_torch.visualization import demo_target_pose

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { margin:0; background:#10141a; color:#cfd8e3; font:13px system-ui, sans-serif; }
 #hud { position:fixed; top:10px; left:12px; user-select:none; }
 #hud h1 { font-size:15px; margin:0 0 4px 0; color:#e8eef5; }
 #controls { position:fixed; bottom:12px; left:12px; right:12px; display:flex;
             gap:10px; align-items:center; }
 #frame { flex:1; }
 button { background:#2a3442; color:#e8eef5; border:0; border-radius:4px;
          padding:5px 14px; cursor:pointer; }
 canvas { display:block; }
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><h1>__TITLE__</h1>
<div>drag: orbit &nbsp; wheel: zoom &nbsp; __SUBTITLE__</div>
<div id="info"></div></div>
<div id="controls">
 <button id="play">&#9658;</button>
 <input type="range" id="frame" min="0" max="0" value="0" step="1">
 <span id="flabel"></span>
</div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function resize(){ W = cv.width = innerWidth; H = cv.height = innerHeight; }
resize(); addEventListener('resize', () => { resize(); draw(); });
let yaw = 0.9, pitch = 0.35, dist = 2.6, frame = 0, playing = true;
const center = DATA.center;
function proj(p){
  const cy = Math.cos(yaw), sy = Math.sin(yaw), cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x0 = p[0]-center[0], y0 = p[1]-center[1], z0 = p[2]-center[2];
  const x1 = cy*x0 + sy*y0, y1 = -sy*x0 + cy*y0;         // yaw about +z
  const y2 = cp*y1 - sp*z0, z2 = sp*y1 + cp*z0;          // pitch
  const d = dist - y2;                                    // camera on -y axis
  const f = 0.9 * Math.min(W, H) / Math.max(d, 0.05);
  return [W/2 + f*x1, H*0.54 - f*z2, d, f];
}
function capsule2d(a, b, r, color, alpha){
  const pa = proj(a), pb = proj(b);
  ctx.globalAlpha = alpha;
  ctx.strokeStyle = color; ctx.fillStyle = color;
  ctx.lineWidth = Math.max(1, r * (pa[3] + pb[3]));
  ctx.lineCap = 'round';
  ctx.beginPath(); ctx.moveTo(pa[0], pa[1]); ctx.lineTo(pb[0], pb[1]); ctx.stroke();
  return (pa[2] + pb[2]) / 2;
}
function drawAxes(){
  const O = [0,0,0];
  for (const [v, col] of [[[0.25,0,0],'#e05d5d'], [[0,0.25,0],'#57c27a'], [[0,0,0.25],'#5d8de0']]){
    const po = proj(O), pv = proj(v);
    ctx.globalAlpha = 0.9; ctx.strokeStyle = col; ctx.lineWidth = 2;
    ctx.beginPath(); ctx.moveTo(po[0], po[1]); ctx.lineTo(pv[0], pv[1]); ctx.stroke();
  }
}
function draw(){
  ctx.globalAlpha = 1; ctx.fillStyle = '#10141a'; ctx.fillRect(0, 0, W, H);
  drawAxes();
  const fr = DATA.frames[frame];
  const items = [];
  fr.sols.forEach((caps, si) => {
    const col = DATA.colors[si % DATA.colors.length];
    caps.forEach(c => items.push({a:c[0], b:c[1], r:c[2], col:col,
                                  alpha: fr.sols.length > 1 ? 0.75 : 0.95}));
  });
  // painter's algorithm: far first
  items.map(it => ({it, d: (proj(it.a)[2] + proj(it.b)[2]) / 2}))
       .sort((x, y) => y.d - x.d)
       .forEach(({it}) => capsule2d(it.a, it.b, it.r, it.col, it.alpha));
  if (fr.target){
    const pt = proj(fr.target);
    ctx.globalAlpha = 1; ctx.strokeStyle = '#ffd166'; ctx.lineWidth = 2;
    ctx.beginPath(); ctx.arc(pt[0], pt[1], 7, 0, 6.283); ctx.stroke();
    ctx.beginPath(); ctx.arc(pt[0], pt[1], 1.5, 0, 6.283); ctx.stroke();
  }
  document.getElementById('flabel').textContent = (frame+1) + '/' + DATA.frames.length;
  document.getElementById('info').textContent = fr.label || '';
}
let dragging = false, lx = 0, ly = 0;
cv.addEventListener('mousedown', e => { dragging = true; lx = e.clientX; ly = e.clientY; });
addEventListener('mouseup', () => dragging = false);
addEventListener('mousemove', e => {
  if (!dragging) return;
  yaw += (e.clientX - lx) * 0.008; pitch += (e.clientY - ly) * 0.008;
  pitch = Math.max(-1.4, Math.min(1.4, pitch));
  lx = e.clientX; ly = e.clientY; draw();
});
cv.addEventListener('wheel', e => { dist *= Math.exp(e.deltaY * 0.001); draw(); e.preventDefault(); });
const slider = document.getElementById('frame');
slider.max = DATA.frames.length - 1;
slider.addEventListener('input', () => { frame = +slider.value; playing = false; draw(); });
document.getElementById('play').addEventListener('click', () => playing = !playing);
setInterval(() => {
  if (playing && DATA.frames.length > 1){
    frame = (frame + 1) % DATA.frames.length; slider.value = frame; draw();
  }
}, 1000 / DATA.fps);
draw();
</script></body></html>
"""

_COLORS = ["#6ec6ff", "#ffb74d", "#aed581", "#f48fb1", "#b39ddb", "#80cbc4",
           "#fff176", "#ff8a65", "#90caf9", "#c5e1a5"]


def capsules_world(robot, q: torch.Tensor):
    """Per configuration of ``q`` (frames, ndof), its capsules as
    ``[[p0, p1, radius], ...]`` in the world frame, end points rounded to
    0.1 mm, from one batched FK call on ``q``'s device."""
    ends = np.round(robot.capsule_endpoints(q).double().cpu().numpy(), 4)
    radii = [float(cap.radius) for cap in robot.capsules]
    return [[[list(e[0]), list(e[1]), r] for e, r in zip(frame, radii)] for frame in ends]


def _write(out_path: str, title: str, subtitle: str, frames, fps: int, center) -> str:
    payload = {"frames": frames, "fps": fps, "colors": _COLORS, "center": [float(c) for c in center]}
    html = (
        _HTML_TEMPLATE
        .replace("__TITLE__", title)
        .replace("__SUBTITLE__", subtitle)
        .replace("__DATA__", json.dumps(payload))
    )
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def interactive_fk(robot, n_configs: int = 5, out_path: str = "fk_interactive.html", seed: int = 0,
                   device="cuda") -> str:
    """Random configurations as an orbitable scene, one per frame."""
    g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    caps = capsules_world(robot, robot.sample_joint_angles(n_configs, g))
    frames = [{"sols": [c], "label": f"config {i + 1}"} for i, c in enumerate(caps)]
    return _write(out_path, f"{robot.name} — forward kinematics", "frames: random configs", frames, fps=1,
                  center=(0, 0, 0.5))


def interactive_oscillate_latent(solver, target_pose: Optional[np.ndarray] = None, n_frames: int = 72,
                                 out_path: str = "oscillate_latent_interactive.html",
                                 allow_uninitialized: bool = False) -> str:
    """One target pose, the first two latent dimensions swept on a circle of
    radius 1.2: every frame is a solution of the same pose."""
    robot = solver.robot
    target_pose = demo_target_pose(robot.name) if target_pose is None else np.asarray(target_pose)
    ts = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    latents = np.zeros((n_frames, solver.network_width), dtype=np.float32)
    latents[:, 0] = 1.2 * np.cos(ts)
    latents[:, 1] = 1.2 * np.sin(ts)
    q = solver.generate_ik_solutions(np.tile(target_pose.astype(np.float32), (n_frames, 1)), latent=latents,
                                     allow_uninitialized=allow_uninitialized)
    frames = [{"sols": [c], "target": list(map(float, target_pose[:3])), "label": f"latent phase {t:.2f} rad"}
              for t, c in zip(ts, capsules_world(robot, q))]
    return _write(out_path, f"{robot.name} — oscillate latent", "fixed pose, latent swept on a circle", frames,
                  fps=12, center=(0, 0, 0.5))


def interactive_oscillate_joints(robot, n_frames: int = 72, out_path: str = "oscillate_joints_interactive.html",
                                 device="cuda") -> str:
    """Every joint swept through its limits, joint i's phase offset by
    2 pi i / ndof."""
    ts = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    low = np.array([lim[0] for lim in robot.actuated_joints_limits])
    high = np.array([lim[1] for lim in robot.actuated_joints_limits])
    phases = ts[:, None] + 2 * np.pi * np.arange(robot.ndof) / robot.ndof
    q = 0.5 * (low + high) + 0.5 * (high - low) * np.sin(phases)
    caps = capsules_world(robot, torch.as_tensor(q, dtype=torch.float32, device=resolve_device(device)))
    frames = [{"sols": [c], "label": f"joint sweep phase {t:.2f} rad"} for t, c in zip(ts, caps)]
    return _write(out_path, f"{robot.name} — oscillate joints", "all joints swept through their limits", frames,
                  fps=12, center=(0, 0, 0.5))


def interactive_oscillate_target(solver, n_frames: int = 72, n_solutions: int = 6,
                                 out_path: str = "oscillate_target_interactive.html",
                                 allow_uninitialized: bool = False) -> str:
    """The target swept on a circle of radius 0.15 in the x-y plane,
    ``n_solutions`` per frame from the same latents (seed 7) in every
    frame, all in one batched call."""
    robot = solver.robot
    ts = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    targets = np.tile(demo_target_pose(robot.name)[None], (n_frames, 1)).astype(np.float32)
    targets[:, 0] += 0.15 * np.cos(ts)
    targets[:, 1] += 0.15 * np.sin(ts)
    g = torch.Generator(device=solver.device).manual_seed(7)
    latents = torch.randn((n_solutions, solver.network_width), generator=g, device=solver.device)
    q = solver.generate_ik_solutions(np.repeat(targets, n_solutions, axis=0), latent=latents.repeat(n_frames, 1),
                                     allow_uninitialized=allow_uninitialized)
    caps = capsules_world(robot, q)
    frames = [{"sols": caps[i * n_solutions:(i + 1) * n_solutions], "target": list(map(float, targets[i, :3])),
               "label": f"{n_solutions} solutions, fixed latents"} for i in range(n_frames)]
    return _write(out_path, f"{robot.name} — oscillate target", "moving pose, fixed latents", frames, fps=12,
                  center=(0, 0, 0.5))
