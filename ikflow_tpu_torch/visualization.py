"""Headless demo renders: skeleton plots and solution-sweep animations.

Port of ``ikflow_tpu/visualization.py``: ``visualize_fk``,
``oscillate_latent``, ``oscillate_target`` and ``oscillate_joints`` (the
reference's Klampt demos) as matplotlib PNG frames and GIF animations. A
whole animation's solutions come from one batched solver call, and its
skeletons from one batched FK call, on the solver's (or ``device``'s)
device; only the drawing runs on the host.

matplotlib is imported inside the demos, so the module imports without it;
a demo raises an ``ImportError`` that points to ``viz_interactive`` (the
``--interactive`` HTML scene), which needs only numpy and torch.
"""

from __future__ import annotations

import numpy as np
import torch

# Per-robot demo target poses (the reference's table, visualizations.py:20-39).
_TARGET_POSES = {
    "panda": np.array([0.25, 0.65, 0.45, 1.0, 0.0, 0.0, 0.0]),
    "fetch": np.array([0.45, 0.65, 0.55, 1.0, 0.0, 0.0, 0.0]),
    "fetch_arm": np.array([0.45, 0.65, 0.55, 1.0, 0.0, 0.0, 0.0]),
    "rizon4": np.array([0.3, 0.5, 0.4, 1.0, 0.0, 0.0, 0.0]),
}


def demo_target_pose(robot_name: str) -> np.ndarray:
    return _TARGET_POSES.get(robot_name, np.array([0.3, 0.4, 0.4, 1.0, 0, 0, 0]))


def skeleton_points(robot, q: torch.Tensor) -> torch.Tensor:
    """Joint-origin polylines: (..., ndof) -> (..., L + 1, 3), the base first,
    on the input's device."""
    _, ps = robot.fk_frames(q)
    base = torch.zeros(ps.shape[:-2] + (1, 3), dtype=ps.dtype, device=ps.device)
    return torch.cat([base, ps], dim=-2)


def _pyplot():
    """matplotlib with the Agg backend, and its animation module."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the PNG/GIF demos need matplotlib, which is not installed; "
                          "use `ikflow-torch visualize --interactive` (ikflow_tpu_torch.viz_interactive) "
                          "for the self-contained HTML scene") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    return plt, animation


def _setup_ax(ax, title: str) -> None:
    ax.set_xlim(-1, 1)
    ax.set_ylim(-1, 1)
    ax.set_zlim(0, 1.4)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.set_title(title)


def _animate(frames_pts, title: str, out_path: str, fps: int, targets=None, markersize: int = 4) -> str:
    """A GIF of ``frames_pts`` ((frames, skeletons, L + 1, 3) numpy), with a
    target marker per frame where ``targets`` ((frames, 3)) is given."""
    plt, animation = _pyplot()
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    alpha = 0.7 if frames_pts.shape[1] > 1 else 1.0

    def draw(i):
        ax.clear()
        _setup_ax(ax, title)
        for pts in frames_pts[i]:
            ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], "-o", markersize=markersize, alpha=alpha)
        if targets is not None:
            ax.scatter(*targets[i], color="red", s=60, marker="*")
        return []

    ani = animation.FuncAnimation(fig, draw, frames=frames_pts.shape[0])
    ani.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path


def visualize_fk(robot, n_configs: int = 6, out_path: str = "fk_visualization.png", seed: int = 0,
                 device="cuda") -> str:
    """``n_configs`` random configurations' skeletons in one PNG (the
    reference's ``visualize_fk``)."""
    plt, _ = _pyplot()
    from ikflow_tpu_torch.config import resolve_device

    g = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    pts = skeleton_points(robot, robot.sample_joint_angles(n_configs, g)).cpu().numpy()
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    _setup_ax(ax, robot.name)
    for p in pts:
        ax.plot(p[:, 0], p[:, 1], p[:, 2], "-o", markersize=3, alpha=0.8)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def oscillate_latent(solver, target_pose=None, n_frames: int = 60, out_path: str = "oscillate_latent.gif",
                     latent_scale: float = 1.0, fps: int = 15) -> str:
    """Fixed pose, each latent dimension swept sinusoidally with its own
    phase: the family of solutions of one pose (the reference's
    ``oscillate_latent``)."""
    _pyplot()
    robot = solver.robot
    target_pose = demo_target_pose(robot.name) if target_pose is None else np.asarray(target_pose)
    D = solver.network_width
    t = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    latents = np.stack([latent_scale * np.sin(t + 2 * np.pi * d / D) for d in range(D)], axis=1)
    sols = solver.generate_ik_solutions(np.tile(target_pose.astype(np.float32), (n_frames, 1)),
                                        latent=latents.astype(np.float32), allow_uninitialized=True)
    pts = skeleton_points(robot, sols).cpu().numpy()[:, None]
    return _animate(pts, f"{robot.name} — latent sweep", out_path, fps,
                    targets=np.tile(target_pose[:3], (n_frames, 1)))


def oscillate_target(solver, n_solutions: int = 5, n_frames: int = 60, radius: float = 0.15,
                     out_path: str = "oscillate_target.gif", fixed_latent: bool = True, fps: int = 15,
                     seed: int = 0) -> str:
    """A target moving on a circle in the x-z plane, ``n_solutions`` per
    frame, with the same latents in every frame unless ``fixed_latent`` is
    off (the reference's ``oscillate_target``)."""
    _pyplot()
    robot = solver.robot
    t = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    poses = np.tile(demo_target_pose(robot.name), (n_frames, 1)).astype(np.float32)
    poses[:, 0] += radius * np.cos(t)
    poses[:, 2] += radius * np.sin(t)
    g = torch.Generator(device=solver.device).manual_seed(seed)
    latent = None
    if fixed_latent:
        latent = torch.randn((n_solutions, solver.network_width), generator=g, device=solver.device).repeat(n_frames, 1)
    sols = solver.generate_ik_solutions(np.repeat(poses, n_solutions, axis=0), latent=latent, generator=g,
                                        allow_uninitialized=True)
    pts = skeleton_points(robot, sols).cpu().numpy().reshape(n_frames, n_solutions, -1, 3)
    return _animate(pts, f"{robot.name} — target sweep", out_path, fps, targets=poses[:, :3], markersize=3)


def oscillate_joints(robot, n_frames: int = 60, out_path: str = "oscillate_joints.gif", fps: int = 15,
                     device="cuda") -> str:
    """Every joint swept between its limits in phase (the reference's
    ``oscillate_joints``)."""
    _pyplot()
    from ikflow_tpu_torch.config import resolve_device

    low = np.array([lim[0] for lim in robot.actuated_joints_limits])
    high = np.array([lim[1] for lim in robot.actuated_joints_limits])
    t = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    qs = (low + 0.5 * (1 + np.sin(t))[:, None] * (high - low)).astype(np.float32)
    pts = skeleton_points(robot, torch.as_tensor(qs, device=resolve_device(device))).cpu().numpy()[:, None]
    return _animate(pts, f"{robot.name} — joint sweep", out_path, fps)
