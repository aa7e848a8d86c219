"""The port's visualization (``ikflow_tpu_torch/visualization.py``,
``viz_interactive.py``) on the CPU against the JAX package's.

- skeleton points and capsule end points of the same configurations within
  1e-6 m (the port in float64 against JAX's float32 FK and its float64 host
  capsules);
- the PNG/GIF demos write their files, and with matplotlib hidden they raise
  an ImportError that names matplotlib and ``--interactive``;
- the interactive HTML scene: the same payload as JAX's for the same frames
  (the joint sweep, whose frames need no draw), its end points within one
  0.1-mm rounding step plus 1e-6 (each package rounds its own FK to 4
  decimals), and for every demo the same frame count, keys and labels.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from ikflow_tpu import viz_interactive as jax_ivz
from ikflow_tpu import visualization as jax_viz
from ikflow_tpu.robots import get_robot as jax_get_robot
from ikflow_tpu_torch import visualization as viz
from ikflow_tpu_torch import viz_interactive as ivz
from ikflow_tpu_torch.robots import get_robot
from test_torch_fleet import _tiny_solver

CPU = torch.device("cpu")


def _configs(robot, n=6, seed=0):
    low, high = robot.limits_low().numpy(), robot.limits_high().numpy()
    return (low + np.random.default_rng(seed).uniform(size=(n, robot.ndof)) * (high - low)).astype(np.float32)


@pytest.mark.parametrize("name", ["panda", "fetch", "fetch_arm", "rizon4"])
def test_skeleton_and_capsules_match_jax(name):
    robot, jrobot = get_robot(name), jax_get_robot(name)
    q = _configs(robot)
    pts = viz.skeleton_points(robot, torch.from_numpy(q).double()).numpy()
    ends = robot.capsule_endpoints(torch.from_numpy(q).double()).numpy()
    assert ends.shape == (q.shape[0], len(robot.capsules), 2, 3)
    for i, qi in enumerate(q):
        np.testing.assert_allclose(pts[i], jax_viz._skeleton_points(jrobot, qi), atol=1e-6, rtol=0)
        theirs = np.array(jrobot._capsule_endpoints_np(qi.astype(np.float64)))
        np.testing.assert_allclose(ends[i], theirs, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(demo := viz.demo_target_pose(name), jax_viz.demo_target_pose(name))
    assert demo.shape == (7,)


def test_png_and_gif_demos_write_files(tmp_path):
    solver = _tiny_solver()
    robot = solver.robot
    assert os.path.getsize(viz.visualize_fk(robot, n_configs=2, out_path=str(tmp_path / "fk.png"),
                                            device="cpu")) > 10_000
    for fn, kwargs in ((viz.oscillate_latent, {}), (viz.oscillate_target, {"n_solutions": 2})):
        out = fn(solver, n_frames=3, out_path=str(tmp_path / f"{fn.__name__}.gif"), **kwargs)
        assert os.path.getsize(out) > 10_000
    assert os.path.getsize(viz.oscillate_joints(robot, n_frames=3, out_path=str(tmp_path / "j.gif"),
                                                device="cpu")) > 10_000


def test_png_demos_without_matplotlib_raise(monkeypatch, tmp_path):
    """Where matplotlib is missing (the card's machine has none), a PNG/GIF
    demo raises and points to --interactive; it never writes the HTML."""
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    solver = _tiny_solver()
    calls = [lambda p: viz.visualize_fk(solver.robot, out_path=p, device="cpu"),
             lambda p: viz.oscillate_latent(solver, n_frames=2, out_path=p),
             lambda p: viz.oscillate_target(solver, n_frames=2, out_path=p),
             lambda p: viz.oscillate_joints(solver.robot, n_frames=2, out_path=p, device="cpu")]
    for i, call in enumerate(calls):
        path = str(tmp_path / f"demo{i}")
        with pytest.raises(ImportError, match="matplotlib.*--interactive"):
            call(path)
        assert os.listdir(tmp_path) == []


def _payload(path):
    with open(path) as f:
        html = f.read()
    return json.loads(re.search(r"const DATA = (\{.*?\});\n", html).group(1)), html


def _frames_close(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) and a.get("label") == b.get("label")
        assert len(a["sols"]) == len(b["sols"])
        for sa, sb in zip(a["sols"], b["sols"]):
            for (p0, p1, r), (q0, q1, s) in zip(sa, sb):
                assert r == s
                np.testing.assert_allclose(np.array([p0, p1]), np.array([q0, q1]), atol=1e-4 + 1e-6, rtol=0)


def test_interactive_joint_sweep_payload_matches_jax(tmp_path):
    robot, jrobot = get_robot("panda"), jax_get_robot("panda")
    ours, html = _payload(ivz.interactive_oscillate_joints(robot, n_frames=8, out_path=str(tmp_path / "a.html"),
                                                           device="cpu"))
    theirs, jhtml = _payload(jax_ivz.interactive_oscillate_joints(jrobot, n_frames=8,
                                                                  out_path=str(tmp_path / "b.html")))
    assert {k: v for k, v in ours.items() if k != "frames"} == {k: v for k, v in theirs.items() if k != "frames"}
    _frames_close(ours["frames"], theirs["frames"])
    assert html.replace(json.dumps(ours), "") == jhtml.replace(json.dumps(theirs), "")  # the same page around it


def test_interactive_demos_frames_and_keys(tmp_path):
    """Every demo: the frame count asked for, each frame's keys as JAX's,
    and the fixed-latent sweep's frames each holding n_solutions skeletons;
    the latent sweep's payload equals JAX's on the same weights."""
    from test_torch_solver import _solver_pair

    js, ts = _solver_pair()
    robot = ts.robot
    runs = {
        "fk": (ivz.interactive_fk(robot, n_configs=3, out_path=str(tmp_path / "fk.html"), device="cpu"),
               jax_ivz.interactive_fk(js.robot, n_configs=3, out_path=str(tmp_path / "jfk.html")), 3),
        "latent": (ivz.interactive_oscillate_latent(ts, n_frames=5, out_path=str(tmp_path / "l.html"),
                                                    allow_uninitialized=True),
                   jax_ivz.interactive_oscillate_latent(js, n_frames=5, out_path=str(tmp_path / "jl.html"),
                                                        allow_uninitialized=True), 5),
        "target": (ivz.interactive_oscillate_target(ts, n_frames=4, n_solutions=3, out_path=str(tmp_path / "t.html"),
                                                    allow_uninitialized=True),
                   jax_ivz.interactive_oscillate_target(js, n_frames=4, n_solutions=3,
                                                        out_path=str(tmp_path / "jt.html"),
                                                        allow_uninitialized=True), 4),
    }
    for name, (ours_path, theirs_path, n_frames) in runs.items():
        ours, theirs = _payload(ours_path)[0], _payload(theirs_path)[0]
        assert len(ours["frames"]) == len(theirs["frames"]) == n_frames, name
        for a, b in zip(ours["frames"], theirs["frames"]):
            assert sorted(a) == sorted(b) and a["label"] == b["label"] and len(a["sols"]) == len(b["sols"])
            assert a.get("target") == b.get("target") or np.allclose(a["target"], b["target"], atol=1e-6)
    assert all(len(f["sols"]) == 3 for f in _payload(runs["target"][0])[0]["frames"])
    # The latent sweep draws nothing: the same weights give the same frames
    # (up to the flows' fp32 gap and the 0.1-mm rounding).
    _frames_close(_payload(runs["latent"][0])[0]["frames"], _payload(runs["latent"][1])[0]["frames"])
