"""IK datasets: uniform in-limit joint samples and their FK poses, optionally
without self-collisions, built on the device, and stored on disk.

Port of ``ikflow_tpu/training/dataset.py``. A dataset directory is named
``{robot}[__tag0={tag}...]`` under ``config.DATASET_DIR`` and holds
``dataset.npz`` (``samples_tr``, ``endpoints_tr``, ``samples_te``,
``endpoints_te``) and ``info.txt``: the JAX package's layout, so a dataset
saved by either package loads in the other.

- ``build_dataset`` filters self-collisions on the host: each fixed-size
  chunk is drawn and graded on the device and its collision-free rows are
  copied to the host.
- ``build_dataset_resident`` never copies the train split off the device:
  colliding rows are redrawn in place for ``redraw_rounds`` rounds, and a row
  still colliding then borrows its neighbour (the one two rows back when the
  neighbour collides too). The train split stays a tensor on the device, the
  test split goes to numpy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ikflow_tpu_torch import config
from ikflow_tpu_torch.robots.chain import KinematicChain
from ikflow_tpu_torch.training.common import generator

# Joint-limit margin of the samples: 0.25 degrees.
DEFAULT_JOINT_LIMIT_EPS = 0.004363
DEFAULT_TEST_SET_SIZE = 15_000

Array = Union[np.ndarray, torch.Tensor]


@dataclass
class IkDataset:
    samples_tr: Array  # (n_tr, ndof) joint configs: numpy, or a tensor on the device
    endpoints_tr: Array  # (n_tr, 7) poses
    samples_te: np.ndarray
    endpoints_te: np.ndarray
    robot_name: str
    tags: Tuple[str, ...] = ()

    @property
    def n_train(self) -> int:
        return self.samples_tr.shape[0]


def dataset_directory(robot_name: str, tags: Sequence[str] = ()) -> str:
    """``config.DATASET_DIR/{robot}[__tag{i}={tag}...]``, tags sorted."""
    suffix = "".join(f"__tag{i}={t}" for i, t in enumerate(sorted(tags)))
    return os.path.join(config.DATASET_DIR, robot_name + suffix)


def _numpy(a: Array) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _check_split(robot: KinematicChain, q: torch.Tensor, joint_limit_eps: float) -> None:
    """No degenerate joint column, and every row inside the margined limits."""
    stds = q.double().std(dim=0, correction=0)
    if not bool((stds > 0.001).all()):
        raise RuntimeError(f"degenerate joint column: stds={stds.cpu().numpy()}")
    low = robot.limits_low(q.device, q.dtype) + joint_limit_eps
    high = robot.limits_high(q.device, q.dtype) - joint_limit_eps
    if not bool(((q >= low - 1e-5) & (q <= high + 1e-5)).all()):
        raise RuntimeError("a sample lies outside the joint limits")


def _generate_split(
    robot: KinematicChain,
    gen: torch.Generator,
    n: int,
    joint_limit_eps: float,
    only_non_self_colliding: bool,
    chunk_size: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw fixed-size chunks on the device, FK and grade them there, and
    copy the accepted rows to the host until ``n`` are collected."""
    qs, ps = [], []
    remaining = n
    while remaining > 0:
        q = robot.sample_joint_angles(chunk_size, gen, joint_limit_eps)
        pose = robot.forward_kinematics(q)
        q_np, pose_np = q.cpu().numpy(), pose.cpu().numpy()
        if only_non_self_colliding:
            keep = ~robot.config_self_collides(q).cpu().numpy()
            q_np, pose_np = q_np[keep], pose_np[keep]
        take = min(remaining, q_np.shape[0])
        qs.append(q_np[:take])
        ps.append(pose_np[:take])
        remaining -= take
    return np.concatenate(qs, axis=0), np.concatenate(ps, axis=0)


def build_dataset(
    robot: KinematicChain,
    training_set_size: int = 2_500_000,
    test_set_size: int = DEFAULT_TEST_SET_SIZE,
    only_non_self_colliding: bool = True,
    joint_limit_eps: float = DEFAULT_JOINT_LIMIT_EPS,
    seed: int = 0,
    chunk_size: int = 262_144,
    device="cuda",
) -> IkDataset:
    """A dataset whose rows are drawn on ``device`` and filtered on the host;
    both splits are float32 numpy arrays."""
    device = config.resolve_device(device)
    splits = []
    for stream, n in ((0, training_set_size), (1, test_set_size)):
        q, pose = _generate_split(robot, generator(device, seed, stream), int(n), joint_limit_eps,
                                  only_non_self_colliding, chunk_size)
        _check_split(robot, torch.from_numpy(q), joint_limit_eps)
        splits += [q.astype(np.float32), pose.astype(np.float32)]
    tags = (config.DATASET_TAG_NON_SELF_COLLIDING,) if only_non_self_colliding else ()
    return IkDataset(*splits, robot.name, tags)


def build_dataset_resident(
    robot: KinematicChain,
    training_set_size: int = 25_000_000,
    test_set_size: int = DEFAULT_TEST_SET_SIZE,
    only_non_self_colliding: bool = True,
    joint_limit_eps: float = DEFAULT_JOINT_LIMIT_EPS,
    seed: int = 0,
    chunk_size: int = 1 << 17,
    redraw_rounds: int = 6,
    device="cuda",
) -> IkDataset:
    """A dataset whose train split never leaves ``device``.

    Each chunk of ``chunk_size`` rows keeps its shape: for ``redraw_rounds``
    rounds every colliding row is replaced by a fresh draw, so a collision
    rate p leaves p ** (rounds + 1) of the rows colliding; each of those then
    takes the row before it, or the one two before when that one collides
    too. A row leaks only when three adjacent rows still collide, about
    p ** (3 * (rounds + 1)): 2e-15 at Panda's 20%. Poses are the FK of the
    final rows."""
    device = config.resolve_device(device)
    filter_collisions = only_non_self_colliding and robot.n_capsule_pairs > 0

    def one_chunk(gen: torch.Generator, chunk: int):
        q = robot.sample_joint_angles(chunk, gen, joint_limit_eps)
        if filter_collisions:
            bad = robot.config_self_collides(q)
            for _ in range(redraw_rounds):
                fresh = robot.sample_joint_angles(chunk, gen, joint_limit_eps)
                q = torch.where(bad[:, None], fresh, q)
                bad = robot.config_self_collides(q)
            borrow = torch.where(torch.roll(bad, 1)[:, None], torch.roll(q, 2, dims=0), torch.roll(q, 1, dims=0))
            q = torch.where(bad[:, None], borrow, q)
        return q, robot.forward_kinematics(q)

    def split(stream: int, n: int):
        gen = generator(device, seed, stream)
        chunk = min(chunk_size, n)
        parts = [one_chunk(gen, chunk) for _ in range(-(-n // chunk))]
        q = torch.cat([q for q, _ in parts])[:n]
        pose = torch.cat([p for _, p in parts])[:n]
        _check_split(robot, q, joint_limit_eps)
        return q, pose

    samples_tr, endpoints_tr = split(0, int(training_set_size))
    samples_te, endpoints_te = split(1, int(test_set_size))
    tags = (config.DATASET_TAG_NON_SELF_COLLIDING,) if only_non_self_colliding else ()
    return IkDataset(samples_tr, endpoints_tr, samples_te.cpu().numpy(), endpoints_te.cpu().numpy(), robot.name,
                     tags)


def save_dataset(ds: IkDataset, directory: Optional[str] = None) -> str:
    """Write ``dataset.npz`` and ``info.txt`` to ``directory`` (default: the
    dataset's directory under ``config.DATASET_DIR``). Returns the directory."""
    config.ensure_cache_dirs()
    directory = directory or dataset_directory(ds.robot_name, ds.tags)
    os.makedirs(directory, exist_ok=True)
    arrays = {name: _numpy(getattr(ds, name)) for name in ("samples_tr", "endpoints_tr", "samples_te", "endpoints_te")}
    np.savez_compressed(os.path.join(directory, "dataset.npz"), **arrays)
    with open(os.path.join(directory, "info.txt"), "w") as f:
        f.write(f"Dataset info\n  robot: {ds.robot_name}\n  tags: {list(ds.tags)}\n")
        for name, arr in arrays.items():
            f.write(f"  {name}: shape={arr.shape} mean={arr.mean(0).round(4)} std={arr.std(0).round(4)}\n")
    return directory


def load_dataset(robot_name: str, tags: Sequence[str] = (config.DATASET_TAG_NON_SELF_COLLIDING,)) -> IkDataset:
    """The dataset saved for ``robot_name`` and ``tags``, as numpy arrays."""
    path = os.path.join(dataset_directory(robot_name, tags), "dataset.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no dataset at {path}; build one with build_dataset and save_dataset first")
    with np.load(path) as z:
        return IkDataset(z["samples_tr"], z["endpoints_tr"], z["samples_te"], z["endpoints_te"], robot_name,
                         tuple(tags))


def iterate_batches(ds: IkDataset, batch_size: int, seed) -> Iterator[Tuple[Array, Array]]:
    """Endless shuffled batches of the train split: a new host permutation
    per pass, the last partial batch of each pass dropped. ``seed`` is
    anything ``np.random.default_rng`` takes. A split held on the device is
    indexed there."""
    n = ds.n_train
    rng = np.random.default_rng(seed)
    on_device = isinstance(ds.samples_tr, torch.Tensor)
    while True:
        perm = rng.permutation(n)
        if on_device:
            perm = torch.from_numpy(perm).to(ds.samples_tr.device)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i: i + batch_size]
            yield ds.samples_tr[idx], ds.endpoints_tr[idx]
