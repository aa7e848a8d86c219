"""Exact IK over a large pose set on one GPU, streamed in fixed-shape chunks.

Port of ``ikflow_tpu/parallel/fleet.py::solve_exact_megabatch`` with its
default ``"compact"`` policy. Tier 1 runs once over every pose in steady
chunks; each retry tier solves only the poses still invalid after the tiers
before it, compacted on the host, in fixed-shape chunks. The merge is
first-valid-wins, so a re-solved pose is never downgraded.

- The poses are uploaded once (``_PoseStore``). A chunk is a slice of that
  tensor, or an ``index_select`` gather for retries and for sets smaller than
  a chunk (padded by repeating the first index). A ragged tail window shifts
  left onto real poses instead of padding; the overlap is merged
  first-valid-wins.
- A chunk is one single-tier solve (one repeat count, no host
  synchronisation inside). Its generator is derived from
  (seed, tier salt, chunk start), the counterpart of ``fold_in``.
- A chunk's (solutions, valids) leave the card as one packed tensor, copied
  into pinned host memory with ``non_blocking=True``; collection waits until
  every chunk of the tier is dispatched, so the card runs ahead of the host.

The ``"probe"`` policy, explicit capacity tuples, ``None`` (uncapped chunks)
and several GPUs are not ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def _plan(total: int, sizes) -> list:
    """Greedy fixed-shape chunk plan over ``total`` rows: largest sizes
    first, one smallest-size window for any remainder (the store shifts or
    pads it). Returns [(start, size)]."""
    plan, pos = [], 0
    for size in sorted(set(sizes), reverse=True):
        while total - pos >= size:
            plan.append((pos, size))
            pos += size
    if pos < total:
        plan.append((pos, min(sizes)))
    return plan


def _pack(sols: torch.Tensor, valids: torch.Tensor) -> torch.Tensor:
    """(m, ndof) solutions and (m,) valids as one (m, ndof + 1) tensor."""
    return torch.cat([sols, valids[:, None].to(sols.dtype)], dim=1)


def _unpack(packed: np.ndarray, m: int):
    arr = packed[:m]
    return arr[:, :-1], arr[:, -1] > 0.5


def _chunk_generator(device: torch.device, seed: int, salt: int, start: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, salt, start]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(state[0]) << 32) | int(state[1]))


class _PoseStore:
    """The pose set on the device, uploaded once; chunks are views or gathers."""

    def __init__(self, poses: torch.Tensor):
        self.dev = poses
        self.n = poses.shape[0]

    def slice(self, start: int, size: int) -> Tuple[torch.Tensor, np.ndarray]:
        """-> (chunk (size, 7), the rows it holds). A window past the end
        shifts left to ``[n - size, n)``; a set smaller than ``size`` is
        gathered and padded."""
        if self.n < size:
            return self.gather(np.arange(self.n), size)
        start = min(start, self.n - size)
        return self.dev[start : start + size], np.arange(start, start + size)

    def gather(self, idx: np.ndarray, size: int) -> Tuple[torch.Tensor, np.ndarray]:
        """-> (chunk (size, 7), idx): the poses at ``idx`` (len <= size), padded
        at the end by repeating ``idx[0]``."""
        pad = size - idx.shape[0]
        idxp = np.concatenate([idx, np.full(pad, idx[0], idx.dtype)]) if pad else idx
        return self.dev.index_select(0, torch.as_tensor(idxp, device=self.dev.device)), idx


def _solve_chunk(solver, poses: torch.Tensor, r: int, seed: int, salt: int, start: int, solve_args) -> torch.Tensor:
    """One single-tier exact solve of a chunk -> packed (size, ndof + 1) on the
    device. ``solve_args``: (pos tol, rot tol, LM steps, lambd, latent scale)."""
    g = _chunk_generator(poses.device, seed, salt, start)
    sols, valids = solver._solve_tier(poses, g, r, *solve_args)
    return _pack(sols, valids)


def solve_exact_megabatch(
    solver,
    target_poses,
    chunk_size: int = 2048,
    mesh=None,
    seed: int = 0,
    retry_capacities="compact",
    steady_chunk: int = 32768,
    repeat_counts: Tuple[int, ...] = (1, 3, 10),
    return_stats: bool = False,
    pos_error_threshold: float = 1e-3,
    rot_error_threshold: float = 0.1,
    n_opt_steps_max: int = 3,
    lambd: float = 1e-4,
    latent_scale: float = 0.75,
    allow_uninitialized: bool = False,
):
    """Exact IK for an arbitrarily large (n, 7) pose set on the solver's device.

    Returns host numpy arrays (solutions (n, ndof) float32, valids (n,) bool),
    and with ``return_stats`` also a list with one dict per tier run:
    ``repeat``, ``rows`` (poses solved), ``chunks`` (dispatched),
    ``chunk_rows`` (each chunk's pose count, in dispatch order; a chunk's flow
    runs on ``repeat`` times as many rows) and ``valid`` (cumulative valid
    count after the tier).

    Tier 1 runs in chunks of ``steady_chunk`` (32768), a quarter of that
    (8192) and ``chunk_size`` (2048); retry tiers in the last two.
    """
    if retry_capacities != "compact":
        raise NotImplementedError(f"retry_capacities={retry_capacities!r}: only 'compact' is ported")
    if mesh is not None:
        raise NotImplementedError("solve_exact_megabatch runs on the solver's one device; meshes are not ported")
    solver._check_loaded(allow_uninitialized)
    solve_args = (pos_error_threshold, rot_error_threshold, n_opt_steps_max, lambd, latent_scale)
    device = solver.device
    poses = torch.as_tensor(target_poses, dtype=torch.float32, device=device)
    if poses.ndim != 2 or poses.shape[1] != 7:
        raise ValueError(f"target_poses must be (n, 7), got {tuple(poses.shape)}")
    n = poses.shape[0]
    store = _PoseStore(poses.contiguous())
    mid = max(chunk_size, steady_chunk // 4)
    pass1_sizes = (steady_chunk, mid, chunk_size)
    retry_sizes = (mid, chunk_size)
    pinned = device.type == "cuda"

    sols_out = np.zeros((n, solver.ndof), dtype=np.float32)
    valid_out = np.zeros((n,), dtype=bool)
    stats: List[Dict] = []

    def dispatch(r: int, salt: int, idx: Optional[np.ndarray] = None):
        """Queue every chunk of one tier; -> [(rows, host tensor, event)]."""
        total = n if idx is None else idx.shape[0]
        pending = []
        for pos, size in _plan(total, pass1_sizes if idx is None else retry_sizes):
            chunk, rows = store.slice(pos, size) if idx is None else store.gather(idx[pos : pos + size], size)
            packed = _solve_chunk(solver, chunk, r, seed, salt, pos, solve_args)
            event = None
            if pinned:
                host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
                host.copy_(packed, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host = packed
            pending.append((size, rows, host, event))
        return pending

    def collect(pending) -> None:
        for _, rows, host, event in pending:
            if event is not None:
                event.synchronize()
            s, v = _unpack(host.numpy(), rows.shape[0])
            fresh = ~valid_out[rows]
            sols_out[rows[fresh]] = s[fresh]
            valid_out[rows] |= v

    for tier_idx, r in enumerate(repeat_counts):
        idx = None if tier_idx == 0 else np.flatnonzero(~valid_out)
        if idx is not None and idx.size == 0:
            break
        pending = dispatch(int(r), tier_idx, idx)
        collect(pending)
        stats.append({"repeat": int(r), "rows": n if idx is None else int(idx.size), "chunks": len(pending),
                      "chunk_rows": [p[0] for p in pending], "valid": int(valid_out.sum())})
    if return_stats:
        return sols_out, valid_out, stats
    return sols_out, valid_out
