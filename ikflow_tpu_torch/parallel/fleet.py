"""Exact IK sharded over a mesh of devices, and streamed over large pose sets.

Port of ``ikflow_tpu/parallel/fleet.py``.

``solve_exact_sharded`` pads the poses to a multiple of the mesh size, runs
the solver's retry tiers with each tier's rows split over the mesh entries
(one solver replica per device, the kernels' packed weights built once per
device and weights version), gathers on the first entry and trims. Each
tier's latents and LM restart draws are made over the whole tier on one
generator, and each shard takes its rows of them, so a solve on N entries
equals the solve on one (JAX gets this from drawing over the global array).
Every shard's tier is dispatched before the host's one check of the tier
skip. One host thread launches for every device, so the shards of a tier run
one after another on the host's side (on a card, once captured, each
shard's tier is one replay of its replica's graph, which takes the shard's
rows of the draws as its inputs).

``solve_exact_megabatch`` streams fixed-shape chunks, with each
retry-capacity policy:

- ``"compact"`` (the default): tier 1 runs once over every pose in steady
  chunks; each retry tier solves only the poses still invalid after the
  tiers before it, compacted on the host, in fixed-shape chunks.
- ``"probe"``: one uncapped ``chunk_size`` chunk measures the tier counts;
  ``derive_retry_capacities`` turns them into capped retry tiers for the
  steady chunks, which run every tier inside the chunk. The capacities are
  cached on the solver, keyed by its weights version and the solve protocol,
  so a later call skips the probe. A capped chunk whose valid share falls
  more than 0.005 under the probe's drops the cache entry and is re-solved
  uncapped in probe-sized pieces with fresh generators.
- an explicit capacity tuple: every chunk capped with it (no probe, no
  monitoring); ``None``: every chunk uncapped, in ``chunk_size`` pieces.

The merge is first-valid-wins, so a re-solved pose is never downgraded.

- The poses are uploaded once (``_PoseStore``). A chunk is a slice of that
  tensor, or an ``index_select`` gather for retries and for sets smaller than
  a chunk (padded by repeating the first index). A ragged tail window shifts
  left onto real poses instead of padding; the overlap is merged
  first-valid-wins.
- A chunk is one single-tier solve (one repeat count, no host
  synchronisation inside; on a card, once captured, one replay of the
  solver's tier graph for the chunk's shape). Its generator is derived from
  (seed, tier salt, chunk start), the counterpart of ``fold_in``.
- A chunk's (solutions, valids) leave the card as one packed tensor, copied
  into pinned host memory with ``non_blocking=True``; collection waits until
  every chunk of the tier is dispatched, so the card runs ahead of the host.

With a ``mesh`` of one entry the chunks run on that entry's device as
above; a larger mesh solves each chunk through ``solve_exact_sharded``. The
probe's capacities are keyed as in the JAX package, by weights and solve
protocol and not by mesh, so capacities measured on one mesh serve another.

``scaling_efficiency`` times ``solve_exact_sharded`` on the first d devices
of a list. Repeated entries of one card share its SMs: there it shows the
mechanics, not cross-card scaling.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ikflow_tpu_torch.graphs import WARMUP_CALLS
from ikflow_tpu_torch.parallel.mesh import Mesh, make_mesh, pad_to_multiple, split_bounds
from ikflow_tpu_torch.solver import derive_retry_capacities

# Chunk generator salts past the retry tiers' (which use the tier index).
_SALT_PROBE, _SALT_STEADY, _SALT_RESOLVE = 1000, 1001, 1002


def _sharded_tier(solver, mesh: Mesh):
    """A ``solve_tier`` for ``IKFlowSolver._exact_tiers`` that splits each
    tier's poses over the mesh. The draws are made over the whole tier, in
    the unsharded tier's order (latents, then one restart draw per LM step);
    a shard's rows of the tile-major (r * n) layout are ``t * n + i`` for
    its poses i and every tile t."""
    replicas = [solver.replica(dev) for dev in mesh.devices]
    out_dev = mesh.devices[0]

    def solve_tier(poses, g, r, pos_tol, rot_tol, n_steps, lambd, latent_scale):
        n = poses.shape[0]
        latent = torch.randn((r * n, solver.network_width), generator=g, device=g.device)
        noise = torch.stack([torch.rand((r * n, solver.ndof), generator=g, device=g.device)
                             for _ in range(n_steps)]) if n_steps else None
        bounds = split_bounds(n, mesh.size)
        tiles = torch.arange(r, device=g.device)[:, None] * n
        parts = []
        for k, rep in enumerate(replicas):
            a, b = bounds[k], bounds[k + 1]
            if a == b:
                continue
            rows = (tiles + torch.arange(a, b, device=g.device)[None, :]).reshape(-1)
            dev = rep.device
            parts.append(rep._solve_tier(poses[a:b].to(dev), None, r, pos_tol, rot_tol, n_steps, lambd, latent_scale,
                                         latent=latent[rows].to(dev),
                                         restart_noise=None if noise is None else noise[:, rows].to(dev)))
        return (torch.cat([s.to(out_dev) for s, _ in parts]), torch.cat([v.to(out_dev) for _, v in parts]))

    return solve_tier


def solve_exact_sharded(
    solver,
    target_poses,
    mesh: Optional[Mesh] = None,
    repeat_counts: Tuple[int, ...] = (1, 3, 10),
    pos_error_threshold: float = 1e-3,
    rot_error_threshold: float = 0.1,
    n_opt_steps_max: int = 3,
    lambd: float = 1e-4,
    latent_scale: float = 0.75,
    generator: Optional[torch.Generator] = None,
    allow_uninitialized: bool = False,
    retry_capacities: Optional[Tuple[float, ...]] = None,
    return_tier_counts: bool = False,
):
    """``solver.generate_exact_ik_solutions`` with the poses sharded over
    ``mesh`` (default: every CUDA device).

    Pads the pose count up to a multiple of the mesh size with copies of
    pose 0, whose results are dropped. Returns (solutions, valids) of the
    original length on the mesh's first device, plus the cumulative per-tier
    valid counts over the padded set with ``return_tier_counts``. The draws
    come from ``generator`` (default: the solver's own), as in the unsharded
    solve, which gives the same solutions."""
    mesh = make_mesh() if mesh is None else mesh
    solver._check_loaded(allow_uninitialized)
    poses = torch.as_tensor(target_poses, dtype=torch.float32, device=mesh.devices[0])
    if poses.ndim != 2 or poses.shape[1] != 7:
        raise ValueError(f"target_poses must be (n, 7), got {tuple(poses.shape)}")
    n = poses.shape[0]
    n_pad = pad_to_multiple(n, mesh.size)
    if n_pad != n:
        poses = torch.cat([poses, poses[:1].expand(n_pad - n, 7)])
    out = solver._exact_tiers(
        poses, generator or solver._generator, _sharded_tier(solver, mesh), repeat_counts,
        (pos_error_threshold, rot_error_threshold, n_opt_steps_max, lambd, latent_scale), retry_capacities,
        return_tier_counts,
    )
    return (out[0][:n], out[1][:n]) + tuple(out[2:])


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


def _solve_chunk(solver, poses: torch.Tensor, r: int, seed: int, salt: int, start: int, solve_args,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One single-tier exact solve of a chunk -> packed (size, ndof + 1) on the
    device (the mesh's first). ``solve_args``: (pos tol, rot tol, LM steps,
    lambd, latent scale)."""
    g = _chunk_generator(poses.device, seed, salt, start)
    if mesh is None:
        sols, valids = solver._solve_tier(poses, g, r, *solve_args)
    else:
        sols, valids = solve_exact_sharded(solver, poses, mesh, repeat_counts=(r,), generator=g,
                                           allow_uninitialized=True, **_tol_kwargs(solve_args))
    return _pack(sols, valids)


def _tol_kwargs(tol) -> Dict:
    return dict(zip(("pos_error_threshold", "rot_error_threshold", "n_opt_steps_max", "lambd", "latent_scale"), tol))


def _to_host(packed: torch.Tensor):
    """Start the copy of a packed chunk to the host. -> (host tensor, event
    that completes with the copy, or None on the CPU)."""
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)  # queued on the current stream of packed's device
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(packed.device))
    return host, event


def solve_exact_megabatch(
    solver,
    target_poses,
    chunk_size: int = 2048,
    mesh=None,
    seed: int = 0,
    progress: bool = False,
    retry_capacities="compact",
    steady_chunk: int = 32768,
    steady_chunk_max: int = 131072,
    capacity_cache: bool = True,
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
    and with ``return_stats`` also a list of dicts. Under ``"compact"``, one
    per tier run: ``repeat``, ``rows`` (poses solved), ``chunks``
    (dispatched), ``chunk_rows`` (each chunk's pose count, in dispatch order;
    a chunk's flow runs on ``repeat`` times as many rows) and ``valid``
    (cumulative valid count after the tier). Under the other policies, one
    per chunk solved, in order: ``kind`` ("probe", "steady" or "resolve"),
    ``rows`` (the chunk's pose count), ``capacities`` (None: uncapped),
    ``tier_counts`` (the chunk's cumulative valid count after each tier; a
    tier runs on the card unless every pose was valid before it) and
    ``valid_fraction`` (over the chunk's real poses).

    Steady chunks are ``min(steady_chunk, steady_chunk_max)`` (32768), a
    quarter of that and ``chunk_size`` (2048) poses; uncapped chunks are
    ``chunk_size``. ``progress`` prints a line per collected chunk (or tier).
    ``capacity_cache=False`` forces a fresh probe and leaves the cache alone.
    ``mesh``: the solver's device when None; a one-entry mesh runs on its
    device, a larger one shards every chunk over its entries.
    """
    if mesh is not None and mesh.size == 1:
        solver, mesh = solver.replica(mesh.devices[0]), None
    policy = retry_capacities
    if not (policy in ("compact", "probe") or policy is None or isinstance(policy, tuple)):
        raise ValueError(f"retry_capacities must be 'compact', 'probe', a tuple or None, got {policy!r}")
    solver._check_loaded(allow_uninitialized)
    device = solver.device if mesh is None else mesh.devices[0]
    poses = torch.as_tensor(target_poses, dtype=torch.float32, device=device)
    if poses.ndim != 2 or poses.shape[1] != 7:
        raise ValueError(f"target_poses must be (n, 7), got {tuple(poses.shape)}")
    repeat_counts = tuple(int(r) for r in repeat_counts)
    store = _PoseStore(poses.contiguous())
    steady = min(steady_chunk, steady_chunk_max)
    tol = (pos_error_threshold, rot_error_threshold, n_opt_steps_max, lambd, latent_scale)
    if policy == "compact":
        out = _megabatch_compact(solver, store, chunk_size, steady, seed, progress, repeat_counts, tol, mesh)
    else:
        out = _megabatch_capped(solver, store, chunk_size, steady, seed, progress, policy, capacity_cache,
                                repeat_counts, tol, mesh)
    return out if return_stats else out[:2]


def _megabatch_compact(solver, store, chunk_size, steady, seed, progress, repeat_counts, tol, mesh):
    """Tier 1 over every pose, then each retry tier over the compacted misses."""
    n = store.n
    mid = max(chunk_size, steady // 4)
    pass1_sizes = (steady, mid, chunk_size)
    retry_sizes = (mid, chunk_size)
    sols_out = np.zeros((n, solver.ndof), dtype=np.float32)
    valid_out = np.zeros((n,), dtype=bool)
    stats: List[Dict] = []

    def dispatch(r: int, salt: int, idx: Optional[np.ndarray] = None):
        """Queue every chunk of one tier; -> [(size, rows, host tensor, event)]."""
        total = n if idx is None else idx.shape[0]
        pending = []
        for pos, size in _plan(total, pass1_sizes if idx is None else retry_sizes):
            chunk, rows = store.slice(pos, size) if idx is None else store.gather(idx[pos : pos + size], size)
            packed = _solve_chunk(solver, chunk, r, seed, salt, pos, tol, mesh=mesh)
            pending.append((size, rows, *_to_host(packed)))
        return pending

    def collect(pending, label: str) -> int:
        got = 0
        for _, rows, host, event in pending:
            if event is not None:
                event.synchronize()
            s, v = _unpack(host.numpy(), rows.shape[0])
            fresh = ~valid_out[rows]
            sols_out[rows[fresh]] = s[fresh]
            got += int((fresh & v).sum())
            valid_out[rows] |= v
            if progress:
                print(f"  megabatch: {label}: +{rows.shape[0]} rows collected", flush=True)
        return got

    for tier_idx, r in enumerate(repeat_counts):
        idx = None if tier_idx == 0 else np.flatnonzero(~valid_out)
        if idx is not None and idx.size == 0:
            break
        pending = dispatch(r, tier_idx, idx)
        got = collect(pending, f"tier {tier_idx + 1}" + ("" if idx is None else f" (x{r})"))
        if progress and idx is not None:
            print(f"  megabatch: tier {tier_idx + 1}: retried {idx.size}, converged {got}", flush=True)
        stats.append({"repeat": r, "rows": n if idx is None else int(idx.size), "chunks": len(pending),
                      "chunk_rows": [p[0] for p in pending], "valid": int(valid_out.sum())})
    return sols_out, valid_out, stats


def _exact_chunk(solver, chunk, g, repeat_counts, capacities, tol, mesh=None):
    """Every tier of one chunk in the solver's exact solve, sharded over
    ``mesh`` when given. -> (packed (size, ndof + 1), cumulative valid count
    after each tier), on the device."""
    kwargs = dict(repeat_counts=repeat_counts, generator=g, allow_uninitialized=True, retry_capacities=capacities,
                  return_tier_counts=True, **_tol_kwargs(tol))
    if mesh is None:
        sols, valids, tier_counts = solver.generate_exact_ik_solutions(chunk, **kwargs)
    else:
        sols, valids, tier_counts = solve_exact_sharded(solver, chunk, mesh, **kwargs)
    return _pack(sols, valids), tier_counts


def _megabatch_capped(solver, store, chunk_size, steady, seed, progress, policy, capacity_cache, repeat_counts, tol,
                      mesh):
    """The "probe", tuple and None policies: every tier runs inside each chunk."""
    n, device = store.n, store.dev.device
    sols_out = np.zeros((n, solver.ndof), dtype=np.float32)
    valid_out = np.zeros((n,), dtype=bool)
    stats: List[Dict] = []
    probing = policy == "probe"
    capacities = None if probing else policy
    probe_valid_fraction = None
    cache_key = (solver.weights_version, repeat_counts, tuple(float(t) for t in tol))

    def merge(rows, s, v) -> None:
        fresh = ~valid_out[rows]
        sols_out[rows[fresh]] = s[fresh]
        valid_out[rows] |= v

    consumed = 0
    if probing and capacity_cache and cache_key in solver.capacity_cache:
        capacities, probe_valid_fraction = solver.capacity_cache[cache_key]
        if progress:
            print("  megabatch: reusing cached probe capacities "
                  f"{capacities and [round(c, 4) for c in capacities]}", flush=True)
    elif probing and n > 0:
        # The probe blocks: its capacities decide every chunk after it.
        chunk, rows = store.slice(0, min(chunk_size, n))
        g = _chunk_generator(device, seed, _SALT_PROBE, 0)
        packed, tier_counts = _exact_chunk(solver, chunk, g, repeat_counts, None, tol, mesh=mesh)
        tier_counts = [int(c) for c in tier_counts.tolist()]
        s, v = _unpack(packed.cpu().numpy(), rows.shape[0])
        capacities = derive_retry_capacities(tier_counts, chunk.shape[0], len(tier_counts))
        probe_valid_fraction = float(v.mean())
        merge(rows, s, v)
        consumed = int(rows[-1]) + 1
        stats.append({"kind": "probe", "rows": chunk.shape[0], "capacities": None, "tier_counts": tier_counts,
                      "valid_fraction": probe_valid_fraction})
        if capacity_cache:
            solver.capacity_cache[cache_key] = (capacities, probe_valid_fraction)
        if progress and capacities is not None:
            print(f"  megabatch: probe capacities {[round(c, 4) for c in capacities]}", flush=True)

    if capacities is None:
        steady = chunk_size  # an uncapped chunk runs every pose through every tier
    mid = max(chunk_size, steady // 4)
    sizes = (steady, mid, chunk_size) if capacities is not None else (chunk_size,)
    pending = []
    for pos, size in _plan(n - consumed, sizes):
        chunk, rows = store.slice(consumed + pos, size)
        g = _chunk_generator(device, seed, _SALT_STEADY, consumed + pos)
        packed, tier_counts = _exact_chunk(solver, chunk, g, repeat_counts, capacities, tol, mesh=mesh)
        pending.append((rows, size, tier_counts, *_to_host(packed)))

    degraded = []
    for rows, size, tier_counts, host, event in pending:
        if event is not None:
            event.synchronize()
        s, v = _unpack(host.numpy(), rows.shape[0])
        merge(rows, s, v)
        vf = float(v.mean())
        stats.append({"kind": "steady", "rows": size, "capacities": None if capacities is None else list(capacities),
                      "tier_counts": [int(c) for c in tier_counts.tolist()], "valid_fraction": vf})
        if probing and capacities is not None and vf < probe_valid_fraction - 0.005:
            degraded.append((int(rows[0]), rows.shape[0]))
        if progress:
            done = int(rows[-1]) + 1
            print(f"  megabatch: {done}/{n} poses ({100 * done / n:.0f}%)", flush=True)
    if degraded:
        # The capacities fell short for this stream: never serve them again.
        solver.capacity_cache.pop(cache_key, None)

    # A capped chunk that solved measurably fewer poses than the probe is
    # re-solved uncapped, in probe-sized pieces, with fresh generators.
    for start, m in degraded:
        for sub in range(start, start + m, chunk_size):
            idx = np.arange(sub, min(sub + chunk_size, start + m))
            chunk, rows = store.gather(idx, chunk_size)
            g = _chunk_generator(device, seed, _SALT_RESOLVE, sub)
            packed, tier_counts = _exact_chunk(solver, chunk, g, repeat_counts, None, tol, mesh=mesh)
            s, v = _unpack(packed.cpu().numpy(), rows.shape[0])
            merge(rows, s, v)
            stats.append({"kind": "resolve", "rows": chunk_size, "capacities": None,
                          "tier_counts": [int(c) for c in tier_counts.tolist()], "valid_fraction": float(v.mean())})
        if progress:
            print(f"  megabatch: re-solved degraded chunk at {start} uncapped", flush=True)
    return sols_out, valid_out, stats


def _timed_solve_s(fn, mesh: Mesh) -> float:
    """Seconds of one ``fn()``: between CUDA events on the first entry, every
    card of the mesh drained before and after, on a CUDA mesh; by the host
    clock on the CPU."""
    cards = sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)
    if not cards:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    for d in cards:
        torch.cuda.synchronize(d)
    with torch.cuda.device(mesh.devices[0]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
    for d in cards:
        torch.cuda.synchronize(d)
    return start.elapsed_time(end) / 1e3


def scaling_efficiency(
    solver,
    n_poses: int = 1024,
    device_counts=(1, None),
    reps: int = 3,
    generator: Optional[torch.Generator] = None,
    devices: Optional[Sequence] = None,
    **solve_kwargs,
):
    """Exact-IK throughput of ``solve_exact_sharded`` on the first d of
    ``devices`` (default: every CUDA device) for each d of
    ``device_counts`` (None: all of them) -> [{devices, seconds, sols_per_s,
    efficiency}], efficiency = T_d / (d * T_1) against the first count.

    Each count gets ``graphs.WARMUP_CALLS`` warm-up solves, then ``reps``
    timed solves (median).
    Where ``devices`` repeats a card, its replicas share that card, and the
    rows show the mechanics, not scaling; the same holds on the CPU."""
    devices = list(make_mesh(devices).devices)
    g = generator or torch.Generator(device=devices[0]).manual_seed(0)
    robot = solver.robot
    poses = robot.forward_kinematics(robot.sample_joint_angles(n_poses, g, joint_limit_eps=0.02))
    rows = []
    base_throughput = None
    for dc in device_counts:
        dc = len(devices) if dc is None else dc
        mesh = make_mesh(devices[:dc])
        for _ in range(WARMUP_CALLS):  # on a card the shards' eager and capturing calls
            solve_exact_sharded(solver, poses, mesh=mesh, generator=g, **solve_kwargs)
        ts = sorted(_timed_solve_s(lambda: solve_exact_sharded(solver, poses, mesh=mesh, generator=g,
                                                               **solve_kwargs), mesh) for _ in range(reps))
        sec = ts[len(ts) // 2]
        thr = n_poses / sec
        if base_throughput is None:
            base_throughput = thr / dc  # per device at the first count
        rows.append({"devices": dc, "seconds": sec, "sols_per_s": thr, "efficiency": thr / (dc * base_throughput)})
    return rows
