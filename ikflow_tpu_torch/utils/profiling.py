"""Profiling helpers: timing sections, differenced per-iteration timing, and
torch.profiler traces. Port of ``ikflow_tpu/utils/profiling.py``.

CUDA work is asynchronous: a ``timing_section`` around kernels that were
only launched measures the launches. Pass ``sync=True`` to wait for the card
before the clock is read.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

from ikflow_tpu_torch.config import resolve_device


class SectionTimes:
    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"  {name}: {total * 1000:.2f} ms total / {n} calls = {total / n * 1000:.3f} ms/call")
        return "\n".join(lines)


GLOBAL_TIMES = SectionTimes()


def synchronize(device=None) -> None:
    """Wait for every kernel queued on ``device`` (default: the current CUDA
    device where there is one; a CUDA device without a card raises). CPU
    work is synchronous: nothing to wait for."""
    device = resolve_device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timing_section(name: str, times: Optional[SectionTimes] = None, sync: bool = False) -> Iterator[None]:
    """``with timing_section("lm"):`` adds the block's wall time to
    ``times`` (default GLOBAL_TIMES); with ``sync`` it first waits for the
    work queued on the current CUDA device, where there is one."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            synchronize()
        (times or GLOBAL_TIMES).add(name, time.perf_counter() - t0)


class DegenerateTimingError(RuntimeError):
    """The differenced delta cannot be told apart from timer noise: the
    measurement is refused, not reported."""


def _timed_median(fn, reps: int, time_fn=time.perf_counter):
    """Median and spread of ``reps`` timed calls of ``fn(i)``."""
    ts = []
    for i in range(reps):
        t0 = time_fn()
        fn(i)
        ts.append(time_fn() - t0)
    ts.sort()
    return ts[len(ts) // 2], ts[-1] - ts[0]


def measure_per_iter_s(build, label: str, k_deltas=(5, 20), reps_schedule=(3, 5, 9),
                       floor_s: float = 2e-5, time_fn=time.perf_counter) -> float:
    """Seconds per chained iteration by differencing, or raise.

    ``build(iters)`` returns ``fn(i)``, which runs ``iters`` iterations that
    each depend on the one before and waits for the result. The time per
    iteration is ``(t(2 + K) - t(2)) / K``: what both runs pay once (launch
    set-up, the final synchronisation) cancels. It is accepted only when the
    delta exceeds both ``floor_s`` and 3x the spread between repetitions;
    otherwise the repetitions are raised, then K is widened, and at the end
    the measurement is refused (:class:`DegenerateTimingError`).
    """
    for k_delta in k_deltas:
        k_small, k_large = 2, 2 + k_delta
        run_small, run_large = build(k_small), build(k_large)
        run_small(0)  # warm-up
        run_large(0)
        for reps in reps_schedule:
            t_small, spread_small = _timed_median(run_small, reps, time_fn)
            t_large, spread_large = _timed_median(run_large, reps, time_fn)
            delta = t_large - t_small
            noise = max(spread_small, spread_large)
            if delta > max(3.0 * noise, floor_s):
                return delta / k_delta
    raise DegenerateTimingError(
        f"{label}: t_large - t_small <= max(3x noise, {floor_s}s) at every "
        f"rep/delta escalation; refusing to report a noise-dominated rate"
    )


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the block (CPU, and CUDA where there is a card);
    the Chrome trace is written to ``log_dir/trace.json`` at the end."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
