"""The port's MMD, misc and profiling utilities and chained timing builds
against the JAX package's. MMD inputs from numpy seeds, compared within 1e-5
relative; the differenced timing runs on a virtual clock, so both packages
see the same times."""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu.math.stats import mmd_multiscale as jax_mmd
from ikflow_tpu.math.stats import mmd_multiscale_ca as jax_mmd_ca
from ikflow_tpu.utils import misc as jax_misc
from ikflow_tpu.utils import profiling as jax_profiling
from ikflow_tpu_torch.math.stats import mmd_multiscale, mmd_multiscale_ca
from ikflow_tpu_torch.utils import benchtools, misc, profiling
from ikflow_tpu_torch.utils.profiling import DegenerateTimingError, SectionTimes, measure_per_iter_s, timing_section
from test_torch_fleet import _tiny_solver
from test_torch_solver import _reachable

RTOL = 1e-5


def _samples(seed, n=48, d=5, loc=0.0):
    return np.random.default_rng(seed).normal(loc=loc, size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("bandwidths", [(0.2, 0.5, 0.9, 1.3), (0.05,), (1.0, 4.0, 16.0)])
@pytest.mark.parametrize("loc", [0.0, 0.7])
def test_mmd_multiscale_matches_jax(bandwidths, loc):
    x, y = _samples(0), _samples(1, loc=loc)
    got = float(mmd_multiscale(torch.from_numpy(x), torch.from_numpy(y), bandwidths))
    want = float(jax_mmd(jnp.asarray(x), jnp.asarray(y), bandwidths))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    assert abs(float(mmd_multiscale(torch.from_numpy(x), torch.from_numpy(x), bandwidths))) < 1e-5


@pytest.mark.parametrize("c_list,a_list", [([1.1827009364464547] * 3, [0.2, 1.0, 2.0]),
                                           ([0.1, 0.2, 0.5], [0.5, 1.0, 2.0]), ([0.3], [1.5])])
@pytest.mark.parametrize("reduce", [True, False])
def test_mmd_multiscale_ca_matches_jax(c_list, a_list, reduce):
    x, y = _samples(2, n=24, d=3), _samples(3, n=24, d=3, loc=0.3)
    got = mmd_multiscale_ca(torch.from_numpy(x), torch.from_numpy(y), c_list, a_list, reduce=reduce).numpy()
    want = np.asarray(jax_mmd_ca(jnp.asarray(x), jnp.asarray(y), c_list, a_list, reduce=reduce))
    assert got.shape == want.shape == (() if reduce else (24, 24))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * np.abs(want).max())


def test_mmd_refuses_mismatched_inputs():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        mmd_multiscale_ca(x, torch.zeros((5, 3)), [0.1], [1.0])
    with pytest.raises(ValueError):
        mmd_multiscale_ca(x, x, [0.1, 0.2], [1.0])
    with pytest.raises(ValueError):
        mmd_multiscale(x, torch.zeros((4, 2)))


@pytest.mark.parametrize("s", [True, False, "True", "true", "1", "False", "false", "0", "yes", "maybe"])
def test_boolean_string_matches_jax(s):
    try:
        want = jax_misc.boolean_string(s)
    except ValueError:
        with pytest.raises(ValueError):
            misc.boolean_string(s)
        return
    assert misc.boolean_string(s) is want


def test_tensor_stats_matches_jax():
    a = np.array([[1.0, np.nan], [3.0, 5.0]], dtype=np.float32)
    for arr in (a, torch.from_numpy(a)):
        got, want = misc.tensor_stats(arr, name="t"), jax_misc.tensor_stats(a, name="t")
        assert got.keys() == want.keys() and got["shape"] == want["shape"] and got["n_nan"] == 1
        assert got["dtype"] == want["dtype"] == "float32"


def test_set_seed_also_seeds_torch(monkeypatch):
    np_state, py_state, torch_state = np.random.get_state(), random.getstate(), torch.get_rng_state()
    monkeypatch.setenv("PYTHONHASHSEED", os.environ.get("PYTHONHASHSEED", ""))
    try:
        draws = []
        for _ in range(2):
            misc.set_seed(123)
            draws.append((np.random.rand(4), random.random(), torch.rand(4)))
        np.testing.assert_array_equal(draws[0][0], draws[1][0])
        assert draws[0][1] == draws[1][1] and torch.equal(draws[0][2], draws[1][2])
        assert os.environ["PYTHONHASHSEED"] == "123"
    finally:
        np.random.set_state(np_state)
        random.setstate(py_state)
        torch.set_rng_state(torch_state)


def test_safe_mkdir_idempotent(tmp_path):
    d = str(tmp_path / "a" / "b")
    misc.safe_mkdir(d)
    misc.safe_mkdir(d)
    assert os.path.isdir(d)


@pytest.mark.parametrize("sync", [False, True])
def test_timing_section_accumulates(sync):
    times = SectionTimes()
    for _ in range(3):
        with timing_section("stage", times=times, sync=sync):
            torch.ones((8, 8)) @ torch.ones((8, 8))
    assert times.counts["stage"] == 3 and times.totals["stage"] >= 0.0
    assert "stage" in times.summary()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # a CUDA device without a card is refused, not skipped
            profiling.synchronize("cuda")


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with profiling.trace_to(str(tmp_path / "trace")) as prof:
        torch.ones((16, 16)) @ torch.ones((16, 16))
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0 and prof is not None


class VirtualClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _build_factory(clock, duration_fn):
    """duration_fn(iters, call_index) -> seconds the virtual call takes."""

    def build(iters):
        calls = {"n": 0}

        def fn(i):
            clock.now += duration_fn(iters, calls["n"])
            calls["n"] += 1

        return fn

    return build


_CLOCK_CASES = {
    "clean": (lambda iters, n: 0.002 + 0.004 * iters, dict(k_deltas=(5,), reps_schedule=(3,))),
    "noise": (lambda iters, n: 0.010 + 0.003 * (n % 3 == 0), dict(k_deltas=(5, 20), reps_schedule=(3, 5))),
    "zero_delta": (lambda iters, n: 0.010, dict(k_deltas=(5,), reps_schedule=(3,))),
    "escalates": (lambda iters, n: 0.002 + 0.004 * iters + (0.030 if n % 3 == 1 else 0.0),
                  dict(k_deltas=(5, 40), reps_schedule=(3,))),
}


@pytest.mark.parametrize("case", sorted(_CLOCK_CASES))
def test_measure_per_iter_s_matches_jax(case):
    """Accepts a clean delta, refuses noise and a zero delta, widens K
    before it accepts a noisy one: the same answer as the JAX package's on
    the same virtual clock."""
    duration, kw = _CLOCK_CASES[case]
    results = []
    for measure, error in ((measure_per_iter_s, DegenerateTimingError),
                           (jax_profiling.measure_per_iter_s, jax_profiling.DegenerateTimingError)):
        clock = VirtualClock()
        try:
            results.append(measure(_build_factory(clock, duration), case, time_fn=clock, **kw))
        except error:
            results.append("refused")
    assert results[0] == results[1]
    assert (results[0] == "refused") == (case in ("noise", "zero_delta"))
    if case == "clean":
        assert results[0] == pytest.approx(0.004, rel=1e-6)


def test_chained_builds_run_the_solves_they_chain(monkeypatch):
    """A chain of k runs k solves (scale_iters x k approximate ones), each
    from the chain's generator, and its dependency leaves the values alone:
    a one-solve chain returns the plain solve's sum."""
    solver = _tiny_solver()
    poses = _reachable(6, seed=3)
    calls = {"approx": 0, "exact": 0}
    approx, exact = solver.generate_ik_solutions, solver.generate_exact_ik_solutions

    def count(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(solver, "generate_ik_solutions", count("approx", approx))
    monkeypatch.setattr(solver, "generate_exact_ik_solutions", count("exact", exact))
    one = benchtools.chained_approx_build(solver, poses, seed=4)(1)(0)
    plain = approx(poses, generator=benchtools._generator(solver, 4, 0), allow_uninitialized=True)
    assert one == pytest.approx(float(plain.sum() * 1e-6), rel=1e-6)
    calls["approx"] = 0
    benchtools.chained_approx_build(solver, poses, scale_iters=3)(2)(0)
    assert calls["approx"] == 6
    out = benchtools.chained_exact_build(solver, poses, repeat_counts=(1, 2), n_opt_steps_max=2)(3)(0)
    assert calls["exact"] == 3 and np.isfinite(out)
