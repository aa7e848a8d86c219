"""The port's device mesh (``ikflow_tpu_torch/parallel/mesh.py``) on the CPU:
padding as the JAX package pads, even shards and replicas on ``[cpu] * k``,
the refusal to build a default mesh without a card, and
``initialize_multihost``'s markers, as ``tests/test_sharding.py`` checks the
JAX package's (``torch.distributed.init_process_group`` replaced)."""

import pytest
import torch
import torch.distributed as dist

from ikflow_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple
from ikflow_tpu_torch.parallel import mesh

CPU = torch.device("cpu")
MARKERS = ("WORLD_SIZE", "MASTER_ADDR", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_JOB_ID")


def test_pad_to_multiple_matches_jax():
    for n in range(0, 70):
        for m in (1, 2, 3, 4, 8):
            assert mesh.pad_to_multiple(n, m) == jax_pad_to_multiple(n, m)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_shard_batch_and_replicate_on_cpu_entries(k):
    m = mesh.make_mesh([CPU] * k)
    assert m.size == k and m.axis_names == (mesh.DATA_AXIS,) and all(d == CPU for d in m.devices)
    x, y = torch.arange(24.0).reshape(12, 2), torch.arange(12)
    xs, ys = mesh.shard_batch(m, x, y)
    assert [s.shape[0] for s in xs] == [12 // k] * k
    torch.testing.assert_close(torch.cat(xs), x, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(ys), y, rtol=0, atol=0)
    tree = ({"w": torch.ones(3), "b": [torch.zeros(2)]},)
    reps = mesh.replicate(m, tree)
    assert len(reps) == k and all(r[0]["w"].device == CPU and r[0]["b"][0].shape == (2,) for r in reps)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch(mesh.make_mesh([CPU] * 5), x)


def test_split_bounds_are_even_and_cover():
    for n in range(0, 40):
        for parts in (1, 2, 3, 4, 8):
            b = mesh.split_bounds(n, parts)
            sizes = [b[i + 1] - b[i] for i in range(parts)]
            assert b[0] == 0 and b[-1] == n and max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


def test_default_mesh_needs_a_card(monkeypatch):
    """``make_mesh()`` spans the CUDA devices; with none it raises, and so
    does a named CUDA entry: no mesh falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="there is none"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="at least one"):
        mesh.make_mesh([])


def test_initialize_multihost_single_process_noop(monkeypatch):
    """Without a multi-process marker, init_process_group is never called."""
    for m in MARKERS:
        monkeypatch.delenv(m, raising=False)

    def _boom(*a, **k):
        raise AssertionError("init_process_group must not be called")

    monkeypatch.setattr(dist, "init_process_group", _boom)
    mesh.initialize_multihost()
    assert not dist.is_initialized()


def test_initialize_multihost_marker_triggers_init(monkeypatch):
    """A multi-process marker (torchrun's WORLD_SIZE > 1 with MASTER_ADDR, or
    SLURM_NTASKS > 1) calls init_process_group; single-process markers do
    not; an init failure surfaces; an initialized group is left alone."""
    for m in MARKERS:
        monkeypatch.delenv(m, raising=False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # gloo: the backend without a card

    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("SLURM_JOB_ID", "123")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    mesh.initialize_multihost()
    assert calls == []

    monkeypatch.setenv("WORLD_SIZE", "2")
    mesh.initialize_multihost()
    assert calls == [(("gloo",), {})]

    calls.clear()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_PROCID", "3")
    mesh.initialize_multihost()
    assert calls == [(("gloo",), {"world_size": 4, "rank": 3})]

    calls.clear()
    mesh.initialize_multihost("localhost:1234", num_processes=2, process_id=1)
    assert calls == [(("gloo",), {"init_method": "tcp://localhost:1234", "world_size": 2, "rank": 1})]

    def _fail(*a, **k):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(dist, "init_process_group", _fail)
    with pytest.raises(RuntimeError, match="coordinator"):
        mesh.initialize_multihost()

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    mesh.initialize_multihost()  # a group exists: nothing to do
