"""Multi-process runs of the port on the CPU: the process group's backend
follows the run's device (``parallel.mesh.initialize_multihost``, and
``train --data_parallel`` through it), and ``analysis.multihost_smoke``
with two gloo processes over loopback.

The smoke's ranks must end the data-parallel step with equal parameters,
within 1e-6 of one process's step on the 32 gathered rows with the same
noise (the shards' gradients are summed in another order); each worker has
``WORKER_TIMEOUT_S`` at most (``tests/torch_mh_worker.py`` runs one rank
and saves its parameters)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ikflow_tpu_torch.analysis import multihost_smoke
from ikflow_tpu_torch.cli.main import main as cli_main
from ikflow_tpu_torch.parallel import mesh
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.training.common import tree_leaves

MARKERS = ("WORLD_SIZE", "MASTER_ADDR", "SLURM_NTASKS", "SLURM_PROCID")
HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def card_present(monkeypatch):
    """A machine with a card, as far as the backend choice can see; every
    call of init_process_group recorded, none made."""
    for m in MARKERS:
        monkeypatch.delenv(m, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    return calls


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), (torch.device("cpu"), "gloo"), ("cuda", "nccl"),
                                            ("cuda:1", "nccl"), (None, "nccl")])
@pytest.mark.parametrize("form", ["coordinator_address", "torchrun"])
def test_backend_follows_the_device(card_present, monkeypatch, form, device, backend):
    """gloo for a CPU run on a machine with a card, NCCL for a CUDA run, and
    the old default (NCCL where there is a card) when no device is named,
    in both forms of the call."""
    if form == "coordinator_address":
        mesh.initialize_multihost("localhost:1234", 2, 1, device)
        assert card_present == [((backend,), {"init_method": "tcp://localhost:1234", "world_size": 2, "rank": 1})]
    else:
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        mesh.initialize_multihost(device=device)
        assert card_present == [((backend,), {})]


class _Joined(Exception):
    pass


def test_train_data_parallel_cpu_joins_gloo(card_present, monkeypatch):
    """``train --data_parallel --device cpu`` under torchrun's markers on a
    machine with a card resolves its device first and joins over gloo."""
    def join(*a, **k):
        card_present.append((a, k))
        raise _Joined  # stop the run once the group is joined

    monkeypatch.setattr(dist, "init_process_group", join)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(_Joined):
        cli_main(["train", "--robot_name", "panda", "--smoke", "--data_parallel", "--device", "cpu"])
    assert card_present == [(("gloo",), {})]


def test_cuda_run_needs_a_card_per_rank(monkeypatch):
    """``--device cuda`` puts rank i on cuda:i: with one card it refuses,
    naming the count, before it starts a worker; without a card it raises
    the port's no-card error."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost_smoke.main(["--device", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(multihost_smoke.subprocess, "Popen", None)  # no worker may start
    with pytest.raises(RuntimeError, match=r"needs 2 cards; this machine has 1"):
        multihost_smoke.main(["--device", "cuda"])
    assert multihost_smoke.worker_device("cpu", 1) == torch.device("cpu")


def test_multihost_smoke_two_gloo_ranks(capsys, monkeypatch):
    """The launcher's two gloo workers print the JAX script's lines and
    PASS."""
    monkeypatch.setenv("IKFLOW_TPU_MH_PORT", str(_free_port()))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert multihost_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "MULTIHOST SMOKE: PASS"
    for rank in range(2):
        assert any(line.startswith(f"[p{rank}] train step ok, global loss=") for line in out)
        assert any(line.startswith(f"[p{rank}] exact-IK ok on 32 cross-process poses (") and line.endswith("% valid)")
                   for line in out)


def test_multihost_ranks_equal_one_process_step(tmp_path):
    """Both ranks (``run_rank`` in two processes) hold the parameters of one
    process's step on the 32 gathered rows with the same noise, and the
    same 32-pose valid mask."""
    env = dict(os.environ, IKFLOW_TPU_MH_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mh_worker.py"), str(r),
                               str(tmp_path / f"rank{r}.pt")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=multihost_smoke.WORKER_TIMEOUT_S)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    robot = get_robot("panda")
    flow, params = multihost_smoke.tiny_flow()
    batches = [multihost_smoke.local_batch(robot, r) for r in range(2)]
    q, poses = (torch.cat([b[i] for b in batches]) for i in range(2))
    ref, ref_loss = multihost_smoke.train_step(flow, robot, params, q, poses,
                                               multihost_smoke.step_noise(flow, robot, 32), torch.device("cpu"),
                                               data_parallel=False)
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(2)]
    for g in got:
        np.testing.assert_allclose(g["loss"], ref_loss, rtol=1e-6)
        for a, b in zip(g["leaves"], tree_leaves(ref)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
        assert g["valids"].shape == (32,)
    assert torch.equal(got[0]["valids"], got[1]["valids"])
    moved = max(float((a - b).abs().max()) for a, b in zip(got[0]["leaves"], tree_leaves(params)))
    assert moved > 0  # the step changed the parameters
