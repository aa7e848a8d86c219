"""CUDA events on the right card's stream, checked on the CPU.

``torch.cuda.Event.record()`` with no stream records on the current
device's current stream. Code that times or waits for work on a tensor's or
a device's card must name that card's stream: on any card but the current
one, an event on the current card's stream neither times the work nor waits
for it. Tier-1 has no card, let alone two, so a fake ``torch.cuda`` (Event,
current_stream, synchronize, device) records the device of each event; the
work is on ``cuda:1`` while the current device is ``cuda:0``.
"""

import contextlib

import numpy as np
import pytest
import torch

from ikflow_tpu_torch.cli import common
from ikflow_tpu_torch.parallel import fleet

CARD = torch.device("cuda", 1)


class FakeStream:
    def __init__(self, index):
        self.device = torch.device("cuda", index)


class FakeCuda:
    """The parts of ``torch.cuda`` that event timing uses, on a fake
    two-card machine whose current device is ``cuda:0``."""

    def __init__(self):
        self.current = 0
        self.recorded = []  # device of each recorded event, in order
        self.synchronized = []  # devices drained by torch.cuda.synchronize
        self.waited = []  # devices of the events waited on

    def _index(self, device):
        if device is None:
            return self.current
        device = torch.device(device)
        return self.current if device.index is None else device.index

    def current_stream(self, device=None):
        return FakeStream(self._index(device))

    def synchronize(self, device=None):
        self.synchronized.append(torch.device("cuda", self._index(device)))

    @contextlib.contextmanager
    def device(self, device):
        prev, self.current = self.current, self._index(device)
        try:
            yield
        finally:
            self.current = prev

    def event_class(self):
        fake = self

        class FakeEvent:
            def __init__(self, enable_timing=False):
                self.device = None

            def record(self, stream=None):
                self.device = (stream or fake.current_stream()).device
                fake.recorded.append(self.device)

            def synchronize(self):
                fake.waited.append(self.device)

            def elapsed_time(self, other):
                assert self.device == other.device, "events of two cards cannot be compared"
                return 2.5

        return FakeEvent


@pytest.fixture
def fake_cuda(monkeypatch):
    fake = FakeCuda()
    monkeypatch.setattr(torch.cuda, "Event", fake.event_class())
    monkeypatch.setattr(torch.cuda, "current_stream", fake.current_stream)
    monkeypatch.setattr(torch.cuda, "synchronize", fake.synchronize)
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    return fake


class OnCard(torch.Tensor):
    """A CPU tensor that says it lies on ``cuda:1``."""

    @property
    def device(self):
        return CARD


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(OnCard, t)


@pytest.fixture
def pinned_on_cpu(monkeypatch):
    """``torch.empty(..., pin_memory=True)`` without a card: plain memory."""
    empty = torch.empty

    def fake_empty(*args, pin_memory=False, **kwargs):
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", fake_empty)


def test_timed_call_records_on_the_devices_stream(fake_cuda):
    ran = []
    seconds = common.timed_call_s(lambda: ran.append(fake_cuda.current), CARD)
    assert ran == [0]  # fn runs with the current device as it was
    assert fake_cuda.recorded == [CARD, CARD]
    assert seconds == pytest.approx(2.5e-3)
    assert fake_cuda.synchronized and all(d == CARD for d in fake_cuda.synchronized)


def test_to_host_records_on_the_tensors_stream(fake_cuda, pinned_on_cpu):
    packed = _on_card(torch.arange(12.0).reshape(3, 4))
    host, event = fleet._to_host(packed)
    assert fake_cuda.recorded == [CARD] and event.device == CARD
    np.testing.assert_array_equal(host.numpy(), np.arange(12.0).reshape(3, 4))


def _chunk_on_card(solver, poses, r, seed, salt, start, solve_args, mesh=None):
    """A chunk result that lies on cuda:1: every pose valid, q = its row."""
    m = poses.shape[0]
    packed = torch.cat([torch.arange(m, dtype=torch.float32)[:, None].expand(m, 7), torch.ones((m, 1))], dim=1)
    return _on_card(packed)


class _Solver:
    ndof = 7
    weights_version = 1
    capacity_cache = {}
    device = torch.device("cpu")

    def _check_loaded(self, allow_uninitialized):
        pass


def test_megabatch_compact_waits_on_the_chunks_stream(fake_cuda, pinned_on_cpu, monkeypatch):
    monkeypatch.setattr(fleet, "_solve_chunk", _chunk_on_card)
    poses = np.zeros((40, 7), np.float32)
    sols, valids = fleet.solve_exact_megabatch(_Solver(), poses, chunk_size=16, steady_chunk=64)
    assert valids.all() and sols.shape == (40, 7)
    assert fake_cuda.recorded and all(d == CARD for d in fake_cuda.recorded)
    assert fake_cuda.waited == fake_cuda.recorded


def test_megabatch_capped_waits_on_the_chunks_stream(fake_cuda, pinned_on_cpu, monkeypatch):
    def exact_chunk(solver, chunk, g, repeat_counts, capacities, tol, mesh=None):
        packed = _chunk_on_card(solver, chunk, 1, 0, 0, 0, tol)
        return packed, torch.full((len(repeat_counts),), chunk.shape[0])

    monkeypatch.setattr(fleet, "_exact_chunk", exact_chunk)
    poses = np.zeros((40, 7), np.float32)
    sols, valids = fleet.solve_exact_megabatch(_Solver(), poses, chunk_size=16, retry_capacities=None)
    assert valids.all()
    assert len(fake_cuda.recorded) == 3 and all(d == CARD for d in fake_cuda.recorded)
    assert fake_cuda.waited == fake_cuda.recorded
