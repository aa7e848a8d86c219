"""Captured CUDA graphs of the serving programs (one cache per solver) and
of the training programs (one cache per training run, ``Trainer.graph_scope``;
a data-parallel run keeps one more per other card, ``GraphCache.on``).

The counterpart of the JAX solver's ``_jit_cache``, where each serving entry
point is compiled once per shape by ``jax.jit``: here a program (one exact
tier, the approximate sample, the diverse selection) is captured once per key
into a ``torch.cuda.CUDAGraph`` over static input buffers, and replayed from
then on. One replay launches the thousands of small kernels of an LM loop
from one host call.

- **Key.** Everything the program bakes in as a Python value: the program's
  name, shapes, repeat count, tolerances, LM steps, damping, latent scale,
  flags; the solver adds its weights version and its device.
- **First call of a key** runs the program eagerly and returns its result:
  a shape called once (a one-shot ``solve``, a new batch size) pays no
  capture. It is also the capture's warm-up: it uploads the robot's and the
  flow's constants and loads the kernels' libraries, which a capture may
  not do.
- **Second call** captures the graph on static copies of the inputs and
  replays it.
- **Later calls** copy the inputs into the static buffers, replay, and
  return clones of the static outputs: a replay overwrites them, and callers
  keep earlier results (the megabatch's chunks, a caller's two solves).
- **Invalidation.** A graph holds raw pointers into the parameters it was
  captured on, so the solver empties its cache whenever its parameters are
  set, and a trainer's cache ends with its run.
- **Size.** At most ``DEFAULT_MAX_ENTRIES`` graphs; the least recently used
  is evicted and reset. Each graph keeps its own memory pool.

A capture or replay error raises: nothing falls back to the eager path.
Which tensors enter a cache is the caller's choice (the solver sends only
tensors on a card). The kernel wrappers count only what they launch: a
capture launches nothing, and a replay does not pass through them.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Sequence, Tuple

import torch

DEFAULT_MAX_ENTRIES = 32
# Calls of a key before its replays: the eager call and the capturing call.
# A timing warms up with this many calls of the timed call's shape.
WARMUP_CALLS = 2


class CudaBackend:
    """Capture and replay on a CUDA device."""

    def __init__(self, device: torch.device):
        self.device = device
        self._capture_stream = None

    def capture(self, fn: Callable, args: Sequence[torch.Tensor]):
        # A capture stream of the cache's own device: torch's shared default
        # is made on whichever device was current at its first use.
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(graph, stream=self._capture_stream):
            out = fn(*args)
        return graph, out

    def replay(self, graph) -> None:
        with torch.cuda.device(self.device):
            graph.replay()

    def for_device(self, device: torch.device) -> "CudaBackend":
        return CudaBackend(device)


@dataclass
class _Entry:
    graph: object
    inputs: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, ...]


def _as_tuple(out) -> Tuple[torch.Tensor, ...]:
    return out if isinstance(out, tuple) else (out,)


class GraphCache:
    """Captured programs keyed by ``run``'s key, least recently used first
    out. ``backend`` (default ``CudaBackend(device)``) captures and
    replays."""

    def __init__(self, device, backend=None):
        self.device = torch.device(device)
        self.backend = CudaBackend(self.device) if backend is None else backend
        self._entries: "OrderedDict[Hashable, _Entry]" = OrderedDict()
        self._seen: "OrderedDict[Hashable, None]" = OrderedDict()  # called once, run eagerly
        self._others: Dict[torch.device, "GraphCache"] = {}  # ``on``'s caches of other devices
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0  # host time of every capture

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Reset and drop every graph (new parameters make them stale), with
        those of ``on``'s caches."""
        for entry in self._entries.values():
            entry.graph.reset()
        self._entries.clear()
        self._seen.clear()
        for other in self._others.values():
            other.clear()
        self._others.clear()

    def on(self, device) -> "GraphCache":
        """The cache of the same run's programs on ``device``: this one for
        its own device, else one made on first use (its backend's
        ``for_device``) and emptied with this one. A data-parallel step
        captures each card's part on that card."""
        device = torch.device(device)
        if device == self.device:
            return self
        if device not in self._others:
            self._others[device] = GraphCache(device, backend=self.backend.for_device(device))
        return self._others[device]

    def run(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """``fn(*inputs)`` (a tensor or a tuple of tensors): eagerly on the
        key's first call, through the key's graph from its second call, which
        captures it. -> a tuple of fresh tensors."""
        entry = self._entries.get(key)
        if entry is None:
            if key not in self._seen:
                self._seen[key] = None
                if len(self._seen) > DEFAULT_MAX_ENTRIES:
                    self._seen.popitem(last=False)
                return _as_tuple(fn(*inputs))
            del self._seen[key]
            entry = self._capture(fn, inputs)
            self._entries[key] = entry
            if len(self._entries) > DEFAULT_MAX_ENTRIES:
                _, old = self._entries.popitem(last=False)
                old.graph.reset()
        else:
            self._entries.move_to_end(key)
            for static, x in zip(entry.inputs, inputs):
                static.copy_(x)
        self.backend.replay(entry.graph)
        self.replays += 1
        return tuple(out.clone() for out in entry.outputs)

    def _capture(self, fn: Callable, inputs: Sequence[torch.Tensor]) -> _Entry:
        t0 = time.perf_counter()
        static = tuple(x.detach().clone() for x in inputs)
        graph, out = self.backend.capture(fn, static)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return _Entry(graph, static, _as_tuple(out))
