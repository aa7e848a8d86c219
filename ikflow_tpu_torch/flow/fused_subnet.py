"""Fused coupling-subnet MLP: a hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``ikflow_tpu/flow/pallas_subnet.py::fused_mlp``.
Both compute ``h <- x``, then ``h <- h W + b`` per layer with LeakyReLU(0.01)
after all but the last, for a (B, in) fp32 input.

Kernel: ``csrc/fused_mlp.cu``, built by nvcc into a C-ABI library and called
through ctypes on PyTorch's current stream. It is bound by fp32 operations:
2 * B * (in*W + 2*W^2 + W*out) FLOP, about 4.2 MFLOP per row at width 1024,
against 8.4 MB of weights. Its design keeps each 16-row tile's activations in
shared memory across all layers (no (B, width) activation goes to device
memory) and streams the weights from L2, each weight read feeding 16 FMAs;
see the source for the details.

``fused_mlp`` takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from ikflow_tpu_torch import cuda_build

LEAKY_SLOPE = 0.01
MAX_LAYERS = 5  # must match csrc/fused_mlp.cu
MAX_OUT = 16
MAX_WIDTH = 1024  # two fp32 buffers of 16 x width rows must fit in shared memory

_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("fused_mlp")
        ptrs = ctypes.c_void_p * MAX_LAYERS
        lib.ikflow_fused_mlp.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ptrs, ptrs, ctypes.c_void_p,
        ]
        lib.ikflow_fused_mlp.restype = ctypes.c_int
        lib.ikflow_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ikflow_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def fused_mlp_plain(x: torch.Tensor, layers: Sequence[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """The plain version: addmm + leaky_relu per layer."""
    h = x
    for i, layer in enumerate(layers):
        h = torch.addmm(layer["b"], h, layer["w"])
        if i < len(layers) - 1:
            h = F.leaky_relu(h, LEAKY_SLOPE)
    return h


def _check(x: torch.Tensor, layers: Sequence[Dict[str, torch.Tensor]]) -> None:
    if not 2 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"fused_mlp takes 2..{MAX_LAYERS} layers, got {len(layers)}")
    if x.ndim != 2:
        raise ValueError(f"x must be (B, in), got shape {tuple(x.shape)}")
    width = layers[0]["w"].shape[1]
    if width % 4 or width > MAX_WIDTH:
        raise ValueError(f"hidden width must be a multiple of 4 and <= {MAX_WIDTH}, got {width}")
    k = x.shape[1]
    if k > width:
        raise ValueError(f"input width {k} exceeds hidden width {width}")
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        n = w.shape[1]
        last = i == len(layers) - 1
        if w.ndim != 2 or w.shape[0] != k or b.shape != (n,):
            raise ValueError(f"layer {i}: w {tuple(w.shape)}, b {tuple(b.shape)} do not follow input width {k}")
        if (n > MAX_OUT) if last else (n != width):
            raise ValueError(f"layer {i}: output width {n} not supported (hidden {width}, last <= {MAX_OUT})")
        k = n
    for t in [x] + [t for layer in layers for t in (layer["w"], layer["b"])]:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mlp is fp32 only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("fused_mlp needs contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("fused_mlp needs 16-byte aligned tensors")


def fused_mlp(x: torch.Tensor, layers: Sequence[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Subnet MLP: x (B, in) -> (B, out). ``layers`` is a list of
    ``{"w": (K, N), "b": (N,)}``, hidden widths equal, last N <= 16."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, layers)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on CUDA or CPU tensors, got {x.device}")
    _check(x, layers)
    B, in_dim = x.shape
    out_dim = layers[-1]["w"].shape[1]
    out = torch.empty((B, out_dim), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = _library()
    ptrs = ctypes.c_void_p * MAX_LAYERS
    w = ptrs(*[layer["w"].data_ptr() for layer in layers])
    b = ptrs(*[layer["b"].data_ptr() for layer in layers])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ikflow_fused_mlp(
            x.data_ptr(), out.data_ptr(), B, in_dim, layers[0]["w"].shape[1], out_dim, len(layers), w, b, stream
        )
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: {lib.ikflow_cuda_error_string(err).decode()}")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0  # kernel launches; the plain CPU path does not count
