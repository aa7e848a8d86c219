"""Fused coupling-subnet MLP: hand-written CUDA kernels and their plain versions.

They replace the Pallas TPU kernel ``ikflow_tpu/flow/pallas_subnet.py::fused_mlp``,
which compiles to one of two bodies by its static flag ``bf16_hidden``. All
compute ``h <- x``, then ``h <- h W + b`` per layer with LeakyReLU(0.01) after
all but the last, for a (B, in) fp32 input.

- K1, ``fused_mlp`` (``csrc/fused_mlp.cu``): the fp32 contract on the tensor
  cores. The width x width layers run as 3xTF32 on wgmma (each operand split
  into two TF32 parts, three products summed in fp32, as accurate as fp32
  FFMA); the first and the last layer are fp32 FFMA. A cluster of
  width / 128 CTAs shares a 64-row tile, each CTA owning 128 columns of every
  hidden layer and streaming only those weights; the CTAs read each other's
  activation slices through distributed shared memory. The hidden weights
  are split and packed once per parameter set into the kernel's
  shared-memory layout (``prepare_tf32x3_subnet``), zero-padded to a
  multiple of 128 columns. One launch shape serves every B; see the source.
- K1', ``fused_mlp_bf16`` (``csrc/fused_mlp_bf16.cu``): the layers
  ``0 < i < n-1`` take bf16 inputs and bf16 weights with fp32 accumulation,
  on wgmma; the first and last layer, biases and activations stay fp32. The
  same cluster split as K1; its hidden weights are converted to bf16 once per
  parameter set and packed into the order wgmma reads them, zero-padded to a
  multiple of 128 columns, so that each (CTA slice, 64-row chunk) is one
  contiguous block that the kernel streams by bulk async copy
  (``prepare_bf16_subnet``). It takes the shapes K1 takes.

Both kernels are built by nvcc into C-ABI libraries and called through ctypes
on PyTorch's current stream. A wrapper takes its plain version only for
tensors on the CPU; for a CUDA tensor it launches its kernel or raises.
Each wrapper's ``launches`` counts the launches it makes; under a CUDA graph
capture it records the kernel into the graph and counts nothing, and a
graph's replays do not pass through it.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from ikflow_tpu_torch import cuda_build

LEAKY_SLOPE = 0.01
MAX_LAYERS = 5  # must match csrc/fused_mlp.cu and csrc/fused_mlp_bf16.cu
MAX_OUT = 16
MAX_WIDTH = 1024  # a cluster of at most 8 CTAs of 128 columns
# The packed layouts: SLICE_COLS must match kSlice in csrc/cluster_mlp.cuh,
# K1_CHUNK kChunk in csrc/fused_mlp.cu, K1B_CHUNK kChunk in csrc/fused_mlp_bf16.cu.
SLICE_COLS = 128
K1_CHUNK = 32
K1B_CHUNK = 64

_BOUND: Dict[str, ctypes.CDLL] = {}


def _library(name: str, entry: str, n_ptr_arrays: int, error_string: str) -> ctypes.CDLL:
    """``build/lib<name>.so`` with ``entry(x, out, B, in, width, out_dim,
    n_layers, <n_ptr_arrays arrays of MAX_LAYERS pointers>, stream)`` and
    ``error_string(err)`` declared."""
    lib = _BOUND.get(name)
    if lib is None:
        lib = cuda_build.load(name)
        ptrs = ctypes.c_void_p * MAX_LAYERS
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ptrs] * n_ptr_arrays + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        getattr(lib, error_string).argtypes = [ctypes.c_int]
        getattr(lib, error_string).restype = ctypes.c_char_p
        _BOUND[name] = lib
    return lib


def _launch(lib: ctypes.CDLL, entry: str, error_string: str, x: torch.Tensor,
            layers: Sequence[Dict[str, torch.Tensor]], *ptr_arrays) -> torch.Tensor:
    """Allocate the (B, out) output and launch ``entry`` on the current stream;
    raise if the launch fails. Launches nothing for B == 0."""
    B, in_dim = x.shape
    out_dim = layers[-1]["w"].shape[1]
    out = torch.empty((B, out_dim), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), B, in_dim, layers[0]["w"].shape[1], out_dim,
                                  len(layers), *ptr_arrays, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: {getattr(lib, error_string)(err).decode()}")
    return out


def _pointers(layers: Sequence[Dict[str, torch.Tensor]], key: str):
    return (ctypes.c_void_p * MAX_LAYERS)(*[layer[key].data_ptr() if key in layer else None for layer in layers])


def fused_mlp_plain(x: torch.Tensor, layers: Sequence[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """The plain version: addmm + leaky_relu per layer."""
    h = x
    for i, layer in enumerate(layers):
        h = torch.addmm(layer["b"], h, layer["w"])
        if i < len(layers) - 1:
            h = F.leaky_relu(h, LEAKY_SLOPE)
    return h


def fused_mlp_bf16_plain(x: torch.Tensor, layers: Sequence[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """The plain version of K1': ``apply_subnet(..., bf16_hidden=True)``.

    A hidden layer rounds its input and its weights to bf16 and multiplies the
    upcast values in fp32 (exact products, fp32 sums; a bf16 x bf16 matmul
    would round its output to bf16), then adds the bias in fp32. Run it with
    TF32 off. The first and the last layer are fp32 ``addmm``."""
    h = x
    n = len(layers)
    for i, layer in enumerate(layers):
        if 0 < i < n - 1:
            acc = h.to(torch.bfloat16).float() @ layer["w"].to(torch.bfloat16).float()
            h = acc + layer["b"]
        else:
            h = torch.addmm(layer["b"], h, layer["w"])
        if i < n - 1:
            h = F.leaky_relu(h, LEAKY_SLOPE)
    return h


def pack_bf16_weight(w: torch.Tensor) -> torch.Tensor:
    """A hidden weight (K, N) fp32, zero-padded to (K', N'), the next
    multiples of 128, rounded to bf16 (to nearest even) and laid out as K1'
    streams it into shared memory, flat: for each 128-column CTA slice c and
    64-row chunk j, one 16 KB block in wgmma's K-major core-matrix order
    [n // 8][k // 8][n % 8][k % 8] (column n = 128 c + n, row k = 64 j + k).
    The padding is exact: a padded column's activation is LeakyReLU(0) = 0,
    and a padded row meets it with zeros."""
    K, N = w.shape
    Kp, Np = _padded(K), _padded(N)
    wb = F.pad(w, (0, Np - N, 0, Kp - K)).to(torch.bfloat16)
    wb = wb.reshape(Kp // K1B_CHUNK, 8, 8, Np // SLICE_COLS, 16, 8)  # [j, kb, k8, c, nb, n8]
    return wb.permute(3, 0, 4, 1, 5, 2).contiguous().reshape(-1)  # [c, j, nb, kb, n8, k8]


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi = rna_tf32(x), lo = rna_tf32(x - hi), as K1 splits
    its activations: round to nearest, ties away from zero, on the fp32 bit
    pattern, keeping the top 19 bits (``cvt.rna.tf32.f32``)."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def _padded(n: int) -> int:
    return -(-n // SLICE_COLS) * SLICE_COLS


def pack_tf32x3_weight(w: torch.Tensor) -> torch.Tensor:
    """A hidden weight (K, N) fp32, zero-padded to (K', N'), the next
    multiples of 128, split into its tf32 hi and lo parts and laid out as K1
    stages it in shared memory, flat: for each 128-column CTA slice c and
    32-row chunk j, the hi plane then the lo plane, each in wgmma's K-major
    core-matrix order [n // 8][k // 4][n % 8][k % 4] (column n = 128 c + n,
    row k = 32 j + k). The padding is exact: a padded column's activation is
    LeakyReLU(0) = 0, and a padded row meets it with zeros."""
    K, N = w.shape
    Kp, Np = _padded(K), _padded(N)
    planes = torch.stack(split_tf32(F.pad(w, (0, Np - N, 0, Kp - K))))
    planes = planes.reshape(2, Kp // K1_CHUNK, 8, 4, Np // SLICE_COLS, 16, 8)  # [p, j, kb, k4, c, nb, n8]
    return planes.permute(4, 1, 0, 5, 2, 6, 3).contiguous().reshape(-1)  # [c, j, p, nb, kb, n8, k4]


def _tf32x3_numel(w: torch.Tensor) -> int:
    return 2 * _padded(w.shape[0]) * _padded(w.shape[1])


def _bf16_numel(w: torch.Tensor) -> int:
    return _padded(w.shape[0]) * _padded(w.shape[1])


def _contiguous(layer: Dict[str, torch.Tensor], **extra) -> Dict[str, torch.Tensor]:
    return dict(layer, w=layer["w"].contiguous(), b=layer["b"].contiguous(), **extra)


def prepare_tf32x3_subnet(layers: Sequence[Dict[str, torch.Tensor]]):
    """The subnet's layers with each hidden layer's packed tf32 hi/lo planes
    added under ``"wp"``: done once per parameter set, read by every K1
    launch. Weights and biases come back contiguous, as the kernel reads
    them."""
    n = len(layers)
    return [_contiguous(layer, wp=pack_tf32x3_weight(layer["w"])) if 0 < i < n - 1 else _contiguous(layer)
            for i, layer in enumerate(layers)]


def prepare_bf16_subnet(layers: Sequence[Dict[str, torch.Tensor]]):
    """The subnet's layers with each hidden layer's packed bf16 weight added
    under ``"wp"``: done once per parameter set, read by every K1' launch.
    Weights and biases come back contiguous, as the kernel reads them."""
    n = len(layers)
    return [_contiguous(layer, wp=pack_bf16_weight(layer["w"])) if 0 < i < n - 1 else _contiguous(layer)
            for i, layer in enumerate(layers)]


def _check(x: torch.Tensor, layers: Sequence[Dict[str, torch.Tensor]]) -> None:
    """Raise on what the kernels do not take."""
    if not 2 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"fused_mlp takes 2..{MAX_LAYERS} layers, got {len(layers)}")
    if x.ndim != 2:
        raise ValueError(f"x must be (B, in), got shape {tuple(x.shape)}")
    width = layers[0]["w"].shape[1]
    if width % 4 or not 0 < width <= MAX_WIDTH:
        raise ValueError(f"hidden width must be a multiple of 4 and <= {MAX_WIDTH}, got {width}")
    k = x.shape[1]
    if k > width:
        raise ValueError(f"input width {k} exceeds the hidden width {width}")
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


def _check_packed(x: torch.Tensor, layers: Sequence[Dict[str, torch.Tensor]], dtype: torch.dtype,
                  packed_numel: Callable[[torch.Tensor], int], prepare: str) -> None:
    """Each hidden layer carries its packed weight ``"wp"`` of
    ``packed_numel(w)`` elements, contiguous, 16-byte aligned, on x's
    device."""
    for i, layer in enumerate(layers[1:-1], start=1):
        wp = layer.get("wp")
        if wp is None:
            raise ValueError(f"layer {i} has no packed weight: prepare the subnet once with {prepare}")
        n = packed_numel(layer["w"])
        if wp.dtype != dtype or wp.numel() != n or not wp.is_contiguous():
            raise ValueError(f"layer {i}: packed weight must be contiguous {dtype} of {n} elements")
        if wp.device != x.device or wp.data_ptr() % 16:
            raise ValueError(f"layer {i}: packed weight must be 16-byte aligned on {x.device}")


def fused_mlp(x: torch.Tensor, layers: Sequence[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Subnet MLP: x (B, in) -> (B, out). ``layers`` is a list of
    ``{"w": (K, N), "b": (N,)}``, hidden widths equal, a multiple of 4 up to
    1024, in <= width, last N <= 16; on the card from
    ``prepare_tf32x3_subnet`` (hidden layers carry their packed planes
    ``"wp"``)."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, layers)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on CUDA or CPU tensors, got {x.device}")
    _check(x, layers)
    _check_packed(x, layers, torch.float32, _tf32x3_numel, "prepare_tf32x3_subnet")
    lib = _library("fused_mlp", "ikflow_fused_mlp", 3, "ikflow_cuda_error_string")
    out = _launch(lib, "ikflow_fused_mlp", "ikflow_cuda_error_string", x, layers,
                  _pointers(layers, "w"), _pointers(layers, "wp"), _pointers(layers, "b"))
    if x.shape[0] and not torch.cuda.is_current_stream_capturing():
        fused_mlp.launches += 1
    return out


fused_mlp.launches = 0  # kernel launches; neither the plain CPU path nor a graph capture counts


def _check_bf16(x: torch.Tensor, layers: Sequence[Dict[str, torch.Tensor]]) -> None:
    _check(x, layers)
    _check_packed(x, layers, torch.bfloat16, _bf16_numel, "prepare_bf16_subnet")


def fused_mlp_bf16(x: torch.Tensor, layers: Sequence[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Subnet MLP with bf16 hidden layers: x (B, in) -> (B, out). ``layers``
    as for ``fused_mlp``, from ``prepare_bf16_subnet`` (hidden layers carry
    their packed bf16 weight ``"wp"``); hidden width a multiple of 4 up to
    1024, in <= width, last N <= 16."""
    if x.device.type == "cpu":
        return fused_mlp_bf16_plain(x, layers)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_bf16 runs on CUDA or CPU tensors, got {x.device}")
    _check_bf16(x, layers)
    lib = _library("fused_mlp_bf16", "ikflow_fused_mlp_bf16", 3, "ikflow_bf16_cuda_error_string")
    out = _launch(lib, "ikflow_fused_mlp_bf16", "ikflow_bf16_cuda_error_string", x, layers,
                  _pointers(layers, "w"), _pointers(layers, "wp"), _pointers(layers, "b"))
    if x.shape[0] and not torch.cuda.is_current_stream_capturing():
        fused_mlp_bf16.launches += 1
    return out


fused_mlp_bf16.launches = 0  # kernel launches; neither the plain CPU path nor a graph capture counts
