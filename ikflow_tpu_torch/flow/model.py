"""Conditional GLOW coupling flow on torch tensors.

Port of ``ikflow_tpu/flow/model.py``: ``nb_nodes`` x (fixed random permutation
-> conditional affine GLOW coupling) between an input head and the latent
space. The split is pinned to ``D // 2``, the soft clamp is ``atan`` or
``atan_scaled``, the head is the affine joint scaling or the exact
joint-limits -> [0, 1] map with an inverse sigmoid, and the permutations come
from ``np.random.RandomState(i)`` as in the JAX package.

Parameters are a tuple of per-block ``{"s1": layers, "s2": layers}``, each
layer ``{"w": (K, N), "b": (N,)}``: the JAX pytree's structure.

``forward`` (q -> z, with logdet) runs the plain subnet. ``inverse``
(z -> q, the inference path) runs every subnet through ``fused_mlp`` (K1), or
``fused_mlp_bf16`` (K1') when ``hp.bf16_hidden``: the CUDA kernel for tensors
on the card, its plain version on the CPU. Both kernels read their hidden
weights packed once per parameter set by ``kernel_params``: K1 as tf32 hi/lo
planes (on the card only), K1' as bf16. ``inverse_plain`` runs the plain
versions on any device (the analysis studies' reference).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ikflow_tpu_torch.config import SIGMOID_SCALING_ABS_MAX
from ikflow_tpu_torch.flow.fused_subnet import (
    fused_mlp,
    fused_mlp_bf16,
    fused_mlp_bf16_plain,
    fused_mlp_plain,
    prepare_bf16_subnet,
    prepare_tf32x3_subnet,
)
from ikflow_tpu_torch.flow.params import FlowHyperParams

_TWO_OVER_PI = 2.0 / np.pi


class GlowFlow:
    """Static flow definition; parameters are passed to each call."""

    def __init__(self, hp: FlowHyperParams, joint_limits: Sequence[Tuple[float, float]], dim_cond: int):
        if hp.coupling_layer != "glow":
            raise ValueError(f"unsupported coupling layer {hp.coupling_layer!r}")
        if hp.clamp_activation not in ("atan", "atan_scaled"):
            raise ValueError(f"unsupported clamp activation {hp.clamp_activation!r}")
        if hp.coeff_fn_config not in (1, 2, 3, 4):
            raise ValueError("subnet depth (coeff_fn_config) must be in [1, 4]")
        self.hp = hp
        self.dim_cond = dim_cond
        self.ndof = len(joint_limits)
        self.D = hp.dim_latent_space
        if self.D < self.ndof:
            raise ValueError(f"dim_latent_space ({self.D}) must be >= ndof ({self.ndof})")
        self.split1 = self.D // 2
        self.split2 = self.D - self.split1
        self.clamp = float(hp.rnvp_clamp)
        self._subnet_plain = fused_mlp_bf16_plain if hp.bf16_hidden else fused_mlp_plain
        self._subnet_kernel = fused_mlp_bf16 if hp.bf16_hidden else fused_mlp

        # Fm.PermuteRandom(seed=i): output[:, j] = input[:, perm[j]].
        if hp.permute_random_enabled:
            self._perms = [np.random.RandomState(i).permutation(self.D) for i in range(hp.nb_nodes)]
        else:
            self._perms = [np.arange(self.D) for _ in range(hp.nb_nodes)]
        self._inv_perms = [np.argsort(p) for p in self._perms]

        lows = np.array([lim[0] for lim in joint_limits], dtype=np.float64)
        highs = np.array([lim[1] for lim in joint_limits], dtype=np.float64)
        if hp.sigmoid_on_output:
            # Joints -> [0, 1] exactly; pads map (-SMAX, SMAX) -> (0, 1).
            scale = np.ones(self.D)
            offset = np.zeros(self.D)
            scale[: self.ndof] = 1.0 / (highs - lows)
            offset[: self.ndof] = -lows / (highs - lows)
            scale[self.ndof :] = 1.0 / (2.0 * SIGMOID_SCALING_ABS_MAX)
            offset[self.ndof :] = 0.5
        else:
            # Joints scaled by 1 / max(|lo|, |hi|) to about [-1, 1]; pads untouched.
            scale = np.ones(self.D)
            scale[: self.ndof] = 1.0 / np.maximum(np.abs(lows), np.abs(highs))
            offset = np.zeros(self.D)
        self._head_scale = scale
        self._head_offset = offset
        self._head_logdet = float(np.sum(np.log(np.abs(scale))))
        self._consts: Dict[Tuple[torch.device, torch.dtype], dict] = {}

    def _constants(self, device, dtype) -> dict:
        key = (torch.device(device), dtype)
        c = self._consts.get(key)
        if c is None:
            c = self._consts[key] = {
                "scale": torch.as_tensor(self._head_scale, dtype=dtype, device=device),
                "offset": torch.as_tensor(self._head_offset, dtype=dtype, device=device),
                "perms": [torch.as_tensor(p, device=device) for p in self._perms],
                "inv_perms": [torch.as_tensor(p, device=device) for p in self._inv_perms],
            }
        return c

    # ------------------------------------------------------------------
    def param_shapes(self):
        """Per-block layer shapes, in the parameters' structure:
        s1: (split1 + cond) -> 2 * split2, s2: (split2 + cond) -> 2 * split1."""
        width, depth = self.hp.coeff_fn_internal_size, self.hp.coeff_fn_config

        def subnet(ch_in, ch_out):
            dims = [ch_in] + [width] * depth + [ch_out]
            return [{"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)} for i in range(len(dims) - 1)]

        return tuple(
            {
                "s1": subnet(self.split1 + self.dim_cond, 2 * self.split2),
                "s2": subnet(self.split2 + self.dim_cond, 2 * self.split1),
            }
            for _ in range(self.hp.nb_nodes)
        )

    def init(self, generator: torch.Generator, dtype=torch.float32):
        """Random parameters on the generator's device, torch.nn.Linear-style
        U(+-1/sqrt(fan_in)) for weights and biases."""

        def uniform(shape, fan_in):
            u = torch.rand(shape, generator=generator, device=generator.device, dtype=dtype)
            return (2.0 * u - 1.0) / float(np.sqrt(fan_in))

        return tuple(
            {
                s: [{"w": uniform(layer["w"], layer["w"][0]), "b": uniform(layer["b"], layer["w"][0])}
                    for layer in block[s]]
                for s in ("s1", "s2")
            }
            for block in self.param_shapes()
        )

    def kernel_params(self, params):
        """``params`` as ``inverse`` reads them, built here once per parameter
        set: every subnet's hidden layers also carry their packed weight, bf16
        with ``bf16_hidden``, else K1's tf32 hi/lo planes. The fp32 planes are
        built only for parameters on the card: the CPU runs the plain
        version, which reads ``params`` itself."""
        if self.hp.bf16_hidden:
            prepare = prepare_bf16_subnet
        elif params[0]["s1"][0]["w"].is_cuda:
            prepare = prepare_tf32x3_subnet
        else:
            return params
        return tuple({s: prepare(block[s]) for s in ("s1", "s2")} for block in params)

    # ------------------------------------------------------------------
    def _clamped(self, s: torch.Tensor) -> torch.Tensor:
        if self.hp.clamp_activation == "atan":
            return self.clamp * _TWO_OVER_PI * torch.atan(s)
        return self.clamp * _TWO_OVER_PI * torch.atan(s / self.clamp)

    def _couple_forward(self, block, x: torch.Tensor, cond: torch.Tensor):
        x1, x2 = x[:, : self.split1], x[:, self.split1 :]
        a2 = self._subnet_plain(torch.cat([x2, cond], dim=1), block["s2"])
        s2 = self._clamped(a2[:, : self.split1])
        y1 = x1 * torch.exp(s2) + a2[:, self.split1 :]
        a1 = self._subnet_plain(torch.cat([y1, cond], dim=1), block["s1"])
        s1 = self._clamped(a1[:, : self.split2])
        y2 = x2 * torch.exp(s1) + a1[:, self.split2 :]
        return torch.cat([y1, y2], dim=1), s1.sum(dim=1) + s2.sum(dim=1)

    def _couple_inverse(self, block, y: torch.Tensor, cond: torch.Tensor, subnet):
        y1, y2 = y[:, : self.split1], y[:, self.split1 :]
        a1 = subnet(torch.cat([y1, cond], dim=1), block["s1"])
        s1 = self._clamped(a1[:, : self.split2])
        x2 = (y2 - a1[:, self.split2 :]) * torch.exp(-s1)
        a2 = subnet(torch.cat([x2, cond], dim=1), block["s2"])
        s2 = self._clamped(a2[:, : self.split1])
        x1 = (y1 - a2[:, self.split1 :]) * torch.exp(-s2)
        return torch.cat([x1, x2], dim=1), -(s1.sum(dim=1) + s2.sum(dim=1))

    def _head_forward(self, x: torch.Tensor):
        c = self._constants(x.device, x.dtype)
        out = x * c["scale"] + c["offset"]
        logdet = torch.full((x.shape[0],), self._head_logdet, dtype=x.dtype, device=x.device)
        if self.hp.sigmoid_on_output:
            u = torch.clamp(out, 1e-7, 1.0 - 1e-7)
            out = torch.log(u / (1.0 - u))
            logdet = logdet - torch.sum(F.logsigmoid(out) + F.logsigmoid(-out), dim=1)
        return out, logdet

    def _head_inverse(self, u: torch.Tensor):
        c = self._constants(u.device, u.dtype)
        logdet = torch.full((u.shape[0],), -self._head_logdet, dtype=u.dtype, device=u.device)
        if self.hp.sigmoid_on_output:
            # The sigmoid bounds the outputs, so q lies inside the joint limits.
            logdet = logdet + torch.sum(F.logsigmoid(u) + F.logsigmoid(-u), dim=1)
            u = torch.sigmoid(u)
        return (u - c["offset"]) / c["scale"], logdet

    def _check_inputs(self, x: torch.Tensor, cond: torch.Tensor) -> None:
        if x.ndim != 2 or x.shape[1] != self.D:
            raise ValueError(f"expected (n, {self.D}), got {tuple(x.shape)}")
        if tuple(cond.shape) != (x.shape[0], self.dim_cond):
            raise ValueError(f"cond must be ({x.shape[0]}, {self.dim_cond}), got {tuple(cond.shape)}")

    # ------------------------------------------------------------------
    def forward(self, params, x: torch.Tensor, cond: torch.Tensor):
        """q-space (n, D) -> latent z, with the total log|det J|."""
        self._check_inputs(x, cond)
        c = self._constants(x.device, x.dtype)
        h, logdet = self._head_forward(x)
        for i, block in enumerate(params):
            h = h[:, c["perms"][i]]
            h, ld = self._couple_forward(block, h, cond)
            logdet = logdet + ld
        return h, logdet

    def inverse(self, params, z: torch.Tensor, cond: torch.Tensor):
        """Latent z (n, D) -> q-space, with log|det J| of the inverse map.
        On the card a bf16 flow needs ``kernel_params(params)``."""
        return self._inverse(params, z, cond, self._subnet_kernel)

    def inverse_plain(self, params, z: torch.Tensor, cond: torch.Tensor):
        """``inverse`` with every subnet through its plain version, on any
        device, from the unpacked ``params``: the whole-flow reference the
        kernels are held to (the JAX package's XLA ``inverse`` beside its
        ``inverse_fused``). The solver never calls it."""
        return self._inverse(params, z, cond, self._subnet_plain)

    def _inverse(self, params, z: torch.Tensor, cond: torch.Tensor, subnet):
        self._check_inputs(z, cond)
        c = self._constants(z.device, z.dtype)
        h = z
        logdet = torch.zeros((z.shape[0],), dtype=z.dtype, device=z.device)
        for i in reversed(range(len(params))):
            h, ld = self._couple_inverse(params[i], h, cond, subnet)
            logdet = logdet + ld
            h = h[:, c["inv_perms"][i]]
        h, ld = self._head_inverse(h)
        return h, logdet + ld

    def n_params(self, params) -> int:
        """Parameter count of a parameter tuple (packed kernel copies not counted)."""
        return sum(layer[k].numel() for block in params for s in ("s1", "s2") for layer in block[s] for k in ("w", "b"))


def build_flow(hp: FlowHyperParams, robot, dim_cond: Optional[int] = None) -> GlowFlow:
    """The flow for ``robot``; ``dim_cond`` is 8 with softflow, else 7."""
    if dim_cond is None:
        dim_cond = 8 if hp.softflow_enabled else 7
    return GlowFlow(hp, robot.actuated_joints_limits, dim_cond)
