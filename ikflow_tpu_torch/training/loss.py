"""Maximum-likelihood training loss with softflow conditioning and pad noise.

Port of ``ikflow_tpu/training/loss.py``, for one batch (q, poses):

    x    = [q, clip(0.001 * randn(pad))]      (padded to dim_latent_space)
    c    ~ U(0, 1) per row; x += randn_like(x) * c * softflow_noise_scale
    cond = [pose, c]
    z, logdet = flow.forward(x, cond)
    loss = mean(0.5 * ||z||^2 - logdet)

The pad is clipped inside (-SIGMOID_SCALING_ABS_MAX, SIGMOID_SCALING_ABS_MAX)
under the sigmoid head, and the softflow terms apply only with softflow on.
The draws come from a generator, or are passed in as ``noise``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ikflow_tpu_torch.config import SIGMOID_SCALING_ABS_MAX
from ikflow_tpu_torch.flow.model import GlowFlow

# (pad, c, v): the unclipped pad draw 0.001 * randn (n, D - ndof), or None
# when D == ndof; the softflow magnitude c (n, 1) and noise v (n, D), or None
# without softflow.
Noise = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]


def get_softflow_noise(x: torch.Tensor, softflow_noise_scale: float, generator: torch.Generator):
    """(c, v): per-row magnitude c ~ U(0, 1) and noise v = N(0, 1) * c * scale."""
    c = torch.rand((x.shape[0], 1), generator=generator, device=x.device, dtype=x.dtype)
    v = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype) * c * softflow_noise_scale
    return c, v


def output_metrics(z: torch.Tensor, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The ``tr/output_*`` statistics of the latents ``z`` and ``tr/loss_ml``."""
    return {
        "tr/output_max": z.max(),
        "tr/output_abs_ave": z.abs().mean(),
        "tr/output_ave": z.mean(),
        "tr/output_std": z.std(correction=0),
        "tr/loss_ml": loss,
    }


class LossFn:
    """``loss_fn(params, q, poses, generator=None, noise=None) -> (loss,
    metrics)``: the draws come from ``generator`` unless ``noise`` gives
    them. The metrics are tensors on the batch's device. ``draw`` and
    ``latent`` are its two halves, for callers that split a batch (the
    data-parallel step draws over the whole batch and slices the noise)."""

    def __init__(self, flow: GlowFlow, ndof: int):
        self.flow = flow
        self.hp = flow.hp
        self.pad_width = flow.D - ndof

    def draw(self, q: torch.Tensor, generator: torch.Generator) -> Noise:
        pad = c = v = None
        if self.pad_width > 0:
            pad = 0.001 * torch.randn((q.shape[0], self.pad_width), generator=generator, device=q.device,
                                      dtype=q.dtype)
        if self.hp.softflow_enabled:
            c, v = get_softflow_noise(q.new_empty((q.shape[0], self.flow.D)), self.hp.softflow_noise_scale, generator)
        return pad, c, v

    def latent(self, params, q: torch.Tensor, poses: torch.Tensor, noise: Noise):
        """(z, logdet) of the noised, padded batch through the flow."""
        pad, c, v = noise
        x = q
        if self.pad_width > 0:
            if self.hp.sigmoid_on_output:
                eps = 1e-5
                pad = torch.clamp(pad, -SIGMOID_SCALING_ABS_MAX + eps, SIGMOID_SCALING_ABS_MAX - eps)
            x = torch.cat([x, pad], dim=1)
        cond = poses
        if self.hp.softflow_enabled:
            x = x + v
            cond = torch.cat([poses, c], dim=1)
        return self.flow.forward(params, x, cond)

    def __call__(self, params, q: torch.Tensor, poses: torch.Tensor, generator: Optional[torch.Generator] = None,
                 noise: Optional[Noise] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if noise is None:
            if generator is None:
                raise ValueError("pass a generator or the noise")
            noise = self.draw(q, generator)
        z, logdet = self.latent(params, q, poses, noise)
        loss = torch.mean(0.5 * torch.sum(z * z, dim=1) - logdet)
        return loss, output_metrics(z.detach(), loss.detach())


def make_loss_fn(flow: GlowFlow, ndof: int) -> LossFn:
    return LossFn(flow, ndof)
