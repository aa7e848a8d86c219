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

from typing import Callable, Dict, Optional, Tuple

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


def make_loss_fn(flow: GlowFlow, ndof: int) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """``loss_fn(params, q, poses, generator=None, noise=None) -> (loss,
    metrics)``: the draws come from ``generator`` unless ``noise`` gives
    them. The metrics are tensors on the batch's device."""
    hp = flow.hp
    pad_width = flow.D - ndof

    def draw(q: torch.Tensor, generator: torch.Generator) -> Noise:
        pad = c = v = None
        if pad_width > 0:
            pad = 0.001 * torch.randn((q.shape[0], pad_width), generator=generator, device=q.device, dtype=q.dtype)
        if hp.softflow_enabled:
            c, v = get_softflow_noise(q.new_empty((q.shape[0], flow.D)), hp.softflow_noise_scale, generator)
        return pad, c, v

    def loss_fn(params, q: torch.Tensor, poses: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[Noise] = None):
        if noise is None:
            if generator is None:
                raise ValueError("pass a generator or the noise")
            noise = draw(q, generator)
        pad, c, v = noise
        x = q
        if pad_width > 0:
            if hp.sigmoid_on_output:
                eps = 1e-5
                pad = torch.clamp(pad, -SIGMOID_SCALING_ABS_MAX + eps, SIGMOID_SCALING_ABS_MAX - eps)
            x = torch.cat([x, pad], dim=1)
        cond = poses
        if hp.softflow_enabled:
            x = x + v
            cond = torch.cat([poses, c], dim=1)
        z, logdet = flow.forward(params, x, cond)
        loss = torch.mean(0.5 * torch.sum(z * z, dim=1) - logdet)
        zd = z.detach()
        metrics = {
            "tr/output_max": zd.max(),
            "tr/output_abs_ave": zd.abs().mean(),
            "tr/output_ave": zd.mean(),
            "tr/output_std": zd.std(correction=0),
            "tr/loss_ml": loss.detach(),
        }
        return loss, metrics

    return loss_fn
