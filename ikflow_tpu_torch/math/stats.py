"""Multiscale MMD between sample sets. Port of ``ikflow_tpu/math/stats.py``.

``mmd_multiscale_ca`` is the ``C**a * ((C + d) / a) ** -a`` kernel family
with caller-given ``c_list``/``a_list`` and a ``reduce`` flag;
``mmd_multiscale`` the rational-quadratic ``a^2 / (a^2 + d)`` kernel over
``bandwidths``.
"""

from __future__ import annotations

from typing import Sequence

import torch

DEFAULT_BANDWIDTHS = (0.2, 0.5, 0.9, 1.3)


def mmd_multiscale_ca(x: torch.Tensor, y: torch.Tensor, c_list: Sequence[float], a_list: Sequence[float],
                      reduce: bool = True) -> torch.Tensor:
    """x, y: (n, d) of equal shape. Kernel ``sum_i C_i**a_i * ((C_i + d) /
    a_i) ** -a_i`` over squared distances d clamped at 0. ``reduce``: the
    mean of ``XX + YY - 2 XY``; else the (n, n) matrix."""
    if x.ndim != 2 or x.shape != y.shape:
        raise ValueError(f"x and y must be (n, d) of one shape, got {tuple(x.shape)}, {tuple(y.shape)}")
    if len(c_list) != len(a_list):
        raise ValueError(f"c_list and a_list differ in length: {c_list}, {a_list}")
    xx, yy, xy = x @ x.T, y @ y.T, x @ y.T
    rx = torch.diagonal(xx)[None, :].expand_as(xx)
    ry = torch.diagonal(yy)[None, :].expand_as(yy)
    dxx = torch.clamp(rx.T + rx - 2.0 * xx, min=0.0)
    dyy = torch.clamp(ry.T + ry - 2.0 * yy, min=0.0)
    dxy = torch.clamp(rx.T + ry - 2.0 * xy, min=0.0)
    out = torch.zeros_like(dxx)
    for c, a in zip(c_list, a_list):
        out = out + (c**a * ((c + dxx) / a) ** -a + c**a * ((c + dyy) / a) ** -a
                     - 2.0 * c**a * ((c + dxy) / a) ** -a)
    return out.mean() if reduce else out


def mmd_multiscale(x: torch.Tensor, y: torch.Tensor, bandwidths: Sequence[float] = DEFAULT_BANDWIDTHS) -> torch.Tensor:
    """x (n, d), y (m, d) -> scalar MMD with the kernel
    ``sum_a a^2 / (a^2 + ||u - v||^2)``."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"x and y must be (n, d) and (m, d), got {tuple(x.shape)}, {tuple(y.shape)}")

    def sq_dists(a, b):
        return (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)

    dxx, dyy, dxy = sq_dists(x, x), sq_dists(y, y), sq_dists(x, y)
    xx, yy, xy = torch.zeros_like(dxx), torch.zeros_like(dyy), torch.zeros_like(dxy)
    for a in bandwidths:
        a2 = a * a
        xx = xx + a2 / (a2 + dxx)
        yy = yy + a2 / (a2 + dyy)
        xy = xy + a2 / (a2 + dxy)
    return xx.mean() + yy.mean() - 2.0 * xy.mean()
