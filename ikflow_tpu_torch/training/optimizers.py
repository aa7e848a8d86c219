"""Optimizers: adamw / adam / adadelta / ranger, a stepped exponential LR
decay with an optional linear warmup, and value or global-norm gradient
clipping.

Port of ``ikflow_tpu/training/optimizers.py``, which builds them from optax
0.2; this module computes what those optax transformations compute:

- the LR of update t (t = 1, 2, ...) is ``schedule(t - 1)``: the schedule is
  read at the count before the increment, so with warmup the first update
  moves nothing;
- ``adamw`` is optax's (weight decay 1e-4 on every parameter), ``adam`` and
  ``adadelta`` (rho 0.9, eps 1e-6) too: ``torch.optim`` computes the same
  rules, with the LR set before each step;
- ``ranger`` is RAdam (betas 0.95 / 0.999, eps 1e-4) under a Lookahead
  (every 6 updates the slow weights move half way to the fast ones and the
  fast ones are reset onto them). The RAdam step is written here:
  ``torch.optim.RAdam`` puts eps inside the bias correction and rectifies
  only from rho_t > 5, where optax computes ``r * m_hat / (sqrt(v_hat) + eps)``
  from rho_t >= 5;
- "norm" clipping scales the gradients by ``c / ||g||`` only when
  ``||g|| >= c`` (``torch.nn.utils.clip_grad_norm_`` divides by
  ``||g|| + 1e-6`` always).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

OPTIMIZERS = ("adamw", "adam", "adadelta", "ranger")
RANGER_BETAS = (0.95, 0.999)
RANGER_EPS = 1e-4
RADAM_THRESHOLD = 5.0
LOOKAHEAD_SYNC_PERIOD = 6
LOOKAHEAD_SLOW_STEP = 0.5
ADAMW_WEIGHT_DECAY = 1e-4
ADADELTA_RHO = 0.9
ADADELTA_EPS = 1e-6

_f32 = np.float32


def make_lr_schedule(
    learning_rate: float, gamma: float, step_lr_every: int, warmup_steps: int = 0
) -> Callable[[int], float]:
    """count -> LR: ``learning_rate * gamma ** floor(count / step_lr_every)``,
    after a linear 0 -> ``learning_rate`` ramp over ``warmup_steps`` when it
    is positive (the decay then counts from the end of the ramp). Computed in
    float32, as optax computes it."""
    lr = _f32(learning_rate)

    def decay(count: int) -> float:
        if step_lr_every <= 0 or gamma == 0 or count <= 0:
            return float(lr)
        return float(lr * _f32(gamma) ** _f32(np.floor(_f32(count) / _f32(step_lr_every))))

    if warmup_steps <= 0:
        return decay

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            return decay(count - warmup_steps)
        frac = _f32(1) - _f32(min(max(count, 0), warmup_steps)) / _f32(warmup_steps)
        return float(-lr * frac + lr)

    return schedule


class Optimizer:
    """Updates ``params`` in place from their ``.grad``: clip, then the
    optimizer's rule at the scheduled LR. ``count`` is the number of updates
    made; ``state_dict`` / ``load_state_dict`` carry it and the moments."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        name: str = "adamw",
        learning_rate: float = 1e-4,
        gamma: float = 0.9795,
        step_lr_every: int = 39062,
        gradient_clip: Optional[float] = 1.0,
        warmup_steps: int = 0,
        gradient_clip_algorithm: str = "value",
    ):
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name!r}; use adamw|adam|adadelta|ranger")
        if gradient_clip_algorithm not in ("value", "norm"):
            raise ValueError(f"unknown gradient_clip_algorithm {gradient_clip_algorithm!r}; use value|norm")
        self.params: List[torch.Tensor] = list(params)
        self.name = name
        self.schedule = make_lr_schedule(learning_rate, gamma, step_lr_every, warmup_steps)
        self.gradient_clip = gradient_clip
        self.gradient_clip_algorithm = gradient_clip_algorithm
        self.count = 0
        self._core: Optional[torch.optim.Optimizer] = None
        if name == "adamw":
            self._core = torch.optim.AdamW(self.params, lr=learning_rate, weight_decay=ADAMW_WEIGHT_DECAY)
        elif name == "adam":
            self._core = torch.optim.Adam(self.params, lr=learning_rate)
        elif name == "adadelta":
            self._core = torch.optim.Adadelta(self.params, lr=learning_rate, rho=ADADELTA_RHO, eps=ADADELTA_EPS)
        else:
            with torch.no_grad():
                self._m = [torch.zeros_like(p) for p in self.params]
                self._v = [torch.zeros_like(p) for p in self.params]
                self._slow = [p.detach().clone() for p in self.params]

    @property
    def learning_rate(self) -> float:
        """The LR the next update applies."""
        return self.schedule(self.count)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def _clip(self, grads: Sequence[torch.Tensor]) -> None:
        c = self.gradient_clip
        if c is None:
            return
        if self.gradient_clip_algorithm == "value":
            for g in grads:
                g.clamp_(-c, c)
            return
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < c
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * c))

    @torch.no_grad()
    def _radam_step(self, lr: float) -> None:
        b1, b2 = RANGER_BETAS
        t = self.count
        rho_inf = _f32(2.0 / (1.0 - b2) - 1.0)
        b2t = _f32(b2) ** _f32(t)
        rho = rho_inf - _f32(2) * _f32(t) * b2t / (_f32(1) - b2t)
        bc1 = float(_f32(1) - _f32(b1) ** _f32(t))
        bc2 = float(_f32(1) - b2t)
        rectify = bool(rho >= RADAM_THRESHOLD)
        if rectify:
            r = float(np.sqrt((rho - 4) * (rho - 2) * rho_inf / ((rho_inf - 4) * (rho_inf - 2) * rho)))
        for p, m, v in zip(self.params, self._m, self._v):
            g = p.grad
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / bc1
            if rectify:
                update = r * m_hat / (torch.sqrt(v / bc2) + RANGER_EPS)
            else:
                update = m_hat
            p.add_(update, alpha=-lr)

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (clipped in place)."""
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise ValueError("every parameter needs a .grad before step()")
        self._clip(grads)
        lr = self.schedule(self.count)
        self.count += 1
        if self._core is not None:
            for group in self._core.param_groups:
                group["lr"] = lr
            self._core.step()
            return
        self._radam_step(lr)
        if self.count % LOOKAHEAD_SYNC_PERIOD == 0:
            for p, slow in zip(self.params, self._slow):
                slow.add_(p - slow, alpha=LOOKAHEAD_SLOW_STEP)
                p.copy_(slow)

    def state_dict(self) -> Dict:
        if self._core is not None:
            return {"name": self.name, "count": self.count, "core": self._core.state_dict()}
        return {"name": self.name, "count": self.count, "m": self._m, "v": self._v, "slow": self._slow}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        if state["name"] != self.name:
            raise ValueError(f"optimizer state is for {state['name']!r}, not {self.name!r}")
        self.count = int(state["count"])
        if self._core is not None:
            self._core.load_state_dict(copy.deepcopy(state["core"]))  # torch.optim would share the tensors
            return
        for mine, theirs in ((self._m, state["m"]), (self._v, state["v"]), (self._slow, state["slow"])):
            for a, b in zip(mine, theirs):
                a.copy_(b)


def make_optimizer(
    params: Sequence[torch.Tensor],
    name: str = "adamw",
    learning_rate: float = 1e-4,
    gamma: float = 0.9795,
    step_lr_every: int = 39062,
    gradient_clip: Optional[float] = 1.0,
    warmup_steps: int = 0,
    gradient_clip_algorithm: str = "value",
) -> Optimizer:
    """The optimizer ``name`` over ``params``; "value" clips each gradient
    element to +-clip, "norm" rescales the whole gradient when its global L2
    norm exceeds clip."""
    return Optimizer(params, name, learning_rate, gamma, step_lr_every, gradient_clip, warmup_steps,
                     gradient_clip_algorithm)
