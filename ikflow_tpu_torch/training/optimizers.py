"""Optimizers: adamw / adam / adadelta / ranger, a stepped exponential LR
decay with an optional linear warmup, and value or global-norm gradient
clipping.

Port of ``ikflow_tpu/training/optimizers.py``, which builds them from optax
0.2; this module computes what those optax transformations compute, in
float32:

- the LR of update t (t = 1, 2, ...) is ``schedule(t - 1)``: the schedule is
  read at the count before the increment, so with warmup the first update
  moves nothing;
- ``adamw`` is optax's (weight decay 1e-4 on every parameter), ``adam`` and
  ``adadelta`` (rho 0.9, eps 1e-6) too;
- ``ranger`` is RAdam (betas 0.95 / 0.999, eps 1e-4) under a Lookahead
  (every 6 updates the slow weights move half way to the fast ones and the
  fast ones are reset onto them): ``r * m_hat / (sqrt(v_hat) + eps)`` from
  rho_t >= 5, ``m_hat`` before;
- "norm" clipping scales the gradients by ``c / ||g||`` only when
  ``||g|| >= c``.

An update is two halves, so that a captured CUDA graph can hold the second:
``prepare`` advances the count on the host and fills 0-d tensors on the
parameters' device with what the count decides (the LR, the bias
corrections, RAdam's rectifier and its choice, the Lookahead sync), and
``update`` is device work only, one body for every rule, that reads them.
The choices are selects on the device: a graph replays the same kernels at
every count. ``step`` runs both, from the parameters' ``.grad``.
"""

from __future__ import annotations

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
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# Per rule: the moments it keeps, and the scalars ``prepare`` fills.
_STATE = {"adamw": ("exp_avg", "exp_avg_sq"), "adam": ("exp_avg", "exp_avg_sq"),
          "adadelta": ("square_avg", "acc_delta"), "ranger": ("m", "v")}
_SCALARS = {"adamw": ("neg_lr", "bc1", "bc2"), "adam": ("neg_lr", "bc1", "bc2"), "adadelta": ("neg_lr",),
            "ranger": ("neg_lr", "bc1", "bc2", "r", "rectify", "keep_m_hat", "sync", "slow_step")}

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
    """Updates ``params`` in place: clip, then the optimizer's rule at the
    scheduled LR. ``count`` is the number of updates made; ``state_dict`` /
    ``load_state_dict`` carry it and the moments (``load_state_dict`` copies
    into the tensors the optimizer holds, whose addresses a captured update
    reads)."""

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
        device = self.params[0].device if self.params else torch.device("cpu")
        self._scalars = {k: torch.zeros((), dtype=torch.float32, device=device) for k in _SCALARS[name]}
        with torch.no_grad():
            self._state = {k: [torch.zeros_like(p) for p in self.params] for k in _STATE[name]}
            if name == "ranger":
                self._state["slow"] = [p.detach().clone() for p in self.params]

    @property
    def learning_rate(self) -> float:
        """The LR the next update applies."""
        return self.schedule(self.count)

    def prepare(self) -> None:
        """The host's half of an update: advance the count and fill the
        scalars ``update`` reads (float32, as optax computes them)."""
        lr = self.schedule(self.count)
        self.count += 1
        t = _f32(self.count)
        values = {"neg_lr": -lr}
        if self.name != "adadelta":
            b1, b2 = RANGER_BETAS if self.name == "ranger" else ADAM_BETAS
            b2t = _f32(b2) ** t
            values.update(bc1=_f32(1) - _f32(b1) ** t, bc2=_f32(1) - b2t)
        if self.name == "ranger":
            rho_inf = _f32(2.0 / (1.0 - RANGER_BETAS[1]) - 1.0)
            rho = rho_inf - _f32(2) * t * b2t / (_f32(1) - b2t)
            rectify = bool(rho >= RADAM_THRESHOLD)
            sync = self.count % LOOKAHEAD_SYNC_PERIOD == 0
            r = np.sqrt((rho - 4) * (rho - 2) * rho_inf / ((rho_inf - 4) * (rho_inf - 2) * rho)) if rectify else 1.0
            values.update(r=r, rectify=float(rectify), keep_m_hat=float(not rectify), sync=float(sync),
                          slow_step=LOOKAHEAD_SLOW_STEP * float(sync))
        for k, v in values.items():
            self._scalars[k].fill_(float(v))

    @torch.no_grad()
    def _clip(self, grads: List[torch.Tensor]) -> None:
        c = self.gradient_clip
        if c is None:
            return
        if self.gradient_clip_algorithm == "value":
            torch._foreach_clamp_min_(grads, -c)
            torch._foreach_clamp_max_(grads, c)
            return
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < c
        # g / ||g|| * c where ||g|| >= c, else g / 1 * 1 (exactly g)
        torch._foreach_div_(grads, torch.where(keep, torch.ones_like(norm), norm))
        torch._foreach_mul_(grads, torch.where(keep, torch.ones_like(norm), torch.full_like(norm, c)))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """The device's half of an update: ``grads`` (clipped in place) move
        the parameters by the rule at the scalars ``prepare`` filled. No host
        value and no branch on the count: a CUDA graph may capture it."""
        grads = list(grads)
        self._clip(grads)
        s, state = self._scalars, self._state
        if self.name == "adadelta":
            e_g, e_x = state["square_avg"], state["acc_delta"]
            torch._foreach_mul_(e_g, ADADELTA_RHO)
            torch._foreach_addcmul_(e_g, grads, grads, value=1 - ADADELTA_RHO)
            u = torch._foreach_add(e_x, ADADELTA_EPS)
            torch._foreach_sqrt_(u)
            den = torch._foreach_add(e_g, ADADELTA_EPS)
            torch._foreach_sqrt_(den)
            torch._foreach_div_(u, den)
            torch._foreach_mul_(u, grads)
            torch._foreach_mul_(e_x, ADADELTA_RHO)
            torch._foreach_addcmul_(e_x, u, u, value=1 - ADADELTA_RHO)
        else:
            ranger = self.name == "ranger"
            m, v = (state["m"], state["v"]) if ranger else (state["exp_avg"], state["exp_avg_sq"])
            (b1, b2), eps = (RANGER_BETAS, RANGER_EPS) if ranger else (ADAM_BETAS, ADAM_EPS)
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
            u = torch._foreach_div(m, s["bc1"])  # m_hat
            den = torch._foreach_div(v, s["bc2"])  # v_hat
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            if ranger:
                # Rectified: r * m_hat / (sqrt(v_hat) + eps), else m_hat; the
                # select is rect * rectify + m_hat * keep_m_hat with flags 1
                # and 0 (r = 1 before rectifying, so both terms are finite).
                # (A foreach add of a 0-d tensor cannot be captured on the card.)
                rect = torch._foreach_mul(u, s["r"])
                torch._foreach_div_(rect, den)
                torch._foreach_mul_(rect, s["rectify"])
                torch._foreach_mul_(u, s["keep_m_hat"])
                torch._foreach_add_(u, rect)
            else:
                torch._foreach_div_(u, den)
            if self.name == "adamw":
                torch._foreach_add_(u, self.params, alpha=ADAMW_WEIGHT_DECAY)
        torch._foreach_mul_(u, s["neg_lr"])
        torch._foreach_add_(self.params, u)
        if self.name == "ranger":
            # Lookahead: slow += 0.5 * (fast - slow), then fast += (slow - fast),
            # each times the sync flag (0 between syncs: both stay).
            slow = state["slow"]
            d = torch._foreach_sub(self.params, slow)
            torch._foreach_mul_(d, s["slow_step"])
            torch._foreach_add_(slow, d)
            d = torch._foreach_sub(slow, self.params)
            torch._foreach_mul_(d, s["sync"])
            torch._foreach_add_(self.params, d)

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (clipped in place)."""
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise ValueError("every parameter needs a .grad before step()")
        self.prepare()
        self.update(grads)

    def state_dict(self) -> Dict:
        """``{"name", "count", "m", "v", "slow"}`` for ranger; for the others
        ``{"name", "count", "core"}``, "core" in ``torch.optim``'s layout of
        the same rule (per parameter index its "step" and moments)."""
        out = {"name": self.name, "count": self.count}
        if self.name == "ranger":
            return dict(out, **self._state)
        per_param = {i: {"step": torch.tensor(float(self.count)), **{k: ts[i] for k, ts in self._state.items()}}
                     for i in range(len(self.params))} if self.count else {}
        return dict(out, core={"state": per_param,
                               "param_groups": [{"lr": self.learning_rate, "params": list(range(len(self.params)))}]})

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        if state["name"] != self.name:
            raise ValueError(f"optimizer state is for {state['name']!r}, not {self.name!r}")
        self.count = int(state["count"])
        for k, mine in self._state.items():
            if self.name == "ranger":
                theirs = state[k]
            else:  # torch.optim keeps no state before the first update
                per_param = state["core"]["state"]
                theirs = [per_param[i][k] if i in per_param else torch.zeros_like(a) for i, a in enumerate(mine)]
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
