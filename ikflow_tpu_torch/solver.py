"""IKFlowSolver: approximate IK from the flow, and exact IK by LM refinement
of flow seeds over widening retry tiers.

Port of ``ikflow_tpu/solver.py`` (``draw_latent``, ``derive_retry_capacities``,
``set_params``, ``generate_ik_solutions``, ``generate_diverse_ik_solutions``,
``generate_exact_ik_solutions``). Randomness comes
from explicit ``torch.Generator``s; each solver owns one, seeded from
``seed``, on its device.

Exact IK keeps the JAX package's fixed shapes: each tier tiles its poses r
times, refines every seed for the full step budget, and keeps the earliest
valid tile per pose. Retry tiers compact the still-invalid poses to the front
with a stable argsort and retry the first ``ceil(capacity * n)`` of them.
Where the JAX package skips a tier with ``lax.cond`` once every pose is
valid, the port asks the host (one synchronisation per tier).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ikflow_tpu_torch.config import disable_tf32, resolve_device
from ikflow_tpu_torch.evaluation import SolutionEvaluation, evaluate_solutions
from ikflow_tpu_torch.flow.model import GlowFlow, build_flow
from ikflow_tpu_torch.flow.params import FlowHyperParams
from ikflow_tpu_torch.lm import refine
from ikflow_tpu_torch.robots.chain import KinematicChain


def draw_latent(
    generator: torch.Generator,
    latent_distribution: str,
    latent_scale: float,
    shape: Tuple[int, int],
    dtype=torch.float32,
) -> torch.Tensor:
    """Gaussian (scaled) or uniform in [-scale, scale] latents on the
    generator's device."""
    if latent_distribution not in ("gaussian", "uniform"):
        raise ValueError(f"unknown latent distribution {latent_distribution!r}")
    if latent_scale <= 0 or len(shape) != 2:
        raise ValueError(f"need latent_scale > 0 and a 2-D shape, got {latent_scale}, {shape}")
    if latent_distribution == "gaussian":
        return latent_scale * torch.randn(shape, generator=generator, device=generator.device, dtype=dtype)
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=dtype)
    return 2.0 * latent_scale * u - latent_scale


def select_diverse(candidates: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of ``n`` of the (m, ndof) candidates by greedy farthest-point
    selection in joint space, seeded with candidate 0: each pick is the first
    candidate of largest distance to the picked set, and a picked candidate's
    distance is set to -inf. A fixed-shape loop on the candidates' device,
    with no host synchronisation per pick."""
    m = candidates.shape[0]
    if not 1 <= n <= m:
        raise ValueError(f"cannot pick {n} of {m} candidates")
    d = torch.linalg.norm(candidates[:, None, :] - candidates[None, :, :], dim=-1)
    chosen = torch.zeros((n,), dtype=torch.long, device=candidates.device)
    min_d = d[0].clone()
    min_d[0] = -math.inf
    for i in range(1, n):
        nxt = torch.argmax(min_d)  # first index of the maximum
        chosen[i] = nxt
        min_d = torch.minimum(min_d, d[nxt]).index_fill_(0, nxt.reshape(1), -math.inf)
    return chosen


def derive_retry_capacities(tier_counts, n_poses: int, n_tiers: int):
    """Per-tier capacity fractions from measured cumulative valid counts of an
    uncapped run: each retry tier covers the misses entering it with 2x
    headroom (at least 32 poses). None (run uncapped) when tier-1 misses more
    than 40% of the poses."""
    caps = [1.0]
    for i in range(1, n_tiers):
        miss = (n_poses - int(tier_counts[i - 1])) / n_poses
        if miss > 0.40:
            return None
        caps.append(min(1.0, max(32, math.ceil(2.0 * miss * n_poses)) / n_poses))
    return tuple(caps)


def retry_indices(valids: torch.Tensor, cap: int) -> torch.Tensor:
    """The first ``cap`` poses after a stable argsort that puts the invalid
    ones first, in their original order."""
    return torch.argsort(valids.to(torch.int8), stable=True)[:cap]


def merge_tier(sols, valids, idx, tier_sols, tier_valid) -> None:
    """First valid wins: pose idx[i] takes tier_sols[i] if it was invalid and
    the tier solved it. Updates ``sols`` and ``valids`` in place."""
    prev = valids[idx]
    take = ~prev & tier_valid
    sols[idx] = torch.where(take[:, None], tier_sols, sols[idx])
    valids[idx] = prev | tier_valid


class IKFlowSolver:
    """Owns the flow, its parameters and the robot; runs inference on ``device``.

    ``device`` defaults to ``"cuda"`` and raises if no card is present; pass
    ``"cpu"`` to run on the CPU.
    """

    def __init__(
        self,
        hyper_parameters: FlowHyperParams,
        robot: KinematicChain,
        params=None,
        seed: int = 0,
        device="cuda",
    ):
        if hyper_parameters.softflow_enabled and hyper_parameters.sigmoid_on_output:
            raise ValueError("sigmoid_on_output and softflow are incompatible, disable one or the other")
        self.device = resolve_device(device)
        disable_tf32()
        self._robot = robot
        self._hp = hyper_parameters
        self.dim_cond = 8 if hyper_parameters.softflow_enabled else 7
        self._flow: GlowFlow = build_flow(hyper_parameters, robot, self.dim_cond)
        self._network_width = hyper_parameters.dim_latent_space
        self.ndof = robot.ndof
        self._weights_loaded = params is not None
        self.weights_version = 0
        # Retry capacities measured by parallel.fleet's "probe" policy, keyed
        # by (weights_version, solve protocol): new weights miss every entry.
        self.capacity_cache: Dict[tuple, tuple] = {}
        if params is None:
            params = self._flow.init(torch.Generator(device=self.device).manual_seed(seed))
        self.params = params
        self._generator = torch.Generator(device=self.device).manual_seed(seed ^ 0x5EED)

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params) -> None:
        # The kernels' copy (packed bf16 hidden weights for a bf16 flow) is
        # rebuilt with every new parameter set, so it can never be stale.
        self._params = params
        self._kernel_params = self._flow.kernel_params(params)
        self.weights_version += 1

    def set_params(self, params) -> None:
        """Install trained parameters and mark the weights loaded."""
        self.params = params
        self._weights_loaded = True

    @property
    def robot(self) -> KinematicChain:
        return self._robot

    @property
    def flow(self) -> GlowFlow:
        return self._flow

    @property
    def hyper_parameters(self) -> FlowHyperParams:
        return self._hp

    @property
    def network_width(self) -> int:
        return self._network_width

    @property
    def conditional_size(self) -> int:
        """7 (the pose), or 8 with softflow's scale column, 0 at inference."""
        return self.dim_cond

    def _check_loaded(self, allow_uninitialized: bool) -> None:
        if not (allow_uninitialized or self._weights_loaded):
            raise RuntimeError(
                "Model weights have not been loaded. Pass params or use allow_uninitialized=True"
            )

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _conditional(self, y: torch.Tensor) -> torch.Tensor:
        if self.dim_cond == 7:
            return y
        pad = torch.zeros((y.shape[0], self.dim_cond - 7), dtype=y.dtype, device=y.device)
        return torch.cat([y, pad], dim=1)

    def _inverse_q(self, latent: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        q, _ = self._flow.inverse(self._kernel_params, latent, cond)
        return q[:, : self.ndof]

    # ------------------------------------------------------------------
    def generate_ik_solutions(
        self,
        y,
        n: Optional[int] = None,
        latent: Optional[torch.Tensor] = None,
        latent_distribution: str = "gaussian",
        latent_scale: float = 1.0,
        clamp_to_joint_limits: bool = True,
        return_detailed: bool = False,
        allow_uninitialized: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """Sample IK solutions for pose(s) ``y``: (7,) with n > 0, or (n, 7).

        Returns (n, ndof) solutions, or with ``return_detailed``
        (solutions, pos_errors, rot_errors, joint_limits_exceeded,
        self_colliding).
        """
        self._check_loaded(allow_uninitialized)
        y = self._tensor(y)
        if y.numel() == 7 and y.ndim <= 1:
            if not (isinstance(n, int) and n > 0):
                raise ValueError("single-pose mode needs n > 0")
            y_batch = y.reshape(1, 7).expand(n, 7).contiguous()
        else:
            if y.ndim != 2 or y.shape[1] != 7:
                raise ValueError(f"y must be (7,) or (n, 7), got {tuple(y.shape)}")
            if n is not None and n != y.shape[0]:
                raise ValueError(f"n={n} does not match {y.shape[0]} poses")
            y_batch, n = y, y.shape[0]

        if latent is None:
            latent = draw_latent(generator or self._generator, latent_distribution, latent_scale,
                                 (n, self._network_width))
        else:
            latent = self._tensor(latent)
            if tuple(latent.shape) != (n, self._network_width):
                raise ValueError(f"latent must be ({n}, {self._network_width}), got {tuple(latent.shape)}")

        solutions = self._inverse_q(latent, self._conditional(y_batch))
        if clamp_to_joint_limits:
            solutions = self._robot.clamp_to_joint_limits(solutions)
        if return_detailed:
            return (solutions, *evaluate_solutions(self._robot, y_batch, solutions))
        return solutions

    # ------------------------------------------------------------------
    def generate_diverse_ik_solutions(
        self,
        y,
        n: int,
        oversample: int = 4,
        latent_scale: float = 1.0,
        generator: Optional[torch.Generator] = None,
        allow_uninitialized: bool = False,
    ) -> torch.Tensor:
        """``n`` clamped solutions (n, ndof) for ONE (7,) pose, picked for
        joint-space diversity: ``n * oversample`` candidates from
        ``generate_ik_solutions``, then ``select_diverse``."""
        self._check_loaded(allow_uninitialized)
        if n < 1 or oversample < 1:
            raise ValueError(f"need n >= 1 and oversample >= 1, got {n}, {oversample}")
        y = self._tensor(y).reshape(7)
        candidates = self.generate_ik_solutions(
            y, n=n * oversample, latent_scale=latent_scale, generator=generator,
            allow_uninitialized=allow_uninitialized,
        )
        return candidates[select_diverse(candidates, n)]

    # ------------------------------------------------------------------
    def generate_exact_ik_solutions(
        self,
        target_poses,
        repeat_counts: Tuple[int, ...] = (1, 3, 10),
        pos_error_threshold: float = 1e-3,
        rot_error_threshold: float = 0.1,
        n_opt_steps_max: int = 3,
        lambd: float = 1e-4,
        latent_scale: float = 0.75,
        generator: Optional[torch.Generator] = None,
        allow_uninitialized: bool = False,
        retry_capacities: Optional[Tuple[float, ...]] = None,
        return_tier_counts: bool = False,
    ):
        """Exact IK: flow seeds + LM refinement + widening retry tiers.

        Returns (solutions (n, ndof), valids (n,) bool), and with
        ``return_tier_counts`` also the cumulative valid count after each tier.
        ``retry_capacities``: per-tier fractions of the poses a tier may retry
        (the first must be 1.0); None retries every still-invalid pose.
        """
        self._check_loaded(allow_uninitialized)
        poses = self._tensor(target_poses)
        if poses.ndim != 2 or poses.shape[1] != 7:
            raise ValueError(f"target_poses must be (n, 7), got {tuple(poses.shape)}")
        n = poses.shape[0]
        repeat_counts = tuple(int(r) for r in repeat_counts)
        if retry_capacities is not None:
            if len(retry_capacities) != len(repeat_counts) or retry_capacities[0] != 1.0:
                raise ValueError(f"retry_capacities {retry_capacities} must match {repeat_counts} and start at 1.0")
        g = generator or self._generator

        sols = torch.zeros((n, self.ndof), dtype=torch.float32, device=self.device)
        valids = torch.zeros((n,), dtype=torch.bool, device=self.device)
        tier_counts = []
        for tier_idx, r in enumerate(repeat_counts):
            if tier_idx > 0 and bool(valids.all()):
                tier_counts.append(valids.sum())
                continue
            cap = n
            if tier_idx > 0 and retry_capacities is not None:
                cap = min(n, max(8, math.ceil(retry_capacities[tier_idx] * n)))
            idx = retry_indices(valids, cap)
            tier_sols, tier_valid = self._solve_tier(
                poses[idx], g, r, pos_error_threshold, rot_error_threshold, n_opt_steps_max, lambd, latent_scale
            )
            merge_tier(sols, valids, idx, tier_sols, tier_valid)
            tier_counts.append(valids.sum())
        if return_tier_counts:
            return sols, valids, torch.stack(tier_counts)
        return sols, valids

    def _solve_tier(self, poses, g, r, pos_tol, rot_tol, n_steps, lambd, latent_scale):
        """One tier: tile the poses r times (tile-major), draw flow seeds,
        refine, and keep the earliest valid tile per pose."""
        n, ndof = poses.shape[0], self.ndof
        poses_tiled = poses.repeat(r, 1)
        latent = latent_scale * torch.randn((r * n, self._network_width), generator=g, device=self.device)
        q0 = self._robot.clamp_to_joint_limits(self._inverse_q(latent, self._conditional(poses_tiled)))
        cap_q, cap_valid, _ = refine(
            self._robot, q0, poses_tiled, n_steps, pos_tol, rot_tol, lambd, restart_generator=g
        )
        cap_q = cap_q.reshape(r, n, ndof)
        cap_valid = cap_valid.reshape(r, n)
        first = torch.argmax(cap_valid.to(torch.int32), dim=0)
        tier_sols = torch.gather(cap_q, 0, first[None, :, None].expand(1, n, ndof))[0]
        return tier_sols, cap_valid.any(dim=0)

    # ------------------------------------------------------------------
    def evaluate(self, target_poses, solutions) -> SolutionEvaluation:
        return evaluate_solutions(self._robot, self._tensor(target_poses), solutions)

    def __repr__(self):
        return (
            f"IKFlowSolver(robot={self._robot.name!r}, width={self._network_width}, "
            f"blocks={self._hp.nb_nodes}, device={self.device}, weights_loaded={self._weights_loaded})"
        )
