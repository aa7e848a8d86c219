"""Training loop: the update step, validation, step-based log / eval /
checkpoint cadences, and JSONL metrics.

Port of ``ikflow_tpu/training/trainer.py``:

- ``_step``: loss, ``torch.autograd`` gradients, gradient stats, clipping,
  optimizer and schedule, with the ``tr/*`` metrics;
- ``validate``: for each of ``val_set_size`` test poses, ``samples_per_pose``
  latents through the flow inverse (kernel K1, or K1' with ``bf16_hidden``)
  in one batch, graded unclamped (``val/*``) and clamped to the joint limits
  (``val_clamped/*``);
- ``fit``: host batches, one transfer per step;
- ``fit_on_device``: the train split resident on the device, batch indices
  drawn there, and one host synchronisation per ``steps_per_call`` window.

On a card the three programs of the JAX trainer (its jitted step, its
jitted validation and its scanned window) run as captured CUDA graphs
(``graphs.GraphCache``, one cache per ``fit`` / ``fit_on_device`` call,
emptied when the call returns or raises): ``fit_on_device`` replays one
update step per step, the batch gathered from the resident split inside the
graph; ``fit`` replays the same step with its metrics on host batches copied
into its static inputs; ``validate`` replays the validation (packing, the
flow inverse through K1 or K1', the grading). The batch indices and the
noise are drawn outside the graph in the eager order, and the optimizer's
count-dependent scalars are filled before each replay
(``Optimizer.prepare``), so graph and eager run the same kernels on the same
numbers. A key's first call runs eagerly, its second captures. A capture or
replay error raises: nothing falls back to the eager path. ``use_graphs =
False`` (on a trainer or the class) runs the eager bodies on the card; the
CPU always runs them. Every step is ``_MeshStep``'s programs (without a
mesh, those of one entry taking the whole batch), so a ``mesh`` trainer on
a card captures too: where every entry lies on one card, one graph holds the
whole step; otherwise each card replays its entries' losses and gradients,
and the first entry's card the sum and the update, with the copies across
cards (and the all-reduce across ranks) between the replays.

The training forward runs the plain subnet under autograd (with
``bf16_hidden``, its bf16 plain version, as the JAX package's
``apply_subnet``); TF32 stays off. Every run draws from generators seeded by
``(seed, start_step)``, so a resumed run continues with a fresh stream.
``fit`` and ``fit_on_device`` copy the parameters at entry and leave the
caller's tensors untouched.

With a ``mesh`` (``parallel.mesh``), each step is data-parallel: the noise is
drawn over the whole batch, each mesh entry takes its slice of the batch and
the noise and runs the loss on its card's copy of the parameters (entries
on the first entry's card use its tensors), and each card's gradient,
weighted by its entries' share of the batch, is added on the first entry,
so the sum is the full batch's mean gradient. Under a process group of more
than one process each rank takes its slice of the batch first, and the flat
gradient is all-reduced across ranks. One optimizer update runs on the first
entry; the other cards' replicas are refreshed from it at the next step.
With the resident split each card that holds entries keeps a copy of it.
Validation runs on the first entry.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ikflow_tpu_torch.config import disable_tf32, resolve_device
from ikflow_tpu_torch.evaluation import evaluate_solutions
from ikflow_tpu_torch.flow.model import GlowFlow
from ikflow_tpu_torch.graphs import GraphCache
from ikflow_tpu_torch.robots.chain import KinematicChain
from ikflow_tpu_torch.training.checkpoints import save_checkpoint
from ikflow_tpu_torch.training.common import generator, tree_leaves, tree_map
from ikflow_tpu_torch.training.dataset import IkDataset, iterate_batches
from ikflow_tpu_torch.parallel.mesh import Mesh, process_world, split_bounds
from ikflow_tpu_torch.training.loss import Noise, make_loss_fn, output_metrics
from ikflow_tpu_torch.training.optimizers import Optimizer, make_optimizer

# Generator streams of one seed.
_STREAM_STEPS = 0
_STREAM_BATCHES = 1
# The metrics of a step with metrics and of a validation, in the order their
# programs return them.
STEP_METRICS = ("tr/loss", "tr/output_max", "tr/output_abs_ave", "tr/output_ave", "tr/output_std", "tr/loss_ml",
                "tr/grad_ave", "tr/grad_abs_ave", "tr/grad_max")
VAL_METRICS = tuple(f"{tag}/{m}" for tag in ("val", "val_clamped") for m in (
    "l2_error_mm", "l2_error_mm_max", "angular_error_deg", "angular_error_deg_max", "pct_joint_limits_exceeded",
    "pct_self_colliding"))


@dataclasses.dataclass
class TrainConfig:
    optimizer: str = "adamw"
    learning_rate: float = 1e-4
    batch_size: int = 512
    gamma: float = 0.9795
    step_lr_every: int = 39062  # int(2.5e6 / 64)
    warmup_steps: int = 0  # linear LR ramp; stabilizes deep stacks at large batch
    gradient_clip: float = 1.0
    gradient_clip_algorithm: str = "value"  # "value" | "norm"
    n_steps: int = 20_000
    eval_every: int = 20_000
    log_every: int = 1_000
    checkpoint_every: int = 250_000
    val_set_size: int = 128
    samples_per_pose: int = 100
    seed: int = 0


def grad_stats(grads: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Mean, mean absolute and largest absolute gradient over every element."""
    count = sum(g.numel() for g in grads)
    return {
        "tr/grad_ave": sum(g.sum() for g in grads) / count,
        "tr/grad_abs_ave": sum(g.abs().sum() for g in grads) / count,
        "tr/grad_max": torch.stack([g.abs().max() for g in grads]).max(),
    }


def _apply(optimizer: Optimizer, loss: torch.Tensor, metrics: Dict[str, torch.Tensor], grads,
           with_metrics: bool) -> Dict[str, torch.Tensor]:
    """A step's end: its metrics (only ``tr/loss`` without
    ``with_metrics``), then the optimizer's update (clipping in place)."""
    out = {"tr/loss": loss}
    if with_metrics:
        out.update(metrics)
        out.update(grad_stats(grads))
    optimizer.update(grads)
    return out


def _trainable(params):
    """A copy of ``params`` whose leaves are fresh tensors that need grads."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), params)


def _detached(params):
    return tree_map(lambda t: t.detach(), params)


class Trainer:
    # On a card, run the update step and validation as captured CUDA graphs,
    # over a mesh too; False runs their eager bodies there. The CPU always does.
    use_graphs = True

    def __init__(
        self,
        flow: GlowFlow,
        robot: KinematicChain,
        config: TrainConfig = TrainConfig(),
        log_dir: Optional[str] = None,
        metric_hook: Optional[Callable[[int, Dict], None]] = None,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        disable_tf32()
        self.flow = flow
        self.robot = robot
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.devices[0]
        self.log_dir = log_dir
        self.metric_hook = metric_hook
        self._metrics_file = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._metrics_file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.loss_fn = make_loss_fn(flow, robot.ndof)
        # Which of the noise's (pad, c, v) a step draws: its graph inputs.
        self._noise_slots = (self.loss_fn.pad_width > 0,) + (flow.hp.softflow_enabled,) * 2
        self._graphs: Optional[GraphCache] = None

    def close(self) -> None:
        if self._metrics_file is not None:
            self._metrics_file.close()
            self._metrics_file = None

    def make_optimizer(self, params) -> Optimizer:
        """The configured optimizer over the leaves of ``params``."""
        c = self.config
        return make_optimizer(tree_leaves(params), c.optimizer, c.learning_rate, c.gamma, c.step_lr_every,
                              c.gradient_clip, c.warmup_steps, c.gradient_clip_algorithm)

    # ------------------------------------------------------------------
    def _step(self, params, optimizer: Optimizer, q: torch.Tensor, poses: torch.Tensor,
              generator: Optional[torch.Generator] = None, noise: Optional[Noise] = None,
              with_metrics: bool = True) -> Dict[str, torch.Tensor]:
        """One eager update of ``params`` (leaves that need grads, the
        optimizer's) in place. Returns the ``tr/*`` metrics as tensors, or
        only ``tr/loss`` without ``with_metrics``."""
        if noise is None:
            if generator is None:
                raise ValueError("pass a generator or the noise")
            noise = self.loss_fn.draw(q, generator)
        optimizer.prepare()
        return self._update(params, optimizer, q, poses, noise, with_metrics)

    def _update(self, params, optimizer: Optimizer, q: torch.Tensor, poses: torch.Tensor, noise: Noise,
                with_metrics: bool) -> Dict[str, torch.Tensor]:
        """A step's device work, the body of its graph: loss, gradients, the
        metrics, clipping and the optimizer's update at the scalars its
        ``prepare`` filled."""
        loss, metrics, grads = self.loss_and_grads(params, optimizer.params, q, poses, noise=noise)
        return _apply(optimizer, loss, metrics, grads, with_metrics)

    def _noise_inputs(self, noise: Noise) -> Tuple[torch.Tensor, ...]:
        return tuple(t for t in noise if t is not None)

    def _noise(self, inputs: Sequence[torch.Tensor]) -> Noise:
        it = iter(inputs)
        return tuple(next(it) if drawn else None for drawn in self._noise_slots)

    def _stepper(self, key: tuple, params, optimizer: Optimizer, samples: Optional[torch.Tensor] = None,
                 endpoints: Optional[torch.Tensor] = None, with_metrics: bool = True) -> Callable:
        """One update step, the optimizer's host half included, as
        ``step(*inputs) ->`` the ``STEP_METRICS`` (only ``tr/loss`` without
        ``with_metrics``): ``_MeshStep``'s programs through the run's graphs
        of each card (one program on one device). With the resident split
        (``samples``, ``endpoints``) the inputs are ``(idx, *noise)``, the
        batch gathered inside; else ``(q, poses, *noise)``. The noise is the
        drawn entries of (pad, c, v)."""
        return _MeshStep(self, params, optimizer.params, samples, endpoints).stepper(key, optimizer, with_metrics)

    def _run(self, key: tuple, program: Callable, inputs: Sequence[torch.Tensor],
             optimizer: Optional[Optimizer] = None, device: Optional[torch.device] = None) -> Tuple[torch.Tensor, ...]:
        """``program(*inputs)``, after the optimizer's host half where given:
        through the run's graph of ``key`` on ``device`` (default the
        trainer's) on a card, else eagerly. The key is completed with the
        trainer's devices (the mesh's, in order)."""
        if optimizer is not None:
            optimizer.prepare()
        if self._graphs is None:
            return program(*inputs)
        devices = (self.device,) if self.mesh is None else self.mesh.devices
        return self._graphs.on(self.device if device is None else device).run(key + devices, program, inputs)

    def _new_graphs(self) -> Optional[GraphCache]:
        """A cache for one run's programs, or None where they run eagerly:
        on the CPU or with ``use_graphs`` off. A mesh's first entry holds
        it; the parts of a step on other cards go to its ``on`` caches."""
        if not self.use_graphs or self.device.type != "cuda":
            return None
        return GraphCache(self.device)

    @contextlib.contextmanager
    def graph_scope(self):
        """The captured programs of one run: a fresh cache (None where they
        run eagerly), emptied and dropped when the block returns or raises.
        Its graphs point at the run's parameters, optimizer state and
        resident split, which must outlive the block; ``fit`` and
        ``fit_on_device`` open one for themselves."""
        outer, self._graphs = self._graphs, self._new_graphs()
        try:
            yield self._graphs
        finally:
            if self._graphs is not None:
                self._graphs.clear()
            self._graphs = outer

    def loss_and_grads(self, params, leaves, q: torch.Tensor, poses: torch.Tensor,
                       generator: Optional[torch.Generator] = None, noise: Optional[Noise] = None):
        """(loss, ``tr/output_*`` metrics, gradients w.r.t. ``leaves``) of one
        batch, eagerly: on the trainer's device, or split over its mesh (and
        across ranks) with the full batch's mean gradient on the first entry."""
        if noise is None:
            if generator is None:
                raise ValueError("pass a generator or the noise")
            noise = self.loss_fn.draw(q, generator)
        loss, z, grads = _MeshStep(self, params, leaves).gradients((q, poses) + self._noise_inputs(noise))
        return loss, output_metrics(z, loss), grads

    # ------------------------------------------------------------------
    def _log(self, step: int, metrics: Dict) -> None:
        payload = {k: float(v) for k, v in metrics.items()}
        payload["step"] = step
        if self._metrics_file:
            self._metrics_file.write(json.dumps(payload) + "\n")
            self._metrics_file.flush()
        if self.metric_hook:
            self.metric_hook(step, payload)

    @torch.no_grad()
    def validate(self, params, dataset: IkDataset, generator: Optional[torch.Generator] = None, step: int = 0,
                 latents: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """Grade ``min(val_set_size, n_test)`` test poses with
        ``samples_per_pose`` flow samples each; the latents come from
        ``generator`` unless given, (n_poses * samples_per_pose, D), pose-major.
        Inside a run (``graph_scope``) on a card, through the run's graph of
        these shapes and parameters: one capture serves every later
        validation of the run, the optimizer updating the parameters in
        place."""
        n = min(self.config.val_set_size, dataset.samples_te.shape[0])
        m = self.config.samples_per_pose
        dev = self.device
        poses = torch.as_tensor(np.asarray(dataset.endpoints_te[:n]), dtype=torch.float32, device=dev)
        if latents is None:
            if generator is None:
                raise ValueError("pass a generator or the latents")
            latents = torch.randn((n * m, self.flow.D), generator=generator, device=dev)
        latents = latents.to(dev)
        # The graph reads the parameters where they lie: key it on their addresses too.
        key = ("val", n, m) + tuple(t.data_ptr() for t in tree_leaves(params))
        (values,) = self._run(key, lambda p, z: (self._validation(params, p, z, m),), (poses, latents))
        out = dict(zip(VAL_METRICS, values.cpu().tolist()))
        self._log(step, out)
        return out

    def _validation(self, params, poses: torch.Tensor, latents: torch.Tensor, m: int) -> torch.Tensor:
        """Validation's device work, the body of its graph: the flow inverse
        of ``latents`` at each pose repeated ``m`` times, graded -> the
        ``VAL_METRICS``."""
        flow = self.flow
        poses_t = poses[:, None, :].expand(-1, m, -1).reshape(-1, poses.shape[1])  # each pose m times
        cond = poses_t
        if flow.dim_cond > 7:
            cond = torch.cat([poses_t, poses_t.new_zeros((poses_t.shape[0], flow.dim_cond - 7))], dim=1)
        q, _ = flow.inverse(flow.kernel_params(_detached(params)), latents, cond)
        sols = q[:, : self.robot.ndof]
        out = []
        for s in (sols, self.robot.clamp_to_joint_limits(sols)):
            ev = evaluate_solutions(self.robot, poses_t, s)
            out += [1000.0 * ev.pos_errors.mean(), 1000.0 * ev.pos_errors.max(), torch.rad2deg(ev.rot_errors.mean()),
                    torch.rad2deg(ev.rot_errors.max()), 100.0 * ev.joint_limits_exceeded.float().mean(),
                    100.0 * ev.self_colliding.float().mean()]
        return torch.stack(out)

    def _start(self, params, opt_state, start_step: int):
        """Trainable copies of ``params``, their optimizer (``opt_state``
        loaded when given) and the run's generator on the device. With a
        mesh, the batch must divide over its entries (and ranks)."""
        if self.mesh is not None:
            n_dev = self.mesh.size * process_world()[0]
            if self.config.batch_size % n_dev:
                raise ValueError(f"batch_size ({self.config.batch_size}) must be divisible by the mesh size "
                                 f"({n_dev}) to shard the batch axis")
        params = _trainable(tree_map(lambda t: t.to(self.device), params))
        optimizer = self.make_optimizer(params)
        if opt_state is not None:
            optimizer.load_state_dict(opt_state)
        return params, optimizer, generator(self.device, self.config.seed, _STREAM_STEPS, start_step)

    def _checkpoint(self, checkpoint_dir: str, step: int, params, optimizer: Optimizer) -> None:
        save_checkpoint(checkpoint_dir, step, _detached(params), optimizer.state_dict())

    # ------------------------------------------------------------------
    def fit_on_device(
        self,
        params,
        dataset: IkDataset,
        checkpoint_dir: Optional[str] = None,
        steps_per_call: int = 100,
        opt_state=None,
        time_budget_s: Optional[float] = None,
        start_step: int = 0,
    ):
        """``fit`` with the train split resident on the device: each step
        draws its batch indices there, and the host reads the losses once per
        window of ``steps_per_call`` steps. Logs the last loss and the
        window's mean; eval and checkpoint cadences round to whole windows.
        With ``time_budget_s`` the run stops at the first window end past the
        budget. Returns (params, metrics); ``metrics["step"]`` is the step
        reached."""
        params, optimizer, gen = self._start(params, opt_state, start_step)
        with self.graph_scope():
            cfg, dev = self.config, self.device
            samples = torch.as_tensor(dataset.samples_tr, device=dev)
            endpoints = torch.as_tensor(dataset.endpoints_tr, device=dev)
            n_data = dataset.n_train
            step_fn = self._stepper(("fit_on_device", cfg.batch_size, False), params, optimizer, samples, endpoints,
                                    with_metrics=False)
            batch = samples.new_empty((cfg.batch_size, samples.shape[1]))  # the shape of the noise's draws
            last_metrics: Dict = {}
            step = start_step
            t_start = time.time()
            while step < cfg.n_steps:
                t0 = time.time()
                losses = torch.empty((steps_per_call,), device=dev)
                for i in range(steps_per_call):
                    idx = torch.randint(0, n_data, (cfg.batch_size,), generator=gen, device=dev)
                    noise = self._noise_inputs(self.loss_fn.draw(batch, gen))
                    losses[i] = step_fn(idx, *noise)[0]
                mean_loss, last_loss = torch.stack([losses.mean(), losses[-1]]).cpu().tolist()
                step += steps_per_call
                dt = time.time() - t0
                if not np.isfinite(last_loss):
                    raise ValueError(f"loss is not finite at step {step}: {last_loss}")
                metrics = {
                    "tr/loss": last_loss,
                    "tr/loss_window_mean": mean_loss,
                    "tr/learning_rate": optimizer.learning_rate,
                    "tr/batches_p_sec": steps_per_call / max(dt, 1e-9),
                }
                if step % max(cfg.log_every, steps_per_call) < steps_per_call:
                    self._log(step, metrics)
                last_metrics = metrics
                if cfg.eval_every and step % max(cfg.eval_every, steps_per_call) < steps_per_call:
                    self.validate(params, dataset, gen, step)
                if (checkpoint_dir and cfg.checkpoint_every
                        and step % max(cfg.checkpoint_every, steps_per_call) < steps_per_call):
                    self._checkpoint(checkpoint_dir, step, params, optimizer)
                if time_budget_s is not None and time.time() - t_start > time_budget_s:
                    break
            if checkpoint_dir:
                self._checkpoint(checkpoint_dir, step, params, optimizer)
            return _detached(params), dict(last_metrics, step=step)

    def fit(self, params, dataset: IkDataset, checkpoint_dir: Optional[str] = None, start_step: int = 0,
            opt_state=None):
        """Train from ``start_step`` to ``n_steps`` on host batches; returns
        (params, the last logged metrics with ``step``)."""
        params, optimizer, gen = self._start(params, opt_state, start_step)
        with self.graph_scope():
            cfg, dev = self.config, self.device
            batches = iterate_batches(dataset, cfg.batch_size, [cfg.seed, _STREAM_BATCHES, start_step])
            step_fn = self._stepper(("fit", cfg.batch_size, True), params, optimizer)
            last_metrics: Dict = {}
            t_window = time.time()
            window_steps = 0
            for step in range(start_step, cfg.n_steps):
                q, poses = next(batches)
                q = torch.as_tensor(q, device=dev)
                poses = torch.as_tensor(poses, device=dev)
                noise = self._noise_inputs(self.loss_fn.draw(q, gen))
                metrics = dict(zip(STEP_METRICS, step_fn(q, poses, *noise)))
                window_steps += 1
                if cfg.log_every and step % cfg.log_every == 0:
                    values = torch.stack(list(metrics.values())).cpu().tolist()
                    metrics = dict(zip(metrics, values))
                    if not np.isfinite(metrics["tr/loss"]):
                        raise ValueError(f"loss is not finite at step {step}: {metrics['tr/loss']}")
                    dt = time.time() - t_window
                    metrics["tr/learning_rate"] = optimizer.learning_rate
                    metrics["tr/batches_p_sec"] = window_steps / max(dt, 1e-9)
                    self._log(step, metrics)
                    last_metrics = metrics
                    t_window = time.time()
                    window_steps = 0
                if cfg.eval_every and step > 0 and step % cfg.eval_every == 0:
                    self.validate(params, dataset, gen, step)
                if checkpoint_dir and cfg.checkpoint_every and step > 0 and step % cfg.checkpoint_every == 0:
                    self._checkpoint(checkpoint_dir, step, params, optimizer)
            if checkpoint_dir:
                self._checkpoint(checkpoint_dir, cfg.n_steps, params, optimizer)
            return _detached(params), dict(last_metrics, step=cfg.n_steps)


class _MeshStep:
    """The update step over one run's parameters, as programs of tensors that
    the run's graphs capture (the eager path runs the same programs, so the
    two equal bit for bit). A trainer without a mesh is a mesh of its one
    device and one rank, whose one entry takes the whole batch unweighted:
    its step is the first card's program alone, the unsharded loss, gradients
    and update. Over a mesh the step is data-parallel:

    - per card of the mesh other than the first entry's: its entries' shares
      of the loss, their gradients on the card's replica of the parameters,
      and their latents, into one flat buffer on that card;
    - on the first entry's card: its own entries' (on the parameters
      themselves), plus each other card's buffer copied there; with one
      rank, then the metrics, clipping and the optimizer's update, so that
      where every entry lies on one card this one program is the whole step;
    - with several ranks, the update as a program of its own, after the
      all-reduce of the flat gradient and loss.

    Between the programs run the copies across cards (each replica refreshed
    from the parameters, the step's inputs sent to each card, each card's
    buffer sent to the first) and the all-reduce. With the resident split
    each card gathers its entries' rows from its own copy of it."""

    def __init__(self, trainer: Trainer, params, leaves, samples: Optional[torch.Tensor] = None,
                 endpoints: Optional[torch.Tensor] = None):
        self.trainer = trainer
        self.devices = (trainer.device,) if trainer.mesh is None else trainer.mesh.devices
        self.params, self.leaves = params, list(leaves)
        self.first = self.devices[0]
        self.cards = list(dict.fromkeys(self.devices))  # in the order of their first entry
        self.replicas = {card: _trainable(tree_map(lambda t, c=card: t.to(c), params)) for card in self.cards[1:]}
        self.split = None if samples is None else {c: (samples.to(c), endpoints.to(c)) for c in self.cards}
        self.world, self.rank = (1, 0) if trainer.mesh is None else process_world()
        self._sizes = [t.numel() for t in self.leaves]
        self._layouts: Dict[int, tuple] = {}

    def _layout(self, total: int):
        """For a batch of ``total`` rows (every rank's): per card its entries'
        (index, first row, end row); per other card its buffer and the copy
        of it on the first card; with several ranks, the first card's flat
        gradient and loss and its latents."""
        if total not in self._layouts:
            per_rank = total // self.world
            bounds = [self.rank * per_rank + b for b in split_bounds(per_rank, len(self.devices))]
            entries = {card: [] for card in self.cards}
            for k, card in enumerate(self.devices):
                entries[card].append((k, bounds[k], bounds[k + 1]))
            n_grad, D, dtype = sum(self._sizes), self.trainer.flow.D, self.leaves[0].dtype
            sent = {}
            for card in self.cards[1:]:
                n = n_grad + 1 + D * sum(b - a for _, a, b in entries[card])
                sent[card] = (torch.empty(n, dtype=dtype, device=card), torch.empty(n, dtype=dtype, device=self.first))
            reduced = None
            if self.world > 1:
                reduced = (torch.empty(n_grad + 1, dtype=dtype, device=self.first),
                           torch.empty((per_rank, D), dtype=dtype, device=self.first))
            self._layouts[total] = (entries, sent, reduced)
        return self._layouts[total]

    def _losses(self, card, entries, inputs, total: int):
        """(loss, {entry: latents}, gradients) of ``card``'s entries, on the
        parameters for the first card, else on the card's replica. Each
        entry's loss is weighted by its share of the whole batch (an entry
        that takes the whole batch is not)."""
        tr = self.trainer
        if self.split is None:
            q, poses, *noise = inputs
        else:
            idx, *noise = inputs
        noise = tr._noise(noise)
        params = self.params if card == self.first else self.replicas[card]
        loss, zs = None, {}
        for k, a, b in entries[card]:
            if self.split is None:
                qk, pk = q[a:b], poses[a:b]
            else:
                samples, endpoints = self.split[card]
                qk, pk = samples.index_select(0, idx[a:b]), endpoints.index_select(0, idx[a:b])
            z, logdet = tr.loss_fn.latent(params, qk, pk, tuple(None if t is None else t[a:b] for t in noise))
            term = torch.mean(0.5 * torch.sum(z * z, dim=1) - logdet)
            if b - a != total:
                term = term * ((b - a) / total)
            loss = term if loss is None else loss + term
            zs[k] = z.detach()
        grads = torch.autograd.grad(loss, self.leaves if card == self.first else tree_leaves(params))
        return loss.detach(), zs, grads

    def _card_program(self, card, total: int) -> Callable:
        entries, sent, _ = self._layout(total)

        def program(*inputs):
            loss, zs, grads = self._losses(card, entries, inputs, total)
            sent[card][0].copy_(torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)]
                                          + [zs[k].reshape(-1) for k, _, _ in entries[card]]))
            return ()

        return program

    def _send(self, run: Callable, key: tuple, inputs: Sequence[torch.Tensor], total: int) -> None:
        """Each other card's part of the step through ``run``, between the
        copies that feed it and the copy of its buffer to the first card."""
        _, sent, _ = self._layout(total)
        for card in self.cards[1:]:
            with torch.no_grad():
                for r, p in zip(tree_leaves(self.replicas[card]), self.leaves):
                    r.copy_(p)
            run(key + ("card",), self._card_program(card, total), tuple(x.to(card) for x in inputs), device=card)
            sent[card][1].copy_(sent[card][0])

    def _gathered(self, inputs, total: int):
        """(loss, {entry: latents}, gradients) of this rank's whole batch on
        the first card: its own entries' plus what each other card sent."""
        entries, sent, _ = self._layout(total)
        loss, zs, grads = self._losses(self.first, entries, inputs, total)
        n_grad, D = sum(self._sizes), self.trainer.flow.D
        for card in self.cards[1:]:
            got = sent[card][1]
            grads = tuple(g + p.view_as(g) for g, p in zip(grads, torch.split(got[:n_grad], self._sizes)))
            loss = loss + got[n_grad]
            at = n_grad + 1
            for k, a, b in entries[card]:
                zs[k] = got[at: at + D * (b - a)].view(b - a, D)
                at += D * (b - a)
        return loss, zs, grads

    def _share(self, reduced, loss, zs, grads) -> None:
        flat, z = reduced
        flat.copy_(torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)]))
        z.copy_(torch.cat([zs[k] for k in sorted(zs)]))

    def _reduced(self, reduced):
        flat, z = reduced
        parts = torch.split(flat, self._sizes + [1])
        return parts[-1].reshape(()), {0: z}, tuple(p.view_as(t) for p, t in zip(parts, self.leaves))

    def gradients(self, inputs: Sequence[torch.Tensor]):
        """Eagerly: (loss, latents, gradients) of the full batch (every
        rank's mean) on the first card; inputs ``(q, poses, *noise)``."""
        import torch.distributed as dist

        total = inputs[0].shape[0]
        self._send(lambda key, program, xs, device: program(*xs), (), inputs, total)
        loss, zs, grads = self._gathered(inputs, total)
        reduced = self._layout(total)[2]
        if reduced is not None:
            self._share(reduced, loss, zs, grads)
            dist.all_reduce(reduced[0])
            loss, zs, grads = self._reduced(reduced)
        return loss, torch.cat([zs[k] for k in sorted(zs)]), grads

    def stepper(self, key: tuple, optimizer: Optimizer, with_metrics: bool) -> Callable:
        """``Trainer._stepper``'s step over the mesh, its programs run
        through the trainer's ``_run`` under ``key``."""
        import torch.distributed as dist

        tr = self.trainer

        def finish(loss, zs, grads):
            metrics = output_metrics(torch.cat([zs[k] for k in sorted(zs)]), loss) if with_metrics else {}
            out = _apply(optimizer, loss, metrics, grads, with_metrics)
            return tuple(out[k] for k in STEP_METRICS if k in out)

        def first_program(total, reduced):
            def program(*inputs):
                gathered = self._gathered(inputs, total)
                if reduced is None:
                    return finish(*gathered)
                self._share(reduced, *gathered)
                return ()

            return program

        def step(*inputs):
            optimizer.prepare()
            total = inputs[0].shape[0]
            reduced = self._layout(total)[2]
            self._send(tr._run, key, inputs, total)
            out = tr._run(key + ("first",), first_program(total, reduced), inputs)
            if reduced is None:
                return out
            dist.all_reduce(reduced[0])
            return tr._run(key + ("update",), lambda: finish(*self._reduced(reduced)), ())

        return step
