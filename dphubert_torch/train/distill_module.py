"""The joint distillation + pruning train step (the TPU package's
``train/distill_module.py``; reference ``lightning.py:142-305``).

One step =
  teacher ``extract_features`` (frozen: under ``torch.no_grad()``, no
  dropout)
  + student ``extract_features`` (dropout on, HardConcrete gates sampled
  from the state's generator)
  + per-layer projections -> distill loss (L1 + cosine by default)
  + Lagrangian sparsity loss  λ1·(s−t) + λ2·(s−t)²  where
      s = 1 − expected_model_size / teacher_size (differentiable through the
      gates' l0 norms) and t warms linearly to the target
  + one update of the three-group AdamW (``optim.py``), in place.

Entry points: ``init_train_state``, ``make_train_step`` and
``make_eval_step`` (and ``make_grad_fn``, the step without its update).
The state's student is a copy of the given module, and every one of its
parameters trains, ``dummy_weight`` included, as every leaf of the TPU
package's parameter tree does (ROADMAP queue 3).  ``remat`` checkpoints
each of the student's encoder layers (``components.remat_layer``); the
teacher runs under ``no_grad`` and keeps nothing to checkpoint.  The TPU
package's ``scan_layers`` shrank its compiled program and has no
counterpart in eager PyTorch.

``make_train_step(..., steps_per_call=K)`` is the TPU package's K steps in
one dispatch (its ``lax.scan``): on the CPU K eager steps, on the card one
CUDA graph of K whole steps per (batch shape, lengths present,
accumulation phase), replayed with each step's scalars (``step_scalars``)
copied in beside the batch.  With ``remat`` each captured recompute draws
its forward's numbers from a generator of its own, which every replay sets
(``components.RematReplay``).

Parallel (``parallel/``): ``init_train_state(..., mesh=...)`` places the
state on a (data x model) mesh (``sharding.shard_train_state``: rank 0's
parameters everywhere, the heads and FFN units split over the model
group; with ``fsdp=True`` every large leaf also split over the data group,
``parallel/fsdp.py``), and ``make_grad_fn`` / ``make_train_step(...,
mesh=...)`` average the gradients (and the metrics, in the same buffer)
over the data group between the backward and the optimizer, one flat
buffer per dtype: an explicit all-reduce, since ``autograd.grad`` fires
none of DDP's hooks, and one that a K-step CUDA graph captures over NCCL
(its communicator is made by the key's eager first group, before the
capture).  An FSDP leaf's gradient comes out of ``autograd.grad`` already
averaged, as its block (the reduce-scatter of ``comm.full``), and stays out
of that buffer.  Over gloo on the card K > 1 is refused: gloo's
collectives cannot be captured.  ``grad_norm`` and the clip take the
one-card norm (``optim.global_norm``).  A teacher split over the data group
(``fsdp.shard_module``) gathers each weight where it reads it.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.components import RematReplay, remat_replay
from ..models.gates import has_gates, sample_gates
from ..models.model import Wav2Vec2Model, resolve_device
from ..models.size import model_size
from ..ops import kernel_launches
from ..parallel.comm import all_reduce_grads, full, full_numel
from ..parallel.sharding import Block, narrow, shard_train_state
from ..params import flatten_params, unflatten_params
from ..utils.profiling import span
from .losses import distill_loss_unstacked
from .optim import DistillOptimizer, OptState, global_norm
from .projections import flatten_groups, init_projections


@dataclass(frozen=True)
class DistillConfig:
    """Static training configuration (a copy of the TPU package's)."""

    distill_mode: str = "layer2layer"
    distill_layer_groups: Tuple[Tuple[int, ...], ...] = ((0,), (4, 8, 12))
    l2_weight: float = 0.0
    l1_weight: float = 1.0
    cos_weight: float = 1.0
    cos_type: str = "raw"
    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    warmup_updates: int = 15000
    max_updates: int = 50000
    clip_norm: float = 10.0
    use_reg: bool = True
    reg_learning_rate: float = 0.02
    target_sparsity: float = 0.75
    sparsity_warmup_updates: int = 5000
    compute_dtype: str = "float32"  # "bfloat16" on the card
    remat: bool = False  # per-layer activation checkpointing for the student
    accum_grad: int = 1  # micro-batch accumulation (reference --accum_grad)


@dataclass
class TrainState:
    """Everything a step reads and updates in place: the student module,
    the projection and λ parameters, the optimizer state, the micro-step
    counter and the generator of the gates and dropout (on the device).
    On a mesh (``mesh``), ``shards`` holds the ``Block`` of every split
    parameter by name; the other parameters are whole on every rank."""

    student: Wav2Vec2Model
    projs: dict
    lambdas: Optional[dict]
    opt_state: OptState
    step: int
    generator: torch.Generator
    mesh: Optional[object] = None
    shards: Dict[str, Block] = field(default_factory=dict)

    def named_params(self) -> Dict[str, torch.Tensor]:
        """Training parameters by dotted name: ``student.<state-dict key>``,
        ``projs.groups.<g>.weight``, ``lambdas.lambda1``."""
        out = {f"student.{k}": p for k, p in self.student.named_parameters()}
        out.update(flatten_params(self.projs, prefix="projs."))
        if self.lambdas is not None:
            out.update(flatten_params(self.lambdas, prefix="lambdas."))
        return out

    @torch.no_grad()
    def load_params(self, flat: Dict[str, torch.Tensor]) -> None:
        """Copy parameters in, by the names of ``named_params`` (all of
        them: e.g. ``params.train_params_from_jax``), at one-card shapes: a
        split parameter takes its block."""
        own = self.named_params()
        if set(own) != set(flat):
            raise KeyError(f"parameter names differ: {sorted(set(own) ^ set(flat))[:8]}")
        for name, p in own.items():
            t = torch.as_tensor(flat[name])
            if name in self.shards:
                t = narrow(self.shards[name], t)
            p.copy_(t.to(p.device, p.dtype))


def init_train_state(
    *,
    student: Wav2Vec2Model,
    cfg: DistillConfig,
    teacher_embed_dim: int,
    seed: int = 0,
    device="cuda",
    mesh=None,
    fsdp: bool = False,
    projs: Optional[dict] = None,
) -> Tuple[TrainState, DistillOptimizer]:
    """A fresh state on ``device`` and its optimizer.

    The student is copied (the caller's module, which may share weights
    with the teacher, is left alone); λ1 = λ2 = 0; the projections are
    ``projs`` (warm-started, on ``device``) or initialised from ``seed``
    (the identity for layer2layer; drawn either way), and the
    state's generator on the device is seeded from the same seed (so every
    rank of a mesh draws the same gates and masks).  With a ``mesh`` the
    state is placed on it (``parallel.sharding.shard_train_state``; with
    ``fsdp``, its leaves of at least ``fsdp.MIN_SHARD_ELEMS`` elements split
    over the data group too)."""
    device = resolve_device(device)
    host_gen = torch.Generator().manual_seed(seed)
    student = copy.deepcopy(student).to(device)
    for p in student.parameters():
        p.requires_grad_(True)
    fresh = init_projections(
        cfg.distill_mode, cfg.distill_layer_groups, student.spec.embed_dim,
        teacher_embed_dim, generator=host_gen, device=device,
    )
    projs = fresh if projs is None else projs
    for p in flatten_params(projs).values():
        p.requires_grad_(True)
    lambdas = None
    if cfg.use_reg:
        lambdas = {name: torch.zeros((), device=device, requires_grad=True)
                   for name in ("lambda1", "lambda2")}
    generator = torch.Generator(device=device).manual_seed(
        int(torch.randint(0, 2**62, (1,), generator=host_gen))
    )
    tx = DistillOptimizer(
        learning_rate=cfg.learning_rate,
        weight_decay=cfg.weight_decay,
        warmup_updates=cfg.warmup_updates,
        max_updates=cfg.max_updates,
        clip_norm=cfg.clip_norm,
        use_reg=cfg.use_reg,
        reg_learning_rate=cfg.reg_learning_rate,
        accum_grad=cfg.accum_grad,
    )
    state = TrainState(student, projs, lambdas, None, 0, generator)
    state.opt_state = tx.init(state.named_params())
    if mesh is not None:
        shard_train_state(state, mesh, tx, fsdp)
    return state, tx


def update_count(cfg: DistillConfig, step: int) -> int:
    """Optimizer-update count for a micro-step counter: with
    ``accum_grad > 1`` one update every ``accum_grad`` micro-steps, and
    every schedule runs on updates (the reference counts optimizer steps)."""
    return step // max(cfg.accum_grad, 1)


def _target_sparsity(cfg: DistillConfig, step: int) -> float:
    """Linear warmup of the sparsity target over optimizer updates, in
    float32 as the TPU package."""
    frac = min(np.float32(update_count(cfg, step)) / np.float32(max(cfg.sparsity_warmup_updates, 1)),
               np.float32(1.0))
    return float(np.float32(cfg.target_sparsity) * frac)


def step_scalars(cfg: DistillConfig, tx: DistillOptimizer, step: int, count: int) -> np.ndarray:
    """The host scalars micro-step ``step`` reads, float32: the sparsity
    target, then ``tx.scalars(count)`` (``optim.SCALARS``) for the update
    count before the step."""
    return np.concatenate([np.array([_target_sparsity(cfg, step)], np.float32),
                           tx.scalars(count)])


def _on_device(values: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``: an asynchronous copy from pageable
    memory (no wait for the card; the source is staged before the call
    returns)."""
    return torch.from_numpy(values).to(device, non_blocking=True)


def _teacher_numel(teacher: Wav2Vec2Model) -> int:
    """Teacher size = raw parameter count, ``dummy_weight`` included
    (reference ``lightning.py:170``); of the whole teacher where FSDP
    splits it."""
    return sum(full_numel(p) for p in teacher.parameters())


def _batch(batch, dtype: torch.dtype, device):
    waveforms, lengths = batch
    wave = torch.as_tensor(waveforms).to(device)
    if wave.dtype == torch.int16:
        # int16 PCM feed: exactly the float32 the decoder would produce
        wave = wave.float() / 32768.0
    wave = wave.to(dtype)
    if lengths is not None:
        lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
    return wave, lengths


def _distill_forward(teacher, student, cfg, original, params, batch, target, generator,
                     training, gates):
    """Shared forward for train and eval: returns (loss, metrics)."""
    wave, lengths = _batch(batch, getattr(torch, cfg.compute_dtype),
                           student.feature_extractor.dummy_weight.device)
    with torch.no_grad():
        teacher_hiddens, _ = teacher.extract_features(wave, lengths)
    student_hiddens, _ = student.extract_features(
        wave, lengths, gates=gates, training=training, generator=generator, remat=cfg.remat,
    )
    loss_d, (l_mse, l_l1, l_cos) = distill_loss_unstacked(
        params["projs"], cfg.distill_mode, cfg.distill_layer_groups,
        student_hiddens, teacher_hiddens, flatten_groups(cfg.distill_layer_groups),
        l2_weight=cfg.l2_weight, l1_weight=cfg.l1_weight, cos_weight=cfg.cos_weight,
        cos_type=cfg.cos_type,
    )
    metrics = {"loss_distill": loss_d, "loss_mse": l_mse, "loss_l1": l_l1, "loss_cos": l_cos}
    if cfg.use_reg:
        cur_size = model_size(params["student"], student.spec)
        s = 1.0 - cur_size / original
        t = target
        lam1, lam2 = params["lambdas"]["lambda1"], params["lambdas"]["lambda2"]
        loss_reg = lam1 * (s - t) + lam2 * (s - t).square()
        metrics.update(loss_reg=loss_reg, sparsity_expected=s, sparsity_target=t,
                       lambda1=lam1, lambda2=lam2)
        loss = loss_d + loss_reg
    else:
        loss = loss_d
    metrics["loss"] = loss
    return loss, metrics


def param_tree(state: TrainState) -> dict:
    """The parameters the step reads outside the student's modules: the
    gates' ``log_alpha`` and the projections, gathered where FSDP splits
    them (``comm.full``); the student's other leaves as they are, read by
    their modules."""
    student = {n: full(p) if n.endswith("log_alpha") else p
               for n, p in state.student.named_parameters()}
    return {"student": unflatten_params(student),
            "projs": unflatten_params({n: full(p) for n, p in flatten_params(state.projs).items()}),
            "lambdas": state.lambdas}


def _check_mesh(state: TrainState, mesh) -> None:
    if state.mesh is not mesh:
        raise ValueError("the step's mesh is not the state's: pass the mesh the state was "
                         "initialised on (init_train_state(..., mesh=...))")


def make_grad_fn(teacher: Wav2Vec2Model, cfg: DistillConfig, mesh=None):
    """``grad_fn(state, batch, *, gate_u=None) -> (metrics, grads)``: the
    loss, its metrics and the gradient of every training parameter (by the
    names of ``TrainState.named_params``), without touching the state: the
    step's forward and backward, the gradient of the TPU package's
    ``loss_fn``.

    ``batch`` is ``(waveforms (B, T), lengths (B,) or None)``, float or
    int16 PCM, numpy or tensors.  Metrics are 0-dim tensors on the device
    (no host sync): the distill terms, the sparsity terms and the λs, the
    loss and the gradient's global norm ``grad_norm``.  ``gate_u`` injects
    the gates' uniform draws, a tree of the gates' layout (the tests hand
    the TPU package's draws in); otherwise they come from the state's
    generator.  Gates stay differentiable in ``log_alpha``.  ``target`` is
    the sparsity target as a 0-dim tensor on the device (by default made
    from ``state.step``).

    On a ``mesh`` (the state's) ``batch`` holds this data rank's rows; the
    gradients and the metrics are averaged over the data group, and
    ``grad_norm`` is the one-card norm of the averaged gradients."""
    original = float(_teacher_numel(teacher))

    def grad_fn(state: TrainState, batch, *, gate_u: Optional[dict] = None,
                target: Optional[torch.Tensor] = None):
        _check_mesh(state, mesh)
        student = state.student
        params = param_tree(state)
        if target is None:
            target = _on_device(np.array(_target_sparsity(cfg, state.step), np.float32),
                                student.feature_extractor.dummy_weight.device)
        gates = None
        if has_gates(student.spec):
            gates = sample_gates(student.spec, params["student"], state.generator, u=gate_u)
        loss, metrics = _distill_forward(
            teacher, student, cfg, original, params, batch, target, state.generator,
            True, gates,
        )
        named = state.named_params()
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(named.items(), grads)}
        metrics = {k: v.detach().clone() for k, v in metrics.items()}
        over = None
        if mesh is not None:
            # an FSDP block's gradient is already the data average (comm.full)
            whole = {n: g for n, g in grads.items()
                     if n not in state.shards or state.shards[n].data_dim is None}
            reduced = all_reduce_grads({**whole, **{f"metrics/{k}": v for k, v in metrics.items()}},
                                       mesh.data_group, mesh.n_data)
            grads = {n: reduced.get(n, g) for n, g in grads.items()}
            metrics = {k: reduced[f"metrics/{k}"] for k in metrics}
            over = [state.shards[n].groups(mesh) if n in state.shards else () for n in grads]
        metrics["grad_norm"] = global_norm(list(grads.values()), over)
        return metrics, grads

    return grad_fn


def make_train_step(teacher: Wav2Vec2Model, cfg: DistillConfig, tx: DistillOptimizer, *,
                    steps_per_call: int = 1, mesh=None):
    """The train step ``step(state, batch, *, gate_u=None) -> (state,
    metrics)``: ``make_grad_fn``'s gradients, then one micro-step of ``tx``
    (an update every ``accum_grad`` micro-steps), in place.  Metrics hold
    the λs from before the update.  Each step reads its scalars
    (``step_scalars``) from a tensor on the device.

    ``steps_per_call=K > 1`` returns ``step(state, batch) -> (state,
    metrics)`` for K micro-steps: ``batch`` is ``(waveforms (K, B, T),
    lengths (K, B) or None)`` and every metric comes back stacked ``(K,)``
    in float32, as the TPU package's multi-step.  On the CPU it runs the K
    steps eagerly; on the card see ``GraphedSteps``.  ``mesh``: the state's
    (``make_grad_fn``)."""
    grad_fn = make_grad_fn(teacher, cfg, mesh)

    def one(state: TrainState, batch, scalars: torch.Tensor, gate_u=None):
        metrics, grads = grad_fn(state, batch, gate_u=gate_u, target=scalars[0])
        tx.step(grads, state.opt_state, state.named_params(), scalars[1:])
        state.step += 1
        return metrics

    if steps_per_call == 1:
        def step(state: TrainState, batch, *, gate_u: Optional[dict] = None):
            scalars = _on_device(step_scalars(cfg, tx, state.step, state.opt_state.count),
                                 state.student.feature_extractor.dummy_weight.device)
            return state, one(state, batch, scalars, gate_u)

        return step
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    return GraphedSteps(one, cfg, tx, steps_per_call, mesh)


def refuse_gloo_graphs(mesh, steps_per_call: int, device) -> None:
    """Raise for K > 1 on the card over a gloo mesh: gloo's collectives
    cannot be captured in a CUDA graph (NCCL's can)."""
    if (steps_per_call > 1 and mesh is not None and torch.device(device).type == "cuda"
            and mesh.backend() == "gloo"):
        raise ValueError(
            "steps_per_dispatch > 1 on the card needs NCCL: a CUDA graph cannot capture gloo's "
            "collectives; pass --steps_per_dispatch 1 over gloo")


def _plan(cfg: DistillConfig, tx: DistillOptimizer, state: TrainState, k: int) -> np.ndarray:
    """(k, n) float32: the scalars of the next k micro-steps, the host
    counters moved on a copy as the steps will move them."""
    opt = replace(state.opt_state)
    rows = []
    for j in range(k):
        rows.append(step_scalars(cfg, tx, state.step + j, opt.count))
        tx.tick(opt)
    return np.stack(rows)


def _add_counts(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {n: a.get(n, 0) + b.get(n, 0) for n in {**a, **b}}


@dataclass
class _Graph:
    """One captured K-step group and its buffers, allocated outside the
    graphs' pool: the batch and lengths it reads, its scalars, and its
    stacked metrics (one row per metric, one column per step)."""

    graph: Optional["torch.cuda.CUDAGraph"]
    wave: torch.Tensor
    lengths: Optional[torch.Tensor]
    scalars: torch.Tensor
    out: Optional[torch.Tensor] = None
    launches: Optional[Dict[str, int]] = None  # kernel launches a replay runs
    remat: Optional[RematReplay] = None  # the recomputes' generators (remat)


class GraphedSteps:
    """K micro-steps per call (``make_train_step(..., steps_per_call=K)``).

    On the CPU, K eager steps.  On the card, one ``torch.cuda.CUDAGraph`` of
    K whole steps (teacher forward, student forward, ``autograd.grad``, the
    optimizer) per key (batch shape and dtype, lengths present, the
    accumulation phase at the group's start, on which the optimizer's host
    branch depends):

    * the first group of a key runs eagerly on the capture stream (it
      trains, and it builds the kernels and sets their attributes), then
      the group is captured; capture moves no state: ``state.step``, the
      update count, the phase and the generator are checked unchanged;
    * the state's generator is registered with every graph, so each replay
      draws fresh gates, dropout masks and kernel seeds from the offset the
      generator holds at that replay; with ``remat``, so is one generator
      for each checkpointed layer's recompute, set before each replay to
      draw what its forward drew (``components.RematReplay``, filled from
      the eager group);
    * every graph allocates from one shared pool: the groups replay one at
      a time on one stream, and each graph's last operations copy its
      metrics into its own buffer outside the pool;
    * a replay copies the batch (already on the card) and the K steps'
      scalars into the graph's buffers on the compute stream, so the next
      batch's host-to-card copy never writes a buffer a replay reads.

    A failed capture or replay raises: there is no eager fallback.  The
    kernels' launch counters are Python attributes, so they count the
    capture, which runs nothing, and not the replays.  The class keeps the
    tally that sets this right, over every instance: ``captured`` (the
    counts taken at captures) and ``replayed`` (each replay adds its
    graph's), by kernel name, and ``replays``; the counters minus
    ``captured`` plus ``replayed`` are the launches that ran
    (``reset_tally`` zeroes it).  ``before_capture``, if set, is called
    before each capture: a capture forbids other threads' unsafe CUDA calls
    (the background saver's pinned copy), so the trainer waits there for a
    save in flight.

    Under a profiler a call's host phases are ranges of the trace
    (``utils.profiling.span``): ``step.plan`` (the batch's casts and the
    steps' scalars uploaded), then ``step.stage`` (the copies into the
    graph's buffers) and ``step.replay``, or ``step.capture`` for a key's
    first group."""

    captured: Dict[str, int] = {}
    replayed: Dict[str, int] = {}
    replays = 0

    @classmethod
    def reset_tally(cls) -> None:
        cls.captured, cls.replayed, cls.replays = {}, {}, 0

    def __init__(self, one, cfg: DistillConfig, tx: DistillOptimizer, k: int, mesh=None):
        self.one, self.cfg, self.tx, self.k, self.mesh = one, cfg, tx, k, mesh
        self.graphs: Dict[tuple, _Graph] = {}
        self.names: Optional[Tuple[str, ...]] = None
        self.pool = None
        self.stream = None
        self.before_capture = None

    def _run(self, state: TrainState, g: _Graph) -> None:
        """The K steps on ``g``'s buffers, metrics into ``g.out``."""
        for j in range(self.k):
            lengths = None if g.lengths is None else g.lengths[j]
            metrics = self.one(state, (g.wave[j], lengths), g.scalars[j])
            if self.names is None:
                self.names = tuple(metrics)
            if g.out is None:
                g.out = torch.empty((len(self.names), self.k), dtype=torch.float32,
                                    device=g.wave.device)
            g.out[:, j] = torch.stack([metrics[n].float() for n in self.names])

    def _metrics(self, out: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: out[i] for i, n in enumerate(self.names)}

    def __call__(self, state: TrainState, batch):
        with span("step.plan"):
            waves, lengths = batch
            device = state.student.feature_extractor.dummy_weight.device
            waves = torch.as_tensor(waves).to(device)
            if lengths is not None:
                lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
            if waves.shape[0] != self.k:
                raise ValueError(f"a group of {self.k} steps needs a stack of {self.k} batches, "
                                 f"got {tuple(waves.shape)}")
            scalars = _on_device(_plan(self.cfg, self.tx, state, self.k), device)
        if device.type != "cuda":
            g = _Graph(None, waves, lengths, scalars)
            self._run(state, g)
            return state, self._metrics(g.out)
        refuse_gloo_graphs(self.mesh, self.k, device)
        key = (tuple(waves.shape), waves.dtype, lengths is None, state.opt_state.mini_step)
        g = self.graphs.get(key)
        if g is None:
            with span("step.capture"):
                return state, self._warm_and_capture(state, key, waves, lengths, scalars)
        with span("step.stage"):
            g.wave.copy_(waves)
            if lengths is not None:
                g.lengths.copy_(lengths)
            g.scalars.copy_(scalars)
            if g.remat is not None:
                g.remat.prepare()
        with span("step.replay"):
            g.graph.replay()
            GraphedSteps.replays += 1
            GraphedSteps.replayed = _add_counts(GraphedSteps.replayed, g.launches)
            state.step += self.k
            for _ in range(self.k):
                self.tx.tick(state.opt_state)
        return state, self._metrics(g.out.clone())

    def _warm_and_capture(self, state: TrainState, key, waves, lengths, scalars):
        """The key's first group: eager on the capture stream (this call's
        training), then its capture; returns the eager group's metrics."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(waves.device)
            self.pool = torch.cuda.graph_pool_handle()
        g = _Graph(None, waves.clone(), None if lengths is None else lengths.clone(),
                   scalars.clone())
        compute = torch.cuda.current_stream(waves.device)
        self.stream.wait_stream(compute)
        replay = RematReplay(state.generator) if self.cfg.remat else None
        with torch.cuda.stream(self.stream), remat_replay(replay):
            self._run(state, g)
        compute.wait_stream(self.stream)
        metrics = self._metrics(g.out.clone())

        if self.before_capture is not None:
            self.before_capture()
        opt = state.opt_state
        before = (state.step, opt.count, opt.mini_step, state.generator.get_state())
        # the eager group moved the phase on by K mod accum_grad: the graph
        # starts in the phase its key's groups start in
        opt.mini_step = key[-1]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        if replay is not None:
            replay.register(graph)
        counted = kernel_launches()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream), \
                    remat_replay(replay):
                self._run(state, g)
        finally:
            state.step, opt.count, opt.mini_step = before[:3]
        if not torch.equal(state.generator.get_state(), before[3]):
            raise RuntimeError("capturing the training steps moved the generator")
        if replay is not None and replay.taken != len(replay.offsets):
            raise RuntimeError(f"the capture checkpointed {replay.taken} layers, its eager "
                               f"group {len(replay.offsets)}")
        g.remat = replay
        g.launches = {n: v - counted[n] for n, v in kernel_launches().items() if v != counted[n]}
        GraphedSteps.captured = _add_counts(GraphedSteps.captured, g.launches)
        g.graph = graph
        self.graphs[key] = g
        return metrics


def make_eval_step(teacher: Wav2Vec2Model, cfg: DistillConfig):
    """Validation step ``eval_step(state, batch, gates) -> metrics``: dropout
    off, the compiled eval gates (``compile_gates``) passed in."""
    original = float(_teacher_numel(teacher))

    @torch.no_grad()
    def eval_step(state: TrainState, batch, gates):
        target = _on_device(np.array(_target_sparsity(cfg, state.step), np.float32),
                            state.student.feature_extractor.dummy_weight.device)
        _, metrics = _distill_forward(
            teacher, state.student, cfg, original, param_tree(state), batch, target,
            None, False, gates,
        )
        return metrics

    return eval_step
