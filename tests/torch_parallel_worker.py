"""The tests' rank process: ``python -m tests.torch_parallel_worker <rank
argv>`` runs the harness's jobs (``dphubert_torch.parallel.dryrun``:
``steps``, ``train``, ``jobs``) and the tests' own: ``cli_distill``, which
drives ``cli.distill`` in a process group already up, ``grads`` (one
step's gathered gradients) and ``load_state`` (a checkpoint restored on
the mesh and gathered again); a payload's ``min_size`` sets the smallest
leaf that FSDP splits.  Start the ranks with ``dryrun.start(ENTRY,
...)`` or ``dryrun.spawn(..., entry=ENTRY)``."""

from __future__ import annotations

import pathlib
import sys

from dphubert_torch.parallel import dryrun, fsdp

ENTRY = ["-m", "tests.torch_parallel_worker"]
DEFAULT_MIN_SHARD_ELEMS = fsdp.MIN_SHARD_ELEMS


def run_cli_distill(payload: dict, mesh=None) -> None:
    """``cli.distill`` with ``payload["argv"]``; the file
    ``payload["marker"]`` appears once a step is logged, so the test can
    signal one rank while training runs."""
    from dphubert_torch.cli import distill
    from dphubert_torch.train import trainer

    marker = pathlib.Path(payload["marker"])
    log = trainer.MetricLogger.log

    def log_and_mark(self, step, metrics, audio_seconds=0.0):
        marker.touch()
        return log(self, step, metrics, audio_seconds)

    trainer.MetricLogger.log = log_and_mark
    distill.cli_main(payload["argv"])


def _state(payload: dict, mesh):
    from dphubert_torch.train import DistillConfig, init_train_state

    teacher, student = dryrun.models(payload)
    dryrun.shard_teacher(teacher, payload, mesh)
    cfg = DistillConfig(**payload["distill"])
    state, tx = init_train_state(student=student, cfg=cfg,
                                 teacher_embed_dim=teacher.spec.embed_dim,
                                 seed=payload.get("seed", 0), device=payload["device"], mesh=mesh,
                                 fsdp=dryrun.fsdp_on(payload, mesh))
    return teacher, cfg, state


def run_grads(payload: dict, mesh=None) -> dict:
    """One step's metrics and gradients (gathered to one-card shapes) from
    a fresh state, on this rank's rows of ``payload["waves"][0]``."""
    from dphubert_torch.parallel.sharding import gather_tensor
    from dphubert_torch.train import make_grad_fn

    teacher, cfg, state = _state(payload, mesh)
    wave = payload["waves"][0]
    rows = dryrun._rows(mesh, wave.shape[0])
    metrics, grads = make_grad_fn(teacher, cfg, mesh)(state, (wave[rows], None))
    whole = {n: gather_tensor(state.shards[n], g, mesh) if n in state.shards else g
             for n, g in grads.items()}
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "grads": {n: g.detach().cpu().clone() for n, g in whole.items()},
            "local_numel": dryrun.local_numel(state)}


def run_load_state(payload: dict, mesh=None) -> dict:
    """``payload["resume"]`` restored into a fresh state on the mesh and
    gathered back: every checkpoint tensor at one-card shapes, by its
    ``params/``, ``mu/``, ``nu/`` name."""
    from dphubert_torch.parallel.sharding import gather_state_tensors
    from dphubert_torch.train.checkpointing import load_train_state

    _, _, state = _state(payload, mesh)
    load_train_state(payload["resume"], state)
    tensors = gather_state_tensors(state) if mesh is not None else {
        **{f"params/{n}": p for n, p in state.named_params().items()},
        **{f"{g}/{n}": t for g in ("mu", "nu") for n, t in getattr(state.opt_state, g).items()}}
    return {"tensors": {n: t.detach().cpu().clone() for n, t in tensors.items()},
            "step": state.step, "local_numel": dryrun.local_numel(state)}


def _at_min_size(job):
    """``job`` with ``fsdp.MIN_SHARD_ELEMS`` set to the payload's
    ``min_size`` (the tests split the tiny models' leaves at a smaller
    size, as the TPU package's tests place them), else to the default."""

    def run(payload: dict, mesh=None):
        fsdp.MIN_SHARD_ELEMS = payload.get("min_size", DEFAULT_MIN_SHARD_ELEMS)
        return job(payload, mesh)

    return run


JOBS = {name: _at_min_size(job) for name, job in
        {**dryrun.JOBS, "cli_distill": run_cli_distill, "grads": run_grads,
         "load_state": run_load_state}.items()}

if __name__ == "__main__":
    dryrun.run_rank(JOBS, sys.argv[1:])
