"""Ranks of a parallel run on one host, and the dry runs of the parallel
paths (the counterparts of the TPU package's
``__graft_entry__.dryrun_multichip`` and ``dryrun_multihost``)::

    python -m dphubert_torch.parallel.dryrun [--device cuda|cpu] multichip 4
    python -m dphubert_torch.parallel.dryrun [--device cuda|cpu] multihost 2

``multichip N`` runs the full stage-1 step (gated student, dropout on) of a
tiny model (4 heads of 64) on a (N/2 data x 2 model) mesh (N even and >= 4;
else N x 1): one step, and two as one call of ``steps_per_call=2``.
``multihost N`` runs the trainer end to end on N data-parallel processes: 3
steps with rank-0 checkpoints and metrics, a resume to 5 from that
checkpoint, and the rotated backend (2 steps, a resume of the directory to
4).  Each prints one ``ok`` line; a rank that fails or passes its time
limit fails the run.

On the card (the default) rank r takes ``cuda:(r % cards)``: NCCL when
every rank has a card of its own, else gloo on CUDA tensors (NCCL refuses
two ranks on one card).  Over gloo on the card the two-step call is not
run (a CUDA graph cannot capture gloo's collectives) and the ``ok`` line
says so.  ``--device cpu``: gloo on the CPU.

The harness is shared with the tests' ranks and the smoke's phase
"parallel_card": ``spawn`` writes a payload next to a ``FileStore`` under a
directory, starts one process per rank (``start``), each with its own time
limit, and returns what each rank's job returned; a rank process calls
``run_rank`` with the jobs it knows (``JOBS``: ``steps``, ``train`` and
``jobs``, several of them in one process group).
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

RANK_TIMEOUT_S = 600
# the rank process of this module: ``python -m dphubert_torch.parallel.dryrun worker ...``
WORKER = ["-m", "dphubert_torch.parallel.dryrun", "worker"]

TINY = dict(
    extractor_mode="group_norm",
    extractor_conv_layer_config=[[16, 10, 5], [16, 3, 2], [16, 2, 2]],
    extractor_conv_bias=False,
    encoder_embed_dim=256,
    encoder_projection_dropout=0.1,
    encoder_pos_conv_kernel=16,
    encoder_pos_conv_groups=4,
    encoder_num_layers=2,
    encoder_use_attention=[True] * 2,
    encoder_use_feed_forward=[True] * 2,
    encoder_num_heads=[4] * 2,
    encoder_head_dim=64,  # a head width the card's kernels take
    encoder_attention_dropout=0.1,
    encoder_ff_interm_features=[512] * 2,
    encoder_ff_interm_dropout=0.1,
    encoder_dropout=0.1,
    encoder_layer_norm_first=False,
    encoder_layer_drop=0.0,
    aux_num_out=None,
    normalize_waveform=False,
)
PRUNE_FLAGS = dict(
    extractor_prune_conv_channels=True,
    encoder_prune_attention_heads=True,
    encoder_prune_attention_layer=True,
    encoder_prune_feed_forward_intermediate=True,
    encoder_prune_feed_forward_layer=True,
)


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


def start(entry, job: str, world: int, tmp, layout, *, device="cpu", backend=None,
          cwd=None) -> list:
    """Start ``world`` rank processes ``python *entry job rank world tmp
    n_data n_model device backend`` (the payload is already at
    ``tmp/in.pt``); returns them.  On the card rank r's ``LOCAL_RANK`` is
    r modulo the cards."""
    tmp = pathlib.Path(tmp)
    (tmp / "store").unlink(missing_ok=True)
    cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
    procs = []
    for rank in range(world):
        local = {"LOCAL_RANK": str(rank % cards)} if cards else {}
        cmd = [sys.executable, *entry, job, str(rank), str(world), str(tmp), str(layout[0]),
               str(layout[1]), str(device), backend or "default"]
        procs.append(subprocess.Popen(
            cmd, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "OMP_NUM_THREADS": "1", **local}))
    return procs


def wait(procs, timeout=RANK_TIMEOUT_S) -> list:
    """Each rank's (exit code, output); a rank past ``timeout`` is killed
    and reports the code None."""
    results = []
    for p in procs:
        try:
            out = p.communicate(timeout=timeout)[0]
            results.append((p.returncode, out))
        except subprocess.TimeoutExpired:
            p.kill()
            results.append((None, p.communicate()[0] + "\n(killed at its time limit)"))
    return results


def spawn(job: str, world: int, tmp, payload: dict, layout, *, entry=WORKER, device="cpu",
          backend=None, timeout=RANK_TIMEOUT_S, cwd=None):
    """Run ``job`` on ``world`` ranks as the (n_data x n_model) mesh
    ``layout``; returns (outs, results): outs[r] is what rank r's job
    returned (None if it wrote nothing), results[r] its (exit code,
    output)."""
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp / "in.pt")
    for r in range(world):
        (tmp / f"out{r}.pt").unlink(missing_ok=True)
    results = wait(start(entry, job, world, tmp, layout, device=device, backend=backend,
                         cwd=cwd), timeout)
    outs = [torch.load(tmp / f"out{r}.pt", weights_only=False)
            if (tmp / f"out{r}.pt").exists() else None for r in range(world)]
    return outs, results


def check_ranks(results, what: str = "rank") -> None:
    """Raise if a rank did not exit 0, with the end of its output."""
    for rank, (rc, out) in enumerate(results):
        if rc != 0:
            raise RuntimeError(f"{what} {rank} exited {rc}:\n{out[-4000:]}")


def run_rank(jobs: dict, argv) -> None:
    """The body of a rank process (``argv`` as ``start`` passes it): join
    the group through the ``FileStore``, make the mesh, run the job on the
    payload (its ``device`` set to this rank's) and save what it returns
    to ``tmp/out<rank>.pt``."""
    import torch.distributed as dist

    from . import multihost
    from .mesh import create_mesh

    job, rank, world, tmp, n_data, n_model, device, backend = argv
    rank, world, tmp = int(rank), int(world), pathlib.Path(tmp)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    device = multihost.initialize(device, backend=None if backend == "default" else backend,
                                  store=dist.FileStore(str(tmp / "store"), world), rank=rank,
                                  world_size=world)
    try:
        mesh = create_mesh(int(n_data), int(n_model), device.type)
        payload = torch.load(tmp / "in.pt", weights_only=False)
        out = jobs[job](dict(payload, device=str(device)), mesh)
        torch.save(out, tmp / f"out{rank}.pt")
    finally:
        multihost.shutdown()


# ---------------------------------------------------------------------------
# jobs (the tests also run them in one process, with mesh=None)
# ---------------------------------------------------------------------------


def models(payload):
    from ..models import wav2vec2_model

    device = payload.get("device", "cuda")
    teacher = wav2vec2_model(device=device, generator=torch.Generator().manual_seed(0),
                             **payload["teacher"])
    if payload.get("teacher_state") is not None:
        teacher.load_state_dict(payload["teacher_state"])
    student = wav2vec2_model(device=device, generator=torch.Generator().manual_seed(1),
                             **payload["student"])
    return teacher, student


def _rows(mesh, global_batch: int):
    from .multihost import process_row_slice

    return slice(None) if mesh is None else process_row_slice(mesh.data_rank, mesh.n_data,
                                                              global_batch)


def _one_card(state) -> dict:
    from .sharding import gather_full

    return {n: t.detach().cpu().clone() for n, t in gather_full(state).items()}


def run_steps(payload: dict, mesh=None) -> dict:
    """``len(payload["waves"])`` distill steps from a fresh state (seed
    ``payload["seed"]``; ``params``: one-card parameters to load; ``gate_u``:
    each step's gate draws), ``steps_per_call`` a call; each rank feeds its
    rows.  Returns every step's metrics, the one-card parameters after the
    last step, the step count, the generator's state and the split
    parameters."""
    from ..train import DistillConfig, init_train_state, make_train_step

    teacher, student = models(payload)
    cfg = DistillConfig(**payload["distill"])
    state, tx = init_train_state(student=student, cfg=cfg,
                                 teacher_embed_dim=teacher.spec.embed_dim,
                                 seed=payload.get("seed", 0),
                                 device=payload.get("device", "cuda"), mesh=mesh)
    if payload.get("params") is not None:
        state.load_params(payload["params"])
    waves = payload["waves"]
    rows = _rows(mesh, waves[0].shape[0])
    k = payload.get("steps_per_call", 1)
    gate_u = payload.get("gate_u")
    metrics = []
    if k == 1:
        step = make_train_step(teacher, cfg, tx, mesh=mesh)
        for i, w in enumerate(waves):
            state, m = step(state, (w[rows], None), gate_u=None if gate_u is None else gate_u[i])
            metrics.append({n: v.item() for n, v in m.items()})
    else:
        group = make_train_step(teacher, cfg, tx, steps_per_call=k, mesh=mesh)
        for i in range(0, len(waves), k):
            state, m = group(state, (np.stack([w[rows] for w in waves[i:i + k]]), None))
            metrics.extend({n: float(v[j]) for n, v in m.items()} for j in range(k))
    return {"metrics": metrics, "params": _one_card(state), "step": state.step,
            "generator": state.generator.get_state(), "shards": dict(state.shards)}


class RowLoader:
    """Every rank makes the same global batches from (seed, epoch) and
    yields its rows (the loader's ``shard`` contract)."""

    def __init__(self, global_batch: int, samples: int, n_batches: int, rows=slice(None)):
        self.global_batch, self.samples, self.n_batches, self.rows = (
            global_batch, samples, n_batches, rows)

    def epoch(self, e, skip=0):
        rng = np.random.default_rng(100 + e)
        for i in range(self.n_batches):
            w = rng.standard_normal((self.global_batch, self.samples)).astype(np.float32)
            if i >= skip:
                yield w[self.rows], None


def run_train(payload: dict, mesh=None) -> dict:
    """``trainer.train`` on ``RowLoader`` batches (``batch``: global rows,
    samples, batches an epoch); returns the one-card parameters, the step
    and why it stopped."""
    from ..train import DistillConfig
    from ..train.trainer import train

    teacher, student = models(payload)
    B, T, n = payload["batch"]
    rows = _rows(mesh, B)
    stop: dict = {}
    state = train(teacher=teacher, student=student, cfg=DistillConfig(**payload["distill"]),
                  loader=RowLoader(B, T, n, rows), exp_dir=payload["exp_dir"],
                  valid_loader=RowLoader(B, T, 1, rows) if payload.get("valid") else None,
                  log_interval=1, ckpt_interval=100,
                  resume=payload.get("resume"), seed=payload.get("seed", 0),
                  stop_at_step=payload.get("stop_at_step"), stop_info=stop,
                  ckpt_backend=payload.get("ckpt_backend", "last"),
                  ckpt_keep=payload.get("ckpt_keep", 3),
                  device=payload.get("device", "cuda"), mesh=mesh)
    return {"params": _one_card(state), "step": state.step, "why": stop.get("why")}


def run_jobs(payload: dict, mesh=None) -> dict:
    """Several jobs in one process group, in order: ``payload["jobs"]`` maps
    a name to (job, payload); returns each job's result by name."""
    device = {"device": payload["device"]} if "device" in payload else {}
    return {name: JOBS[job](dict(p, **device), mesh)
            for name, (job, p) in payload["jobs"].items()}


JOBS = {"steps": run_steps, "train": run_train, "jobs": run_jobs}


# ---------------------------------------------------------------------------
# the dry runs
# ---------------------------------------------------------------------------


def _backend(world: int, device: str) -> str:
    if device == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def _run(jobs: dict, world: int, layout, device: str, backend: str, tmp) -> dict:
    outs, results = spawn("jobs", world, pathlib.Path(tmp) / "spawn", {"jobs": jobs}, layout,
                          device=device, backend=backend)
    check_ranks(results, "dryrun rank")
    return outs[0]


def multichip(n: int, device: str, tmp) -> str:
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    layout = (n // n_model, n_model)
    backend = _backend(n, device)
    rng = np.random.default_rng(0)
    waves = [rng.standard_normal((2 * n, 2000)).astype(np.float32) for _ in range(3)]
    base = dict(teacher=TINY, student=dict(TINY, **PRUNE_FLAGS), seed=2,
                distill=dict(distill_layer_groups=((0,), (1, 2)), warmup_updates=2,
                             max_updates=10, sparsity_warmup_updates=2, target_sparsity=0.5))
    jobs = {"one": ("steps", dict(base, waves=waves[:1]))}
    graphs = device == "cpu" or backend == "nccl"
    if graphs:
        jobs["group"] = ("steps", dict(base, waves=waves[1:], steps_per_call=2))
    out = _run(jobs, n, layout, device, backend, tmp)
    loss = out["one"]["metrics"][0]["loss"]
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if graphs:
        group = out["group"]
        losses = [m["loss"] for m in group["metrics"]]
        if group["step"] != 2 or not np.isfinite(losses).all():
            raise RuntimeError(f"multi-step: step {group['step']}, losses {losses}")
        multistep = f"multistep_loss={losses[-1]:.4f}"
    else:
        multistep = ("steps_per_call=2 not run: a CUDA graph cannot capture gloo's "
                     "collectives")
    return (f"dryrun_multichip({n}): ok - loss={loss:.4f}, {multistep}, "
            f"mesh=(data {layout[0]}, model {layout[1]}), {backend} on {device}, split "
            f"parameters {len(out['one']['shards'])}")


def multihost(n: int, device: str, tmp) -> str:
    exp, rotated = pathlib.Path(tmp) / "exp", pathlib.Path(tmp) / "rotated_run"

    def train(max_updates, exp_dir, **kw):
        return ("train", dict(teacher=TINY, student=TINY, batch=(2 * n, 2000, 10),
                              exp_dir=str(exp_dir), **kw,
                              distill=dict(use_reg=False, distill_layer_groups=((0,), (1, 2)),
                                           warmup_updates=2, max_updates=max_updates)))

    jobs = {"first": train(3, exp, valid=True),
            "resume": train(5, exp, resume=str(exp / "ckpts" / "last.pt")),
            "rotated": train(2, rotated, ckpt_backend="rotated", ckpt_keep=2),
            "rotated_resume": train(4, rotated, ckpt_backend="rotated", ckpt_keep=2,
                                    resume=str(rotated / "ckpts" / "rotated"))}
    out = _run(jobs, n, (n, 1), device, _backend(n, device), tmp)
    steps = {name: r["step"] for name, r in out.items()}
    if steps != {"first": 3, "resume": 5, "rotated": 2, "rotated_resume": 4}:
        raise RuntimeError(f"steps reached: {steps}")
    if not ((exp / "ckpts" / "last.pt").exists() and (exp / "metrics.jsonl").exists()):
        raise RuntimeError("rank 0 wrote no checkpoint or metrics")
    return (f"dryrun_multihost({n}): ok - trainer ran 3+2 steps on {n} processes "
            f"({device}), rank-0 checkpoint and resume, rotated backend and directory resume")


MODES = {"multichip": multichip, "multihost": multihost}


def dryrun(mode: str, n: int, device: str = "cuda") -> str:
    """Run ``mode`` on ``n`` processes; returns its ``ok`` line."""
    if mode not in MODES or n < 1:
        raise ValueError(f"usage: dryrun {{multichip N | multihost N}}, got {mode} {n}")
    tmp = tempfile.mkdtemp(prefix="dphubert_dryrun_")
    try:
        return MODES[mode](n, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv) -> int:
    if argv and argv[0] == "worker":
        run_rank(JOBS, argv[1:])
        return 0
    parser = argparse.ArgumentParser(prog="python -m dphubert_torch.parallel.dryrun")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("mode", choices=sorted(MODES))
    parser.add_argument("n", type=int)
    args = parser.parse_args(argv)
    print(dryrun(args.mode, args.n, args.device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
