"""Stage 1: joint distillation + pruning (reference ``distill.py``), on one
card or on N (one process per card).

Usage mirrors the reference CLI and the TPU package's, flag for flag where
the work is ported, plus ``--device`` (default ``cuda``)::

    python -m dphubert_torch.cli.distill \\
        --tsv_dir data/librispeech --train_subset train960 \\
        --teacher_ckpt pretrained/hubert-base-ls960.pth \\
        --student_ckpt pretrained/hubert-base-ls960.pth \\
        --exp_dir exp/stage1 --max_updates 50000 ...

On N processes (``python -m torch.distributed.run --standalone
--nproc_per_node N -m dphubert_torch.cli.distill ...``): a (N /
``--tensor_parallel`` data x ``--tensor_parallel`` model) mesh
(``--num_data_shards``, if given, must equal N / ``--tensor_parallel``),
NCCL on the card and gloo with ``--device cpu``;
``--seconds_per_batch`` is one data rank's share of the global batch.
``--fsdp`` also splits the student, its Adam moments and the frozen
teacher over the data ranks (with ``--tensor_parallel``: HSDP); on one
process it trains as without it.  Rank 0 logs and writes; every rank exits
with the same code.

Exit codes: 0 done (``<exp_dir>/ckpts/distilled.pth`` written), 75 stopped
by a SIGTERM or the RSS watchdog (``DPHUBERT_MAX_RSS_GB``; resumable), 76
stopped by the ``DPHUBERT_DEADLINE_TS`` deadline (resumable; a recipe
script must not resume into the same deadline).  Resume with
``--resume_checkpoint <exp_dir>/ckpts/last.pt`` (``--ckpt_backend last``)
or ``<exp_dir>/ckpts/rotated`` (``rotated``: the newest step in it).
torchrun exits 1 whatever code its ranks exit with, so on several
processes rank 0 also writes an early stop's code (75 or 76) to
``<exp_dir>/exit_code``, which the recipe scripts read.
"""

from __future__ import annotations

import pathlib
from argparse import ArgumentParser

import numpy as np
import torch

from ..interop.torch_ckpt import load_checkpoint
from ..models.model import resolve_device, wav2vec2_model
from ..parallel import multihost
from ..parallel.mesh import create_mesh
from ..train.distill_module import DistillConfig
from ..train.projections import parse_layer_groups
from ..train.trainer import export_student_checkpoint, train
from .common import apply_pruning_units, build_loader, load_model_ckpt, merge_params


def add_common_training_args(parser: ArgumentParser) -> None:
    parser.add_argument("--tsv_dir", type=pathlib.Path, required=True)
    parser.add_argument("--train_subset", default="train100",
                        choices=["train100", "train960"])
    parser.add_argument("--seconds_per_batch", default=87.5, type=float)
    parser.add_argument("--num_workers", default=8, type=int)
    parser.add_argument("--num_shapes", default=12, type=int,
                        help="Number of static length buckets.")
    parser.add_argument("--resume_checkpoint", type=pathlib.Path, default=None,
                        help="A training-state file (<exp_dir>/ckpts/last.pt) or a "
                        "directory of rotated ones (<exp_dir>/ckpts/rotated: its newest).")
    parser.add_argument("--exp_dir", default=pathlib.Path("./exp"), type=pathlib.Path)
    parser.add_argument("--ckpt_interval", default=1000, type=int)
    parser.add_argument("--ckpt_backend", default="last", choices=["last", "rotated"],
                        help="last: one file, ckpts/last.pt (the TPU package's npz); "
                        "rotated: ckpts/rotated/step_<n>.pt, the newest --ckpt_keep kept "
                        "(its orbax).  Either is written by a background thread unless "
                        "DPHUBERT_SYNC_CKPT=1 or the state is too large for the card.")
    parser.add_argument("--ckpt_keep", default=3, type=int,
                        help="Rotated checkpoints kept (--ckpt_backend rotated).")
    parser.add_argument("--steps_per_dispatch", default=1, type=int,
                        help="K consecutive same-shape batches per dispatch: one CUDA "
                        "graph of K steps on the card (K eager steps on the CPU).  The "
                        "batcher forms runs of K; a resume needs the same K.  Not with "
                        "--remat on the card.")
    parser.add_argument("--log_interval", default=50, type=int)
    parser.add_argument("--learning_rate", default=0.0002, type=float)
    parser.add_argument("--weight_decay", default=0.0, type=float)
    parser.add_argument("--warmup_updates", default=15000, type=int)
    parser.add_argument("--max_updates", default=50000, type=int)
    parser.add_argument("--clip_norm", default=10.0, type=float)
    parser.add_argument("--num_data_shards", default=0, type=int,
                        help="Mesh data-axis size, always processes / --tensor_parallel "
                        "(0 derives it; another value is refused).  The TPU CLI's flag can "
                        "pick fewer devices; here every process is a rank of the mesh.")
    parser.add_argument("--tensor_parallel", default=1, type=int,
                        help="Mesh model-axis size: attention heads and FFN units split "
                        "over it (Megatron row/column split; a layer whose heads or units "
                        "do not divide stays replicated; WavLM's layers take their heads' "
                        "rows of the position bias and the GRU gate).")
    parser.add_argument("--fsdp", action="store_true",
                        help="ZeRO-3-style layouts: shard params, Adam moments, and the "
                        "frozen teacher over the data axis (per-device memory ~1/n_data; "
                        "each weight is all-gathered where it is read and its gradient "
                        "reduce-scattered). Composes with --tensor_parallel (HSDP).")
    parser.add_argument("--accum_grad", default=1, type=int)
    parser.add_argument("--precision", default="bf16", choices=["bf16", "fp32"],
                        help="Compute dtype (parameters stay fp32).")
    # the TPU package's --scan_layers (a lax.scan that shrank the compiled
    # program of the Large family) has no counterpart in eager PyTorch
    parser.add_argument("--remat", action="store_true",
                        help="Per-layer activation checkpointing of the student "
                        "(less activation memory for one more student forward).")
    parser.add_argument("--teacher_ckpt", type=pathlib.Path, required=True)
    parser.add_argument("--student_ckpt", type=pathlib.Path, required=True)
    parser.add_argument("--distill_layers", default="0.4,8,12", type=str)
    parser.add_argument("--distill_mode", default="layer2layer",
                        choices=["layer2layer", "predlayer"])
    parser.add_argument("--l2_weight", default=0.0, type=float)
    parser.add_argument("--l1_weight", default=1.0, type=float)
    parser.add_argument("--cos_weight", default=1.0, type=float)
    parser.add_argument("--cos_type", default="raw", choices=["raw", "log_sig"])
    parser.add_argument("--seed", default=2022, type=int)
    parser.add_argument("--val_interval", default=0, type=int,
                        help="Validate every N steps in addition to epoch "
                        "boundaries (0 = epoch boundaries only).")
    parser.add_argument("--device", default="cuda",
                        help="Where to train: cuda (the card) or cpu.")


def _parse_args(argv=None):
    parser = ArgumentParser(description="Joint distillation and pruning (stage 1)")
    add_common_training_args(parser)
    parser.add_argument("--pruning_units", default="conv,head,interm,attlayer,ffnlayer")
    parser.add_argument("--reg_learning_rate", default=0.02, type=float)
    parser.add_argument("--target_sparsity", default=0.75, type=float)
    parser.add_argument("--sparsity_warmup_updates", default=5000, type=int)
    return parser.parse_args(argv)


def _mesh(args, device):
    """The (processes / --tensor_parallel x --tensor_parallel) mesh of a
    run of several processes, else None.  ``--num_data_shards`` is only
    checked against it."""
    world = multihost.world_size()
    n_model = max(1, args.tensor_parallel)
    if n_model > world:
        raise SystemExit(f"--tensor_parallel {n_model} needs at least {n_model} devices "
                         f"(one process each) but only {world} are in the run")
    if world % n_model:
        raise SystemExit(f"--tensor_parallel {n_model} does not divide the run's {world} "
                         "processes")
    n_data = world // n_model
    if args.num_data_shards not in (0, n_data):
        raise SystemExit(f"--num_data_shards {args.num_data_shards} needs "
                         f"{args.num_data_shards * n_model} devices (one process each) but "
                         f"the run has {world}"
                         + (": start it under python -m torch.distributed.run"
                            if world == 1 else ""))
    return None if world == 1 else create_mesh(n_data, n_model, device.type)


def _exit(args, mesh, code: int):
    """Exit with ``code``; on a mesh rank 0 first writes it to
    ``<exp_dir>/exit_code`` (torchrun's own exit code does not carry it)."""
    if mesh is not None and mesh.is_main:
        (pathlib.Path(args.exp_dir) / "exit_code").write_text(f"{code}\n")
    raise SystemExit(code)


def run_train(args, use_reg: bool = True):
    """Train stage 1 (``use_reg``) or the final distill, export the student
    to ``<exp_dir>/ckpts/distilled.pth``; exits 75 or 76 when stopped early
    (before the export, so no partial stage output lands there).  Under
    torchrun every process runs it: the process group is started here and
    destroyed at the end."""
    device = resolve_device(args.device)
    started = not multihost.is_initialized()
    device = multihost.initialize(device)
    started = started and multihost.is_initialized()
    try:
        return _run_train(args, use_reg, device)
    finally:
        if started:
            multihost.shutdown()


def _run_train(args, use_reg: bool, device):
    mesh = _mesh(args, device)
    teacher, _ = load_model_ckpt(args.teacher_ckpt, device)

    student_ckpt = load_checkpoint(args.student_ckpt)
    student_config = student_ckpt["config"]
    if use_reg:
        student_config = apply_pruning_units(student_config, args.pruning_units)
    # strict=False load: the checkpoint's weights and freshly initialised gates
    student = wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(args.seed),
                             **student_config)
    merged = merge_params(student.state_dict(), student_ckpt["state_dict"])
    student.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in merged.items()})

    cfg = DistillConfig(
        distill_mode=args.distill_mode,
        distill_layer_groups=parse_layer_groups(args.distill_layers),
        l2_weight=args.l2_weight,
        l1_weight=args.l1_weight,
        cos_weight=args.cos_weight,
        cos_type=args.cos_type,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        warmup_updates=args.warmup_updates,
        max_updates=args.max_updates,
        clip_norm=args.clip_norm,
        use_reg=use_reg,
        reg_learning_rate=getattr(args, "reg_learning_rate", 0.0),
        target_sparsity=getattr(args, "target_sparsity", 0.0),
        sparsity_warmup_updates=getattr(args, "sparsity_warmup_updates", 1),
        compute_dtype="bfloat16" if args.precision == "bf16" else "float32",
        remat=args.remat,
        accum_grad=args.accum_grad,
    )

    n_data = 1 if mesh is None else mesh.n_data
    shard = None if n_data == 1 else (mesh.data_rank, n_data)
    loader = build_loader(args, args.train_subset, num_replicas=n_data, shard=shard,
                          shuffle_seed=args.seed)
    valid_loader = None
    try:
        valid_loader = build_loader(args, "valid", num_replicas=n_data, shard=shard,
                                    shuffle_seed=args.seed)
    except FileNotFoundError:
        pass

    proj_sd = student_ckpt.get("distill_linear_projs") if not use_reg else None

    stop_info: dict = {}
    state = train(
        teacher=teacher,
        student=student,
        cfg=cfg,
        loader=loader,
        valid_loader=valid_loader,
        exp_dir=args.exp_dir,
        log_interval=args.log_interval,
        ckpt_interval=args.ckpt_interval,
        resume=args.resume_checkpoint,
        seed=args.seed,
        proj_state_dict=proj_sd,
        val_interval=args.val_interval or None,
        stop_info=stop_info,
        steps_per_dispatch=args.steps_per_dispatch,
        ckpt_backend=args.ckpt_backend,
        ckpt_keep=args.ckpt_keep,
        device=device,
        mesh=mesh,
        fsdp=args.fsdp,
    )

    accum = max(cfg.accum_grad, 1)
    if stop_info.get("why") == "deadline":
        print(f"[distill] wall-clock deadline at step {state.step} "
              f"(< {args.max_updates} updates): exiting 76 (checkpointed; "
              "resume later with --resume_checkpoint)", flush=True)
        _exit(args, mesh, 76)
    if state.step < args.max_updates * accum:
        print(f"[distill] preempted at step {state.step} "
              f"(< {args.max_updates} updates): exiting 75 (resumable)", flush=True)
        _exit(args, mesh, 75)

    out = pathlib.Path(args.exp_dir) / "ckpts" / "distilled.pth"
    export_student_checkpoint(state, cfg, out)
    if multihost.is_main():
        print(f"Saved distilled checkpoint to {out}", flush=True)
    return state


def cli_main(argv=None):
    return run_train(_parse_args(argv), use_reg=True)


if __name__ == "__main__":
    cli_main()
