#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` on one card, and the probe of
how deterministic the distill step is.

    python3 tools/smoke_phases.py [determinism] [train] [final] [wavlm] [layerdrop] [large]
                                  [ckpt] [pipeline] [parallel]

The kernels are built first (phase "card"); then, in the order given:

* ``determinism``: for HuBERT Base's stage-1 step and the DPWavLM step
  (bf16, B = 16 x 15 s, dropout on), two eager runs of 2 steps from the
  same state and generator, compared tensor for tensor (parameters,
  moments), with cuDNN's default algorithms, with its deterministic ones,
  and with PyTorch's deterministic algorithms too; one JSON line each
  with the tensors that differ and the step times;
* ``train``, ``final``, ``wavlm``, ``large``: the smoke's timed steps
  with their "graph_train" phases (stage 1 with its "graph_keys" and its
  "profile" too, the final distill, DPWavLM on the single and then the
  general route, wav2vec 2.0 Large converted from fairseq names, without
  and with remat, with its "graph_keys");
* ``layerdrop``: the training forward with LayerDrop, HuBERT Base and
  WavLM Base;
* ``ckpt``: the smoke's checkpoint phase (without the Large state's
  decision);
* ``pipeline``: the recipe through the CLIs;
* ``parallel``: the smoke's "dp_nccl_world1" and "parallel_card" phases
  (one NCCL rank as a mesh, the FSDP path on it eager and captured; gloo
  ranks on the card: data and tensor parallelism, FSDP, HSDP and DPWavLM
  under tensor parallelism, rows "parallel_card" and "fsdp_card").

Each phase prints the smoke's JSON lines; a failed check raises.  Needs a
CUDA card.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
import warnings

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dphubert_torch.train import DistillConfig, init_train_state, make_train_step  # noqa: E402
from dphubert_torch.train.checkpointing import device_snapshot  # noqa: E402

MODES = {"default": (False, False), "cudnn": (True, False), "cudnn+algorithms": (True, True)}


def determinism(family: str) -> None:
    teacher, student = cs.distill_models("cuda", family)
    cfg = DistillConfig(compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = (torch.randn(cs.TRAIN_B, int(cs.TRAIN_SECONDS * cs.SR), device="cuda",
                         generator=gen), None)
    for mode, (cudnn, algorithms) in MODES.items():
        torch.backends.cudnn.deterministic = cudnn
        torch.use_deterministic_algorithms(algorithms, warn_only=True)
        snaps, times = [], []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                state, tx = init_train_state(student=student, cfg=cfg, teacher_embed_dim=768,
                                             seed=5, device="cuda")
                step = make_train_step(teacher, cfg, tx)
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, _ = step(state, batch)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                snaps.append(device_snapshot(state).tensors)
                del state, tx, step
        differ = [k for k, t in snaps[0].items() if not torch.equal(t, snaps[1][k])]
        cs.emit({"phase": "determinism", "family": family, "mode": mode,
                 "tensors_differ": len(differ), "tensors": len(snaps[0]),
                 "first_differing": differ[:4], "step_s": times,
                 "warnings": sorted({str(w.message)[:160] for w in caught})})
        del snaps
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    del teacher, student
    torch.cuda.empty_cache()


def torch_spec():
    """HuBERT Base's spec (the smoke's stage-1 shapes)."""
    import dphubert_torch as pt

    return pt.hubert_base(device="cpu").spec


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("smoke_phases: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    cs.phase_card()
    for name in argv or ["determinism"]:
        if name == "determinism":
            determinism("hubert")
            determinism("wavlm")
        elif name == "train":
            cs.phase_train()
        elif name == "final":
            cs.phase_final_distill_step()
        elif name == "wavlm":
            cs.phase_wavlm_general_train(cs.phase_train("wavlm"))
        elif name == "layerdrop":
            cs.phase_layerdrop("hubert")
            cs.phase_layerdrop("wavlm")
        elif name == "large":
            converted, _ = cs.phase_large_convert()
            cs.phase_large_train(converted)
        elif name == "ckpt":
            cs.phase_ckpt({"bytes": None, "fits": None})
        elif name == "pipeline":
            cs.phase_pipeline()
        elif name == "parallel":
            cs.phase_dp_nccl_world1()
            cs.phase_parallel_card(torch_spec())
        else:
            raise SystemExit(f"unknown phase {name!r}")
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
