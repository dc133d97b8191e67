#!/usr/bin/env python3
"""A/B of the attention forward's CUDA sources on one card.

    python3 tools/ab_attention_fwd.py --variant DIR [--variant DIR ...] [--rounds N] [--out PATH]

Builds ``attention_fwd.cu`` and ``wavlm_attention.cu`` from the repo's
``dphubert_torch/csrc/`` (build "A") and from each ``--variant`` directory
(a copy of ``csrc/`` with another forward body, "B", "C", ...), with
``ops/_build.py``'s nvcc flags, and times the ``packed_attention_fwd``,
``flash_attention_fwd`` and ``wavlm_attention_fwd`` entries of each build in
bf16 at the port's shapes: the stage-1 step's (16, 749, 12, 64) with
dropout 0.1 and without, serving's batch 1 (8, 799, 12, 64) and batch 2
(2, 1299, 12, 64) with their clips' lengths, the final distill's (5, 780,
11, 64) with dropout, and WavLM's forward (fp32 gate * bias in the scores)
at the DPWavLM step's (16, 749, 12, 64) with dropout 0.1 and without and at
serving's batch 2 with lengths.  The builds take turns (A, B, ..., B, A, and so for ``--rounds`` rounds) so that
the card's drift between them cancels; each time is the median of 50
CUDA-event timings of one call, and each build's row is the mean of its
turns.  Beside the times: each build's registers and spill bytes a thread
of ``attention_fwd_wgmma_kernel`` and ``wavlm_fwd_wgmma_kernel`` (ptxas), the
blocks an SM that registers and shared memory allow, and the max abs
difference of its output from A's.  Prints one JSON object, also written to
``--out`` (default ``build/ab_attention_fwd.json``).  Needs a CUDA card and
nvcc; fails if the repo's tensor-core forward spills (a variant's spill
bytes are reported) or ptxas serializes a wgmma; exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import pathlib
import re
import statistics
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from dphubert_torch.ops import _build  # noqa: E402

# the modules (the package exports functions of the same names)
packed_attention = importlib.import_module("dphubert_torch.ops.packed_attention")
flash_attention = importlib.import_module("dphubert_torch.ops.flash_attention")
wavlm_attention = importlib.import_module("dphubert_torch.ops.wavlm_attention")

SR = 16000
# the serving batches of chip_smoke.py (clip seconds, padded seconds)
BATCH1 = ((2.0, 3.5, 5.0, 6.5, 8.0, 10.0, 12.5, 15.0), 16.0)
BATCH2 = ((21.0, 26.0), 26.0)
# the tensor-core forward's dynamic shared memory (both kernels): the Q
# tile, a two-stage ring of K and V tiles, 1024 bytes to align the base
SMEM_BYTES = 5 * 8192 + 1024
SM_SMEM_BYTES = 233_472  # 228 KB an SM, 1 KB of it reserved per block
SM_REGISTERS = 65_536


def frames(seconds: float) -> int:
    """Frames of the wav2vec 2.0 / HuBERT conv stack (receptive field 400
    samples, stride 320) for a clip of ``seconds``."""
    return (int(seconds * SR) - 400) // 320 + 1


# the tensor-core forward kernel of each source
KERNELS = {"attention_fwd": "attention_fwd_wgmma_kernel", "wavlm_attention": "wavlm_fwd_wgmma_kernel"}


def build(csrc: pathlib.Path, out_dir: pathlib.Path, spill_ok: bool):
    """attention_fwd.cu and wavlm_attention.cu of ``csrc`` -> ({source:
    library}, {kernel: ptxas registers}, {kernel: spill store bytes},
    ptxas's notes on its wgmma); fails if ptxas serializes a wgmma, or
    unless ``spill_ok`` if a tensor-core forward spills."""
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, regs, spills, notes = {}, {}, {}, []
    for source, kernel in KERNELS.items():
        lib = out_dir / f"lib{source}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                               str(csrc / f"{source}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc}/{source}.cu:\n{proc.stdout}{proc.stderr}")
        block = proc.stderr.split(kernel, 1)[1]
        regs[kernel] = int(re.search(r"Used (\d+) registers", block).group(1))
        spills[kernel] = int(re.search(r"(\d+) bytes spill stores", block).group(1))
        if spills[kernel] and not spill_ok:
            raise RuntimeError(f"{csrc}: {kernel} spills {spills[kernel]} bytes")
        # ptxas names the wgmma it serializes ("Potential Performance Loss");
        # its other notes (a fence it injects) are reported
        notes += [line.strip()[:160] for line in proc.stderr.splitlines()
                  if ("wgmma" in line.lower() or "GMMA" in line)
                  and "Compiling entry" not in line and "Function properties" not in line]
        libs[source] = ctypes.CDLL(str(lib))
    serialized = [line for line in notes if "serializ" in line]
    if serialized:
        raise RuntimeError(f"{csrc}: ptxas serializes wgmma: {serialized}")
    return libs, regs, spills, notes


def blocks_per_sm(regs: int) -> int:
    """Blocks of 128 threads an SM holds: registers are allocated per warp
    in units of 256 (8 a thread); shared memory per block plus 1 KB."""
    per_block = -(-regs // 8) * 8 * 128
    return min(SM_REGISTERS // per_block, SM_SMEM_BYTES // (SMEM_BYTES + 1024))


def bind(lib, module, name: str):
    """``name`` of ``lib`` with the argtypes of the module's own binding."""
    fn = getattr(lib, name)
    own = module._kernel(name) if module is wavlm_attention else module._fwd_kernel()
    fn.argtypes = own.argtypes
    fn.restype = ctypes.c_int
    return fn


def time_ms(fn, reps: int = 50) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cases(gen):
    """(label, layout, call) at the port's bf16 shapes; each call runs the
    entry through its wrapper and returns the output."""
    seed = torch.tensor([20250101], dtype=torch.int32, device="cuda")
    out = []
    serve2 = (2, frames(BATCH2[1]), 12, [frames(s) for s in BATCH2[0]])
    for label, layout, B, L, H, lengths, rate in (
        ("train (16, 749, 12) dropout 0.1", "packed", 16, 749, 12, None, 0.1),
        ("train (16, 749, 12) no dropout", "packed", 16, 749, 12, None, 0.0),
        ("serve batch 1 (8, 799, 12)", "packed", 8, frames(BATCH1[1]), 12,
         [frames(s) for s in BATCH1[0]], 0.0),
        ("final distill (5, 780, 11) dropout 0.1", "flash", 5, 780, 11, None, 0.1),
        ("serve batch 2 (2, 1299, 12)", "flash", *serve2, 0.0),
        ("wavlm train (16, 749, 12) dropout 0.1", "wavlm", 16, 749, 12, None, 0.1),
        ("wavlm train (16, 749, 12) no dropout", "wavlm", 16, 749, 12, None, 0.0),
        ("wavlm serve batch 2 (2, 1299, 12)", "wavlm", *serve2, 0.0),
    ):
        D = 64
        qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(torch.bfloat16)
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
        if layout == "packed":
            q, k, v = qkv.split(H * D, dim=-1)
            call = (lambda q=q, k=k, v=v, lens=lens, H=H, rate=rate:
                    packed_attention.packed_attention(q, k, v, lens, num_heads=H,
                                                      dropout_rate=rate, seed=seed))
        elif layout == "flash":
            q, k, v = (t.view(B, L, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1))
            call = (lambda q=q, k=k, v=v, lens=lens, rate=rate:
                    flash_attention.flash_attention(q, k, v, lens, dropout_rate=rate,
                                                    seed=seed)[0])
        else:
            q, k, v = (t.view(B, L, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1))
            bias = torch.randn(H, L, L, device="cuda", generator=gen)
            gate = 1.0 + 2.0 * torch.rand(B, H, L, device="cuda", generator=gen)
            call = (lambda q=q, k=k, v=v, bias=bias, gate=gate, lens=lens, rate=rate:
                    wavlm_attention.wavlm_attention_fwd(q, k, v, bias, gate, lens,
                                                        dropout_rate=rate, seed=seed)[0])
        out.append((label, layout, call))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", required=True,
                    help="a copy of dphubert_torch/csrc/ with another forward body")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of turns (A, B, ..., B, A) per case")
    ap.add_argument("--out", default=str(REPO / "build" / "ab_attention_fwd.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_attention_fwd: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dirs = {"A": _build.CSRC}
    dirs.update({chr(ord("B") + i): pathlib.Path(d).resolve() for i, d in enumerate(args.variant)})
    builds = {}
    for name, csrc in dirs.items():
        libs, regs, spills, notes = build(csrc, REPO / "build" / "ab_attention_fwd" / name,
                                          spill_ok=name != "A")
        builds[name] = {
            "packed": bind(libs["attention_fwd"], packed_attention, "packed_attention_fwd"),
            "flash": bind(libs["attention_fwd"], flash_attention, "flash_attention_fwd"),
            "wavlm": bind(libs["wavlm_attention"], wavlm_attention, "wavlm_attention_fwd"),
            "regs": regs, "spills": spills, "notes": notes}
    # each wrapper looks its binding up through these: swapped per turn
    hooks = {"packed": (packed_attention, "_fwd_kernel"), "flash": (flash_attention, "_fwd_kernel"),
             "wavlm": (wavlm_attention, "_kernel")}
    originals = {k: getattr(m, attr) for k, (m, attr) in hooks.items()}
    order = (list(builds) + list(builds)[::-1]) * args.rounds
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    try:
        with torch.no_grad():
            for label, layout, call in cases(gen):
                times = {name: [] for name in builds}
                outs = {}
                for name in order:
                    fn = builds[name][layout]
                    module, attr = hooks[layout]
                    setattr(module, attr, lambda *_, fn=fn: fn)
                    outs[name] = call()
                    times[name].append(time_ms(call))
                diff = {name: (o.float() - outs["A"].float()).abs().max().item()
                        for name, o in outs.items() if name != "A"}
                rows.append({"case": label, "ms": {n: statistics.mean(t) for n, t in times.items()},
                             "turns_ms": times, "max_abs_diff_vs_A": diff})
                print(json.dumps(rows[-1]), flush=True)
    finally:
        for k, (module, attr) in hooks.items():
            setattr(module, attr, originals[k])
    result = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "builds": {n: {"csrc": str(d), "registers": builds[n]["regs"],
                             "spill_store_bytes": builds[n]["spills"],
                             "blocks_per_sm": {k: blocks_per_sm(r)
                                               for k, r in builds[n]["regs"].items()},
                             "ptxas_notes": builds[n]["notes"]}
                         for n, d in dirs.items()},
              "rows": rows}
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
