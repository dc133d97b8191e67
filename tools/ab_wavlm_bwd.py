#!/usr/bin/env python3
"""A/B of the WavLM backward pair's CUDA source on one card.

    python3 tools/ab_wavlm_bwd.py --variant DIR [--variant DIR ...] [--rounds N] [--out PATH]

Builds ``wavlm_attention.cu`` from the repo's ``dphubert_torch/csrc/``
(build "A") and from each ``--variant`` directory (a copy of ``csrc/`` with
other tensor-core bodies, "B", "C", ...), with ``ops/_build.py``'s nvcc
flags, and runs the single route's backward pair (``wavlm_attention_bwd_fused``,
then ``wavlm_attention_bwd_dkv``) of each build in bf16 at the DPWavLM
step's shape (16, 749, 12, 64), with dropout 0.1 and without.  The builds
take turns (A, B, ..., B, A, and so for ``--rounds`` rounds) so that the
card's drift between them cancels.  Each time is the device time of each
kernel (the fused entry's dq and dbias bodies apart) from ``torch.profiler``
over 10 calls after 3 warm ones, per call; each build's row is the mean of
its turns.  Beside the times: each build's registers and spill bytes a
thread of the three tensor-core bodies (ptxas), the blocks an SM that
registers and shared memory allow, and the max abs difference of its
outputs from A's.  Prints one JSON object, also written to ``--out``
(default ``build/ab_wavlm_bwd.json``).  Needs a CUDA card and nvcc; exits
non-zero without a card.
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
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from dphubert_torch.ops import _build  # noqa: E402

# the module (the package exports a function of the same name)
wavlm = importlib.import_module("dphubert_torch.ops.wavlm_attention")

BODIES = ("dq", "dbias", "dkv")  # wavlm_bwd_<body>_wgmma_kernel
# dynamic shared memory of each body (csrc/wavlm_attention_wgmma.cuh), as
# the repo's build has it; a variant may differ
SMEM_BYTES = {"dq": 6 * 8192 + 1024 + 1024, "dbias": 2 * (4 * 8192 + 1024) + 1024,
              "dkv": 6 * 8192 + 2 * 1024 + 64 * 68 * 4 + 1024}
SM_SMEM_BYTES = 233_472  # 228 KB an SM, 1 KB of it reserved per block
SM_REGISTERS = 65_536


def build(csrc: pathlib.Path, out_dir: pathlib.Path):
    """wavlm_attention.cu of ``csrc`` -> (library, {body: (registers, spill
    bytes)}, ptxas's notes on wgmma)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libwavlm_attention.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(csrc / "wavlm_attention.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc}:\n{proc.stdout}{proc.stderr}")
    regs = {}
    for block in proc.stderr.split("Compiling entry function")[1:]:
        name = re.search(r"wavlm_bwd_(\w+?)_wgmma_kernel", block)
        if name is not None:
            regs[name.group(1)] = (int(re.search(r"Used (\d+) registers", block).group(1)),
                                   int(re.search(r"(\d+) bytes spill stores", block).group(1)))
    notes = [line.strip()[:160] for line in proc.stderr.splitlines()
             if "wgmma" in line.lower() and "Compiling entry" not in line
             and "Function properties" not in line]
    return ctypes.CDLL(str(lib)), regs, notes


def blocks_per_sm(body: str, regs: int) -> int:
    """Blocks of 128 threads an SM holds: registers are allocated per warp
    in units of 256 (8 a thread); shared memory per block plus 1 KB."""
    per_block = -(-regs // 8) * 8 * 128
    return min(SM_REGISTERS // per_block, SM_SMEM_BYTES // (SMEM_BYTES[body] + 1024))


def device_ms(run, calls: int = 10) -> dict:
    """Device time of each tensor-core body per call of ``run``."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    ms = dict.fromkeys(BODIES, 0.0)
    for e in prof.events():
        name = re.search(r"wavlm_bwd_(\w+?)_wgmma_kernel", e.name)
        if e.device_type == DeviceType.CUDA and name is not None:
            ms[name.group(1)] += e.time_range.elapsed_us() / 1e3 / calls
    return ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", required=True,
                    help="a copy of dphubert_torch/csrc/ with other WavLM backward bodies")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of turns (A, B, ..., B, A)")
    ap.add_argument("--out", default=str(REPO / "build" / "ab_wavlm_bwd.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_wavlm_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dirs = {"A": _build.CSRC}
    dirs.update({chr(ord("B") + i): pathlib.Path(d).resolve() for i, d in enumerate(args.variant)})
    builds = {name: build(csrc, REPO / "build" / "ab_wavlm_bwd" / name)
              for name, csrc in dirs.items()}

    gen = torch.Generator(device="cuda").manual_seed(12)
    B, L, H, D = 16, 749, 12, 64
    qkv = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen).to(torch.bfloat16)
    dout = torch.randn(B, H, L, D, device="cuda", generator=gen).to(torch.bfloat16)
    bias = torch.randn(H, L, L, device="cuda", generator=gen)
    gate = 1.0 + 2.0 * torch.rand(B, H, L, device="cuda", generator=gen)
    q, k, v = (t.view(B, L, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1))
    seed = torch.tensor([20250101], dtype=torch.int32, device="cuda")
    x = (q, k, v, bias, gate)
    original = wavlm._kernel
    order = (list(builds) + list(builds)[::-1]) * args.rounds
    times = {(name, rate): [] for name in builds for rate in (0.1, 0.0)}
    outs = {}
    try:
        with torch.no_grad():
            out, m, l = wavlm.wavlm_attention_fwd(*x, None, scale=D ** -0.5, dropout_rate=0.1,
                                                  seed=seed)
            for name in order:
                lib = builds[name][0]

                def kernel(entry, lib=lib):
                    fn = getattr(lib, entry)
                    fn.argtypes = original(entry).argtypes
                    fn.restype = ctypes.c_int
                    return fn

                wavlm._kernel = kernel
                for rate in (0.1, 0.0):
                    kw = dict(scale=D ** -0.5, dropout_rate=rate, seed=seed)

                    def run():
                        dq, dgate, dbias, di = wavlm.wavlm_attention_bwd_fused(
                            *x, out, dout, m, l, None, **kw)
                        return (dq, dgate, dbias, di) + wavlm.wavlm_attention_bwd_dkv(
                            *x, out, dout, m, l, di, None, **kw)

                    if rate == 0.1:
                        outs[name] = run()
                    times[(name, rate)].append(device_ms(run))
    finally:
        wavlm._kernel = original
    rows = {}
    for name, (_, regs, notes) in builds.items():
        diff = [(a.float() - b.float()).abs().max().item() for a, b in zip(outs[name], outs["A"])]
        rows[name] = {
            "csrc": str(dirs[name]), "ptxas_notes": notes,
            "bodies": {body: {"registers": regs[body][0], "spill_bytes": regs[body][1],
                              "blocks_per_sm": blocks_per_sm(body, regs[body][0])}
                       for body in BODIES},
            "ms": {f"dropout {rate}": {body: statistics.mean(t[body] for t in times[(name, rate)])
                                       for body in BODIES} for rate in (0.1, 0.0)},
            "max_abs_diff_vs_A (dq, dgate, dbias, di, dk, dv)": diff,
        }
        print(json.dumps({name: rows[name]}), flush=True)
    result = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "shape_BHLD": [B, H, L, D], "dtype": "bfloat16", "builds": rows}
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
