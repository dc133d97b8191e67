#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``dphubert_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process runs one cell of ``BENCHMARK.json``: it finds the cell's files
by name (``benchmark/workloads/<cell>.json``: its configuration, traffic mix
and limits; ``benchmark/configs/<config>.json``; ``benchmark/traffic/<mix>.json``,
whose ``kind`` names the driver ``benchmark/drivers/<kind>.py``), makes the
inputs and weights from ``--seed``, sets up and warms the program, measures
for ``--seconds`` (with ``--trace 1`` under the profiler, reading the cell's
per-layer metrics with ``benchmark/metrics/<name>.py``), then holds what the
window produced against the plain reference (``benchmark/reference/``) and
prints one JSON line.  It needs the card(s) the cell asks for and exits
non-zero without them, and exits non-zero if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import os
import sys
import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "dphubert" + "_tpu")


def process_start() -> float:
    """Wall time at which this process started (``/proc``), else the time
    this module was first imported."""
    try:
        stat = pathlib.Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        btime = next(int(l.split()[1]) for l in pathlib.Path("/proc/stat").read_text().splitlines()
                     if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def cache_env(root: pathlib.Path) -> None:
    """Every build and kernel cache in fixed directories of the checkout;
    no library that the port uses may pull in JAX."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Context:
    """What a per-layer metric reads (``benchmark/metrics/<name>.py``)."""

    cell: str
    kind: str                 # "train" or "serve"
    trace: object             # lib.trace.Trace of the window
    window_s: float
    audio_s: float            # audio seconds of the window's work
    flops: float              # the model's operations in the window (lib.flops)
    peak_flops: float         # the chip's peak for the configuration's dtype
    attention_ops: list       # lib.flops.AttentionOp of every attention call in the window


def driver_class(root: pathlib.Path, kind: str):
    """The ``Driver`` of ``benchmark/drivers/<kind>.py`` under ``root``."""
    path = (root / "benchmark" / "drivers" / f"{kind}.py").resolve()
    if not kind.isidentifier() or not path.exists():
        raise FileNotFoundError(f"no driver for the traffic kind {kind!r}: {path}")
    if path == (ROOT / "benchmark" / "drivers" / f"{kind}.py").resolve():
        return importlib.import_module(f"benchmark.drivers.{kind}").Driver
    name = f"benchmark.drivers._file_{abs(hash(str(path)))}_{kind}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name].Driver


def read_metric(root: pathlib.Path, name: str, ctx: Context) -> Optional[float]:
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(ctx)
    return None if value is None else float(value)


def cell_metrics(manifest: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` that the cell reports: those listing it,
    those without a list, and (per-layer) those whose end-to-end metric the
    cell reports."""
    e2e = {m["name"] for m in manifest["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in manifest[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def finite(obj):
    """The result with every non-finite number (a missing answer's gap, a
    failed request's latency) as the largest double, so that the line is
    strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return math.copysign(sys.float_info.max, obj) if not math.isnan(obj) else sys.float_info.max
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def seeds(seed: int) -> Dict[str, int]:
    import numpy as np

    names = ("teacher", "student", "served", "step", "data")
    state = np.random.SeedSequence(seed).generate_state(len(names), dtype=np.uint64)
    return {n: int(s) >> 1 for n, s in zip(names, state)}


def main(argv=None, root: Optional[pathlib.Path] = None, device=None) -> int:
    """Run one cell; ``root`` the checkout (default: this file's); a given
    ``device`` skips the look for the chips (the harness's own tests)."""
    t_start = process_start()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = pathlib.Path(root or ROOT)
    cache_env(root)

    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"run: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    bench = root / "benchmark"
    cell = json.loads((bench / "workloads" / f"{args.workload}.json").read_text())
    config = json.loads((bench / "configs" / f"{entry['config']}.json").read_text())
    mix = json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text())
    if cell["config"] != entry["config"] or cell["traffic"] != entry["traffic"]:
        print(f"run: {args.workload}: its file and BENCHMARK.json name different files",
              file=sys.stderr)
        return 2

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"run: {args.workload} needs {entry['chips']} CUDA card(s), found {n}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"

    from benchmark.lib import flops as FL
    from benchmark.lib import trace as TR

    driver = driver_class(root, mix["kind"])(config, mix, seeds(args.seed), device)
    driver.setup()
    setup_s = time.time() - t_start

    from benchmark.lib import program

    launched = program.launches()
    t_window = time.time()
    with TR.recording(bool(args.trace)) as box:
        win = driver.window(args.seconds)
        t_window_end = time.time()
    t_trace = time.time()
    launched = {k: v - launched.get(k, 0) for k, v in program.launches().items()
                if v != launched.get(k, 0)}
    peak_bytes = torch.cuda.max_memory_reserved(device) if on_card else 0
    driver.release()

    # the reference: float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.time()
    found = driver.check()
    timing = {"setup_s": setup_s, "window_s": t_window_end - t_window,
              "trace_read_s": t_trace - t_window_end, "check_s": time.time() - t_check}
    limits = cell["limits"]
    checks = {"failed": {"value": win["failed"], "limit": 0}}
    for name, limit in limits.items():
        checks[name] = {"value": found[name], "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    e2e = dict(win["e2e"], setup_s=setup_s)
    metrics: Dict[str, dict] = {}
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": entry["chips"], "memory_peak_bytes": peak_bytes}
    if args.trace:
        tr = box[0]
        ctx = Context(args.workload, driver.kind, tr, tr.window_s, win["audio_s"], win["flops"],
                      FL.PEAK_FLOPS[driver.dtype], driver.attention_ops())
        for m in cell_metrics(manifest, args.workload, "per_layer"):
            v = read_metric(root, m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
        # the trace must list the kernels inside graph replays: the
        # attention kernels it saw against the wrappers' launch counts
        result["trace_counts"] = {"device_ops": len(tr.ops),
                                  "attention_kernels": tr.count("attention"),
                                  "launches": launched}
    else:
        for m in cell_metrics(manifest, args.workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    result["readings"] = {k: v for k, v in found.items() if k not in limits}
    result["timing"] = timing
    result["checks"] = checks

    bad = loaded_forbidden()
    if bad:
        print(f"run: modules loaded that the benchmark must not load: {bad}", file=sys.stderr)
        return 4
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
