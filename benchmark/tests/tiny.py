"""A tiny benchmark tree for the CPU tests: configurations, mixes and cells
of the same kinds as the real ones, at a size the CPU runs in seconds,
written as new files into a directory of their own (no file of the
benchmark is edited to add them)."""

from __future__ import annotations

import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parents[1]
PRUNE = ("extractor_prune_conv_channels", "encoder_prune_attention_heads",
         "encoder_prune_attention_layer", "encoder_prune_feed_forward_intermediate",
         "encoder_prune_feed_forward_layer")


def model_config(wavlm: bool = False, layers: int = 3, prune: bool = False) -> dict:
    n = layers
    c = dict(
        extractor_mode="group_norm", extractor_conv_layer_config=[[32, 10, 5], [32, 3, 2], [32, 2, 2]],
        extractor_conv_bias=False, encoder_embed_dim=128, encoder_projection_dropout=0.1,
        encoder_pos_conv_kernel=16, encoder_pos_conv_groups=4, encoder_num_layers=n,
        encoder_use_attention=[True] * n, encoder_use_feed_forward=[True] * n,
        encoder_attention_dropout=0.1, encoder_ff_interm_features=[256] * n,
        encoder_ff_interm_dropout=0.1 if wavlm else 0.0, encoder_dropout=0.1,
        encoder_layer_norm_first=False, encoder_layer_drop=0.05, aux_num_out=None,
        normalize_waveform=False)
    if wavlm:
        c.update(encoder_total_num_heads=[2] * n, encoder_remaining_heads=[[0, 1]] * n,
                 encoder_num_buckets=320, encoder_max_distance=800)
    else:
        c.update(encoder_num_heads=[2] * n, encoder_head_dim=64)
    c.update({k: prune for k in PRUNE})
    return c


def served_config(wavlm: bool = False) -> dict:
    c = model_config(wavlm)
    c["encoder_use_attention"] = [True, False, True]
    c["encoder_use_feed_forward"] = [True, True, False]
    c["encoder_ff_interm_features"] = [40, 24, 0]
    if wavlm:
        c["encoder_remaining_heads"] = [[0, 1], [], [1]]
    else:
        c["encoder_num_heads"] = [2, 0, 1]
    return c


RECIPE = {"groups": [[0], [2, 3]], "l1_weight": 1.0, "cos_weight": 1.0, "learning_rate": 2e-4,
          "reg_learning_rate": 0.02, "warmup_updates": 15000, "max_updates": 50000,
          "clip_norm": 10.0, "target_sparsity": 0.75, "sparsity_warmup_updates": 5000}
TABLE = {"bins": [[0.1, 0.2, 30.0], [0.2, 0.35, 50.0], [0.35, 0.6, 20.0]]}
MIXES = {
    "tiny_distill": {"kind": "distill", "assumed": {"length_table": TABLE},
                     "seconds_per_batch": 1.0, "min_len": 3200, "max_len": 8000, "num_shapes": 3,
                     "kept_rungs": [0, 2], "check_rung": 2, "steps_per_dispatch": 3,
                     "cycle_groups": 3, "level": 0.1},
    "tiny_serve": {"kind": "serve", "assumed": {"length_table": TABLE},
                   "clips_per_request": 3, "clip_seconds": [0.1, 0.6], "pool_requests": 4,
                   "check_requests": 2, "length_step": 1600, "max_batch": 2,
                   "dtype": "float32", "level": 0.1, "deal_seed": 0},
}
CELLS = {
    "tiny_hubert.distill": ("tiny_hubert", "tiny_distill", "train"),
    "tiny_hubert.serve": ("tiny_hubert", "tiny_serve", "serve"),
    "tiny_wavlm.distill": ("tiny_wavlm", "tiny_distill", "train"),
    "tiny_wavlm.serve": ("tiny_wavlm", "tiny_serve", "serve"),
}


def write_tree(root: pathlib.Path, limits=None, dtype: str = "float32") -> pathlib.Path:
    """BENCHMARK.json and the tiny cells' files under ``root``, with the
    real drivers and per-layer metric readers beside them."""
    b = root / "benchmark"
    for d in ("configs", "traffic", "workloads"):
        (b / d).mkdir(parents=True, exist_ok=True)
    for d in ("drivers", "metrics"):
        shutil.copytree(BENCH / d, b / d, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, wavlm in (("tiny_hubert", False), ("tiny_wavlm", True)):
        cfg = {"name": name, "source": "tests", "reduced": [], "precision": dtype,
               "teacher": model_config(wavlm), "student": model_config(wavlm, prune=True),
               "served": served_config(wavlm), "recipe": RECIPE}
        (b / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, mix in MIXES.items():
        (b / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    default = {"train": {"loss_gap": 1e-3, "moment_gap": 1e-3, "change_gap": 1e-3},
               "serve": {"feature_gap": 1e-4}}
    workloads = []
    for name, (cfg, mix, kind) in CELLS.items():
        lim = (limits or default)[kind]
        (b / "workloads" / f"{name}.json").write_text(
            json.dumps({"config": cfg, "traffic": mix, "limits": lim}))
        workloads.append({"name": name, "config": cfg, "traffic": mix, "chips": 1, "why": "tests"})
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    train = [n for n, c in CELLS.items() if c[2] == "train"]
    serve = [n for n, c in CELLS.items() if c[2] == "serve"]
    for m in real["end_to_end"] + real["per_layer"]:
        if "workloads" in m:
            m["workloads"] = train if m["workloads"][0].endswith("distill") else serve
    man = dict(real, workloads=workloads,
               configs=[{"name": c, "source": "tests", "file": f"benchmark/configs/{c}.json",
                         "reduced": [], "why": "tests"} for c in ("tiny_hubert", "tiny_wavlm")])
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root
