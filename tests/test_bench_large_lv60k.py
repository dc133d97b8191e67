"""wav2vec 2.0 Large LV-60k's layout through the stage-1 step with remat, on
the CPU at a tiny size: a LayerNorm after every extractor conv with conv
bias, a pre-LN encoder, the waveform normalised per clip over its valid
samples, all five gates on, dropout on.

* The port against the benchmark's plain reference
  (``benchmark/reference/normalized.py`` over ``model.py``): the hidden
  states, the distill loss and every leaf's gradient of one step on a
  batch with a padded clip; the same reference without the normalisation,
  or with post-LN, is far outside those bounds.
* The reference taken in slices equals it taken whole.
* The remat step equals the plain step; ``remat_layer`` counts layers x
  steps.
* The harness finds the cell ``wav2vec2_large_lv60k.distill_remat``'s
  files and its ``distill_remat`` driver, and a tiny cell of that kind,
  added as files only, runs through ``run.main`` and is correct, and not
  correct with the timed path broken.
* The K-step graphs, and the cell's driver on a CUDA device from its
  set-up on, make the allocator's segments expandable unless
  ``PYTORCH_CUDA_ALLOC_CONF`` names the setting."""

import contextlib
import io
import json
import pathlib
from dataclasses import replace

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.drivers import distill, distill_remat
from benchmark.lib import flops as FL
from benchmark.lib.program import distill_config, load_model
from benchmark.reference import distill as RD
from benchmark.reference import model as M
from benchmark.reference import normalized as RN
from benchmark.tests import tiny
from dphubert_torch.ops import kernel_launches
from dphubert_torch.train import init_train_state, make_grad_fn, make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "wav2vec2_large_lv60k.distill_remat"


def lv60k_config(prune: bool = False, **over) -> dict:
    """``tiny.model_config`` in the LV-60k layout: 3 layers, 128 wide."""
    c = tiny.model_config(prune=prune)
    c.update(extractor_mode="layer_norm", extractor_conv_bias=True, encoder_layer_norm_first=True,
             normalize_waveform=True, encoder_ff_interm_dropout=0.1, **over)
    return c


TEACHER, STUDENT = lv60k_config(), lv60k_config(prune=True)


def weights():
    return (M.make_params(TEACHER, torch.Generator().manual_seed(1)),
            M.make_params(STUDENT, torch.Generator().manual_seed(2)))


def batch():
    """Three clips of 1 s, the second padded after 0.75 s; an offset, so
    that the normalisation has a mean to take away."""
    wave = 0.1 * torch.randn(3, 16000, generator=torch.Generator().manual_seed(11)) + 0.05
    return wave, torch.tensor([16000, 12000, 16000])


def port_step(tp, sp):
    """(metrics, gradients) of one port step (fp32, the state's generator
    seeded 77)."""
    cfg = distill_config(tiny.RECIPE, "float32")
    state, _ = init_train_state(student=load_model(STUDENT, sp, "cpu"), cfg=cfg,
                                teacher_embed_dim=128, device="cpu")
    state.generator.manual_seed(77)
    return make_grad_fn(load_model(TEACHER, tp, "cpu"), cfg)(state, batch())


def reference_step(tp, sp, teacher=TEACHER, student=STUDENT, **kw):
    trainer = RN.Trainer(teacher, tp, student, sp, RD.Recipe.of(tiny.RECIPE), **kw)
    wave, lengths = batch()
    return trainer.loss_and_grads(wave, M.Draws(torch.Generator().manual_seed(77)),
                                  lengths=lengths)


def grad_gaps(got, want):
    """Each leaf's relative gap, against at least a thousandth of the
    median leaf's norm: a key bias's gradient is 0 but for round-off
    (softmax ignores a shift of a row), and so is the gap of two sums of
    round-off."""
    med = float(np.median([g.norm().item() for g in want.values()]))
    return {n: ((got[n] - g).norm() / max(g.norm().item(), 1e-3 * med)).item()
            for n, g in want.items()}


def test_hidden_states_match_the_reference():
    tp, _ = weights()
    wave, lengths = batch()
    with torch.no_grad():
        got, got_len = load_model(TEACHER, tp, "cpu").extract_features(wave, lengths)
        want, want_len = RN.extract_features(tp, TEACHER, wave, lengths)
    assert got_len.tolist() == want_len.tolist() == [799, 599, 799]
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_distill_loss_and_every_gradient_match_the_reference():
    tp, sp = weights()
    metrics, grads = port_step(tp, sp)
    loss, want = reference_step(tp, sp)
    assert metrics["loss"].item() == pytest.approx(loss.item(), rel=1e-6)
    assert set(grads) == set(want)
    gaps = grad_gaps(grads, want)
    assert max(gaps.values()) <= 1e-5, max(gaps.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("layout", [dict(normalize_waveform=False),
                                    dict(encoder_layer_norm_first=False)],
                         ids=["unnormalized", "post_ln"])
def test_a_reference_of_another_layout_fails_the_comparison(layout):
    tp, sp = weights()
    metrics, grads = port_step(tp, sp)
    loss, want = reference_step(tp, sp, dict(TEACHER, **layout), dict(STUDENT, **layout))
    gap = abs(metrics["loss"].item() - loss.item()) / abs(loss.item())
    assert gap > 1e-3 or max(grad_gaps(grads, want).values()) > 1e-2


def test_the_reference_in_slices_equals_it_whole():
    """One clip a slice (0.99 s of audio) against the whole batch, dropout
    and gates drawn once for the batch."""
    tp, sp = weights()
    loss, whole = reference_step(tp, sp)
    sliced_loss, sliced = reference_step(tp, sp, slice_seconds=0.99)
    assert sliced_loss.item() == pytest.approx(loss.item(), rel=1e-6)
    assert max(grad_gaps(sliced, whole).values()) <= 1e-5


def test_remat_step_equals_the_plain_step_and_counts_layers_times_steps():
    tp, sp = weights()
    teacher = load_model(TEACHER, tp, "cpu")
    pcm = (3000 * torch.randn(2, 2, 8000, generator=torch.Generator().manual_seed(3))).to(
        torch.int16).numpy()
    out = {}
    for remat in (False, True):
        cfg = distill_config(tiny.RECIPE, "float32")
        cfg = replace(cfg, remat=remat)
        state, tx = init_train_state(student=load_model(STUDENT, sp, "cpu"), cfg=cfg,
                                     teacher_embed_dim=128, device="cpu")
        state.generator.manual_seed(77)
        before = kernel_launches()["remat_layer"]
        state, metrics = make_train_step(teacher, cfg, tx, steps_per_call=2)(state, (pcm, None))
        counted = kernel_launches()["remat_layer"] - before
        out[remat] = (metrics["loss"], state.named_params(), state.generator.get_state(), counted)
    (l0, p0, g0, c0), (l1, p1, g1, c1) = out[False], out[True]
    assert (c0, c1) == (0, 3 * 2)  # 3 layers, 2 steps
    assert torch.equal(g0, g1)
    assert torch.allclose(l0, l1, rtol=1e-6, atol=0)
    for n, p in p0.items():
        assert (p1[n] - p).abs().max() <= 1e-6, n


def test_the_harness_finds_the_cell_and_its_driver():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in man["workloads"] if w["name"] == CELL)
    assert entry["chips"] == 1
    config = next(c for c in man["configs"] if c["name"] == entry["config"])
    assert config["reduced"] == []
    bench = ROOT / "benchmark"
    cell = json.loads((bench / "workloads" / f"{CELL}.json").read_text())
    assert (cell["config"], cell["traffic"]) == (entry["config"], entry["traffic"])
    cfg = json.loads((ROOT / config["file"]).read_text())
    base = json.loads((bench / "configs" / "hubert_base.json").read_text())
    assert list(cfg) == list(base) and cfg["recipe"]["remat"] is True
    assert set(cfg["recipe"]) == set(base["recipe"]) | {"remat"}
    for model in ("teacher", "student"):
        assert list(cfg[model]) == list(base[model])
        a = M.arch(cfg[model])
        assert (a.embed, a.head_dim, len(a.layers), a.layers[0].heads, a.layers[0].ffn) == (
            1024, 64, 24, 16, 4096)
        assert not a.group_norm and a.conv_bias and not a.post_norm
        assert cfg[model]["normalize_waveform"] is True
    mix = json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text())
    assert mix["kind"] == "distill_remat"
    assert [distill.ladder(mix)[i] for i in mix["kept_rungs"]] == [
        (90, 32000), (29, 97920), (11, 249920)]
    assert distill.cycle_counts(mix) == [1, 2, 5]
    driver = run.driver_class(ROOT, mix["kind"])
    assert driver is distill_remat.Driver and issubclass(driver, distill.Driver)
    e2e = {m["name"] for m in run.cell_metrics(man, CELL, "end_to_end")}
    assert e2e == {"train_audio_s_per_s", "train_peak_gib", "setup_s"}
    assert {m["name"] for m in run.cell_metrics(man, CELL, "per_layer")} == {
        "mfu.train", "idle_share.train", "dispatch_idle_share.train", "conv_ms.train",
        "elementwise_ms.train", "attn_roofline.train"}


TINY = "tiny_lv60k.distill_remat"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny benchmark tree with a tiny LV-60k cell of kind
    ``distill_remat`` added as files, under the real cell's limits."""
    limits = json.loads((ROOT / "benchmark" / "workloads" / f"{CELL}.json").read_text())["limits"]
    root = tiny.write_tree(tmp_path_factory.mktemp("bench"))
    b = root / "benchmark"
    (b / "configs" / "tiny_lv60k.json").write_text(json.dumps(
        {"name": "tiny_lv60k", "source": "tests", "reduced": [], "precision": "float32",
         "teacher": TEACHER, "student": STUDENT, "served": TEACHER,
         "recipe": dict(tiny.RECIPE, remat=True)}))
    (b / "traffic" / "tiny_distill_remat.json").write_text(
        json.dumps(dict(tiny.MIXES["tiny_distill"], kind="distill_remat")))
    (b / "workloads" / f"{TINY}.json").write_text(json.dumps(
        {"config": "tiny_lv60k", "traffic": "tiny_distill_remat", "limits": limits}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": TINY, "config": "tiny_lv60k", "traffic": "tiny_distill_remat",
                             "chips": 1, "why": "tests"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "tiny_hubert.distill" in m.get("workloads", []):
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def _half_batch(monkeypatch):
    """The program's step sees half of each batch."""
    from dphubert_torch.train import distill_module

    whole = distill_module._batch

    def half(batch, dtype, device):
        wave, lengths = whole(batch, dtype, device)
        return wave[: wave.shape[0] // 2], None if lengths is None else lengths[: wave.shape[0] // 2]

    monkeypatch.setattr(distill_module, "_batch", half)


@pytest.mark.parametrize("fault", [None, _half_batch], ids=["sound", "half_batch"])
def test_a_tiny_cell_of_the_kind_runs_and_is_correct_unless_broken(tree, monkeypatch, fault):
    # this suite's conftest loads JAX for other tests' sake, which the
    # harness refuses: here it is not the benchmark's doing
    monkeypatch.setattr(run, "loaded_forbidden", lambda: [])
    if fault is not None:
        fault(monkeypatch)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", TINY, "--seed", str(3_000_000_019), "--seconds", "0.2",
                       "--trace", "0"], root=tree, device="cpu")
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is (fault is None), res["checks"]
    assert set(res["metrics"]) == {"train_audio_s_per_s", "train_peak_gib", "setup_s"}


def test_the_driver_steps_with_remat_and_counts_the_recomputed_attention(tree):
    """The window's steps recompute every student layer once
    (``remat_layer``), and ``attention_ops`` counts one more student
    forward a step than ``distill``'s."""
    cfg = json.loads((tree / "benchmark" / "configs" / "tiny_lv60k.json").read_text())
    mix = json.loads((tree / "benchmark" / "traffic" / "tiny_distill_remat.json").read_text())
    driver = distill_remat.Driver(cfg, mix, run.seeds(5), torch.device("cpu"))
    driver.setup()
    assert driver.remat and driver.step.cfg.remat
    before = kernel_launches()["remat_layer"]
    driver.window(0.0)
    steps = len(driver.done) * driver.K
    assert kernel_launches()["remat_layer"] - before == 3 * steps
    ops = driver.attention_ops()
    assert sum(op.backward for op in ops) == 3 * steps
    assert sum(not op.backward for op in ops) == 3 * 3 * steps
    assert len(distill.Driver.attention_ops(driver)) == 3 * 3 * steps
    assert all(isinstance(op, FL.AttentionOp) for op in ops)


@pytest.mark.parametrize("conf,calls", [("", ["expandable_segments:True"]),
                                         ("max_split_size_mb:512", ["expandable_segments:True"]),
                                         ("expandable_segments:False", [])],
                         ids=["unset", "other_setting", "told_otherwise"])
def test_the_graphs_make_the_allocator_segments_expandable_unless_told(monkeypatch, conf, calls):
    """``GraphedSteps``' first capture turns on ``expandable_segments``
    (the Large cell's reserved memory otherwise moved by 2.5 GB from run to
    run), unless ``PYTORCH_CUDA_ALLOC_CONF`` names the setting."""
    from dphubert_torch.train import distill_module

    got = []
    monkeypatch.setattr(torch._C, "_accelerator_setAllocatorSettings", got.append, raising=False)
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", conf)
    distill_module.expandable_segments()
    assert got == calls


@pytest.mark.parametrize("device,conf,calls",
                         [("cuda", "", ["expandable_segments:True"]),
                          ("cuda", "max_split_size_mb:512", ["expandable_segments:True"]),
                          ("cuda", "expandable_segments:False", []),
                          ("cpu", "", [])],
                         ids=["unset", "other_setting", "told_otherwise", "cpu"])
def test_the_cell_driver_makes_the_allocator_segments_expandable_on_a_card(
        monkeypatch, device, conf, calls):
    """The cell's driver turns on ``expandable_segments`` before set-up's
    first allocation on a CUDA device, so that ``train_peak_gib`` reads the
    same on a program that does not set it itself; never on the CPU."""
    got = []
    monkeypatch.setattr(torch._C, "_accelerator_setAllocatorSettings", got.append, raising=False)
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", conf)
    distill_remat.expandable_segments(torch.device(device))
    assert got == calls
