"""The port's pipeline against the TPU package's on the CPU: the data
modules batch for batch, prune surgery, the trainer step for step, resume,
the stop exits, and the four CLI stages end to end on synthetic WAVs.

The models are tiny but keep the real conv stack's stride of 320 samples
per frame (7 conv layers of 32 channels), so clips of 2-4 s give 100-200
frames and the rung ladder of ``build_loader`` applies as it is.
"""

import os
import signal
import struct

import jax
import numpy as np
import pytest
import torch

import dphubert_torch as pt
import dphubert_torch.data as t_data
from dphubert_torch.cli import common as t_common
from dphubert_torch.data import (
    AudioDataset,
    BucketizeBatchSampler,
    DistillDataLoader,
    DistributedBatchSampler,
    StaticShapeBatcher,
    audio_info,
    create_tsv,
    load_audio,
    read_manifest,
)
from dphubert_torch.interop.torch_ckpt import load_checkpoint, model_from_checkpoint, save_checkpoint
from dphubert_torch.models.gates import compile_gates
from dphubert_torch.params import unflatten_params
from dphubert_torch.prune import prune_model
from dphubert_torch.train import DistillConfig, train
from dphubert_tpu import data as j_data
from dphubert_tpu import wav2vec2_model as j_wav2vec2_model
from dphubert_tpu.train import distill_module as j_dm
from dphubert_tpu.train import trainer as j_trainer

from tests.test_torch_gates import PRUNE_FLAGS

SR = 16000


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(**over):
    """Tiny encoder (64 wide, 3 layers of 4 heads x 16) on a conv stack of
    the real strides (320 samples per frame), dropout off."""
    cfg = dict(
        extractor_mode="group_norm",
        extractor_conv_layer_config=[[32, 10, 5]] + [[32, 3, 2]] * 4 + [[32, 2, 2]] * 2,
        extractor_conv_bias=False,
        encoder_embed_dim=64,
        encoder_projection_dropout=0.0,
        encoder_pos_conv_kernel=16,
        encoder_pos_conv_groups=4,
        encoder_num_layers=3,
        encoder_use_attention=[True] * 3,
        encoder_use_feed_forward=[True] * 3,
        encoder_num_heads=[4] * 3,
        encoder_head_dim=16,
        encoder_attention_dropout=0.0,
        encoder_ff_interm_features=[128] * 3,
        encoder_ff_interm_dropout=0.0,
        encoder_dropout=0.0,
        encoder_layer_norm_first=False,
        encoder_layer_drop=0.0,
        aux_num_out=None,
        normalize_waveform=False,
    )
    cfg.update(over)
    return cfg


DROPOUT = dict(encoder_projection_dropout=0.1, encoder_attention_dropout=0.1,
               encoder_ff_interm_dropout=0.1, encoder_dropout=0.1)


def write_wav(path, wave: np.ndarray, sr: int = SR):
    pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """24 training clips of 2-4 s and 8 validation clips, and their
    manifests (``prepare_data`` of the TPU package's layout)."""
    root = tmp_path_factory.mktemp("librispeech")
    rng = np.random.default_rng(0)
    (root / "train-clean-100" / "1" / "2").mkdir(parents=True)
    (root / "dev-clean" / "3" / "4").mkdir(parents=True)
    for i in range(24):
        n = int(rng.integers(32_000, 64_000))
        write_wav(root / "train-clean-100" / "1" / "2" / f"u{i:03d}.wav", 0.1 * rng.standard_normal(n))
    for i in range(8):
        n = int(rng.integers(32_000, 40_000))
        write_wav(root / "dev-clean" / "3" / "4" / f"d{i:03d}.wav", 0.1 * rng.standard_normal(n))
    tsv = tmp_path_factory.mktemp("tsv")
    create_tsv(root, tsv, extension="wav")
    return root, tsv


# ---------------------------------------------------------------------------
# (b) data modules, batch for batch
# ---------------------------------------------------------------------------


def test_manifest_and_audio_match(corpus, tmp_path):
    root, tsv = corpus
    j_tsv = tmp_path / "j"
    j_data.create_tsv(root, j_tsv, extension="wav")
    for subset in ("train100", "train960", "valid"):
        assert (tsv / f"{subset}.tsv").read_text() == (j_tsv / f"{subset}.tsv").read_text()
        got, want = read_manifest(tsv, subset), j_data.read_manifest(tsv, subset)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    paths, _, lengths = read_manifest(tsv, "train100")
    for path, n in zip(paths[:6], lengths[:6]):
        wave, sr = load_audio(path)
        j_wave, j_sr = j_data.load_audio(path)
        assert sr == j_sr == SR and wave.shape == (1, n)
        np.testing.assert_array_equal(wave, j_wave)
        assert audio_info(path) == j_data.audio_info(path) == (n, SR, 1)
    # the numpy reader (the fallback without a C++ compiler) reads the same
    from dphubert_torch.data.audio import _read_wav

    np.testing.assert_array_equal(_read_wav(paths[0])[0], load_audio(paths[0])[0])


@pytest.mark.parametrize("feed_dtype", ["int16", "float32"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_match_bit_for_bit(corpus, feed_dtype, drop_last):
    """Every batch of two epochs, with and without a resume skip, threads
    and no threads, equals the TPU package's: same rungs, same rows, same
    crops, same int16 values.  drop_last=False exercises the tail tiling."""
    _, tsv = corpus
    kw = dict(max_token_count=5 * SR, min_len=32000, max_len=64000, num_shapes=4, seed=3,
              drop_last=drop_last)
    ds, j_ds = AudioDataset(tsv, "train100"), j_data.AudioDataset(tsv, "train100")
    batcher = StaticShapeBatcher(ds.len_list, **kw)
    j_batcher = j_data.StaticShapeBatcher(j_ds.len_list, **kw)
    assert batcher.rungs == j_batcher.rungs and batcher.shapes == j_batcher.shapes
    for workers in (0, 2):
        loader = DistillDataLoader(ds, batcher, num_workers=workers, seed=5, feed_dtype=feed_dtype)
        j_loader = j_data.DistillDataLoader(j_ds, j_batcher, num_workers=workers, seed=5,
                                            feed_dtype=feed_dtype)
        assert len(loader) == len(j_loader) > 2
        for epoch, skip in ((0, 0), (1, 0), (1, 2)):
            got = list(loader.epoch(epoch, skip=skip))
            want = list(j_loader.epoch(epoch, skip=skip))
            assert len(got) == len(want) == len(loader) - skip
            for (w, lens), (jw, jlens) in zip(got, want):
                assert lens is None and jlens is None  # training batches carry no lengths
                assert w.dtype == jw.dtype == np.dtype(feed_dtype)
                np.testing.assert_array_equal(w, jw)


def test_bucketize_samplers_match():
    rng = np.random.default_rng(1)
    lengths = rng.integers(1000, 30000, 200).tolist()
    for kw in (dict(max_token_count=60000), dict(batch_size=7, drop_last=True),
               dict(batch_size=7, shuffle=False)):
        s = BucketizeBatchSampler(lengths, num_buckets=5, min_len=2000, seed=4, **kw)
        j = j_data.BucketizeBatchSampler(lengths, num_buckets=5, min_len=2000, seed=4, **kw)
        for epoch in (0, 3):
            s.set_epoch(epoch)
            j.set_epoch(epoch)
            assert [list(b) for b in s] == [list(b) for b in j]
            for rank in range(3):
                d = DistributedBatchSampler(s, 3, rank, seed=2, epoch=epoch)
                jd = j_data.DistributedBatchSampler(j, 3, rank, seed=2, epoch=epoch)
                assert list(d) == list(jd) and len(d) == len(jd)
    # StaticShapeBatcher's same-rung runs
    for run_length in (1, 3):
        kw = dict(max_token_count=90000, min_len=2000, max_len=30000, num_shapes=5, seed=9,
                  run_length=run_length, drop_last=False)
        a = StaticShapeBatcher(lengths, **kw).epoch_batches(2)
        b = j_data.StaticShapeBatcher(lengths, **kw).epoch_batches(2)
        assert [(r, list(i)) for r, i in a] == [(r, list(i)) for r, i in b]


# ---------------------------------------------------------------------------
# (c) prune surgery
# ---------------------------------------------------------------------------


def _gated_params(seed: int, flags: dict):
    """The TPU package's init of a gated tiny model, with log_alphas drawn
    so that surgery removes heads, FFN units (and conv channels where
    ``flags`` prune them), the attention sublayer of layer 1 and the FFN
    sublayer of layer 2."""
    cfg = tiny_config(**flags)
    jm = j_wav2vec2_model(**cfg)
    flat = pt.flatten_params(jax.tree.map(np.asarray, jm.init(jax.random.key(seed))))
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith("log_alpha"):
            flat[k] = rng.normal(0.5, 3.0, v.shape).astype(np.float32)
    layers = "encoder.transformer.layers"
    flat[f"{layers}.1.attention.hard_concrete_for_layer.log_alpha"] = np.full(1, -8.0, np.float32)
    flat[f"{layers}.2.feed_forward.hard_concrete_for_layer.log_alpha"] = np.full(1, -8.0, np.float32)
    for i in (0, 2):
        flat[f"{layers}.{i}.attention.hard_concrete_for_layer.log_alpha"] = np.full(1, 6.0, np.float32)
    return cfg, jm, flat


@pytest.mark.parametrize("prune_conv", [True, False])
def test_prune_model_matches_and_reloads(prune_conv):
    """The same pruned config and a bit-identical state dict as the TPU
    package's ``prune_model``, and a strict reload.  Without conv-channel
    pruning the reloaded model gives the gated model's per-layer outputs
    under its eval masks within 1e-4; with it, the feature projection's
    LayerNorm no longer sees the zeroed channels, so outputs differ, in the
    reference and the TPU package too (tests/test_surgery.py)."""
    flags = dict(PRUNE_FLAGS, extractor_prune_conv_channels=prune_conv)
    cfg, jm, flat = _gated_params(seed=7, flags=flags)
    j_model, j_params = jm.prune(jax.tree.map(np.asarray, unflatten_params(flat)))
    j_sd = pt.flatten_params(jax.tree.map(np.asarray, j_params))
    gated = pt.wav2vec2_model(device="cpu", **cfg)
    gated.load_state_dict(pt.state_dict_from_jax(flat))
    new_cfg, new_sd = prune_model(gated.spec, gated.state_dict())
    assert new_cfg == j_model.config
    assert new_cfg["encoder_use_attention"][1] is False
    assert new_cfg["encoder_use_feed_forward"][2] is False
    assert 0 < min(new_cfg["encoder_num_heads"][::2]) and min(new_cfg["encoder_num_heads"]) < 4
    assert (new_cfg["extractor_conv_layer_config"][0][0] < 32) == prune_conv
    assert set(new_sd) == set(j_sd)
    for k, v in j_sd.items():
        np.testing.assert_array_equal(new_sd[k], v, err_msg=k)

    pruned = model_from_checkpoint({"config": new_cfg, "state_dict": new_sd}, device="cpu")
    wave = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40000)).astype(np.float32))
    lens = torch.tensor([40000, 31000])
    gates = compile_gates(gated.spec, unflatten_params(dict(gated.named_parameters())))
    with torch.no_grad():
        want, want_lens = gated.extract_features(wave, lens, gates=gates)
        got, got_lens = pruned.extract_features(wave, lens)
    assert torch.equal(got_lens, want_lens)
    for i, (a, b) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(a).all())
        if not prune_conv:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, err_msg=f"layer {i}")


# ---------------------------------------------------------------------------
# (d) the final-distill trainer against the TPU package's, step for step
# ---------------------------------------------------------------------------


def _read_metrics(path):
    import json

    return [json.loads(line) for line in open(path)]


def test_final_distill_trainer_matches_jax(corpus, tmp_path):
    """``train`` with use_reg=False (the final distill), projections warm
    started from a state dict, dropout off, on the real loaders (int16
    feed, two epochs of three batches: 4 updates cross an epoch end and its
    validation), against the TPU package's ``train``: the loss at every
    step within 1e-5 relative, every parameter after the last within 2e-5
    absolute (fp32 on the CPU, summation order only)."""
    _, tsv = corpus
    cfg_t, cfg_s = tiny_config(), tiny_config(encoder_ff_interm_features=[96, 80, 128])
    jt, js = j_wav2vec2_model(**cfg_t), j_wav2vec2_model(**cfg_s)
    tp, sp = jt.init(jax.random.key(0)), js.init(jax.random.key(1))
    groups = ((0,), (1, 3))
    proj_sd = {}
    for slot in range(3):
        src = min(slot, 1)  # slots 1 and 2 carry group 1's shared weights
        r = np.random.default_rng(10 + src)
        proj_sd[f"{slot}.weight"] = (np.eye(64) + 0.05 * r.standard_normal((64, 64))).astype(np.float32)
        proj_sd[f"{slot}.bias"] = (0.01 * r.standard_normal(64)).astype(np.float32)
    kw = dict(distill_layer_groups=groups, warmup_updates=2, max_updates=4, use_reg=False,
              learning_rate=2e-3)

    def loaders(mod):
        ds = mod.AudioDataset(tsv, "train100")
        b = mod.StaticShapeBatcher(ds.len_list, max_token_count=16 * SR, min_len=32000,
                                   max_len=250000, num_shapes=2, seed=1)
        v = mod.AudioDataset(tsv, "valid")
        vb = mod.StaticShapeBatcher(v.len_list, max_token_count=16 * SR, min_len=32000,
                                    max_len=250000, num_shapes=2, seed=1)
        return (mod.DistillDataLoader(ds, b, num_workers=0, seed=1, feed_dtype="int16"),
                mod.DistillDataLoader(v, vb, num_workers=0, seed=1, feed_dtype="int16"))

    jl, jv = loaders(j_data)
    assert len(jl) == 3  # 4 updates run into the second epoch
    j_state = j_trainer.train(
        teacher=jt, teacher_params=tp, student=js, student_params=sp,
        cfg=j_dm.DistillConfig(**kw), loader=jl, valid_loader=jv, exp_dir=tmp_path / "j",
        log_interval=1, ckpt_interval=100, proj_state_dict=proj_sd,
    )
    teacher = pt.wav2vec2_model(device="cpu", **cfg_t)
    teacher.load_state_dict(pt.state_dict_from_jax(tp))
    student = pt.wav2vec2_model(device="cpu", **cfg_s)
    student.load_state_dict(pt.state_dict_from_jax(sp))
    tl, tv = loaders(t_data)
    state = train(teacher=teacher, student=student, cfg=DistillConfig(**kw), loader=tl,
                  valid_loader=tv, exp_dir=tmp_path / "t", log_interval=1, ckpt_interval=100,
                  proj_state_dict=proj_sd, device="cpu")
    want = _read_metrics(tmp_path / "j" / "metrics.jsonl")
    got = _read_metrics(tmp_path / "t" / "metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        for key in ("loss", "loss_l1", "loss_cos", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=f"step {g['step']} {key}")
        assert g["updates"] == w["updates"]
    want_params = pt.train_params_from_jax(jax.tree.map(np.asarray, j_state.params))
    assert state.step == int(j_state.step) == 4
    for k, p in state.named_params().items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[k].numpy(), rtol=0, atol=2e-5,
                                   err_msg=k)
    assert (tmp_path / "t" / "ckpts" / "last.pt").exists()


# ---------------------------------------------------------------------------
# (e) resume, (f) stop exits
# ---------------------------------------------------------------------------


def _stage1_run(tsv, exp_dir, **kw):
    torch.manual_seed(0)
    cfg_t = tiny_config()
    teacher = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(0), **cfg_t)
    student = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(1),
                                **tiny_config(**PRUNE_FLAGS, **DROPOUT))
    ds = AudioDataset(tsv, "train100")
    loader = DistillDataLoader(ds, StaticShapeBatcher(ds.len_list, max_token_count=16 * SR,
                                                      num_shapes=2, seed=1),
                               num_workers=2, seed=1, feed_dtype="int16")
    cfg = DistillConfig(distill_layer_groups=((0,), (1, 3)), warmup_updates=2, max_updates=5,
                        sparsity_warmup_updates=2, target_sparsity=0.5, learning_rate=2e-3)
    return train(teacher=teacher, student=student, cfg=cfg, loader=loader, exp_dir=exp_dir,
                 log_interval=1, ckpt_interval=100, device="cpu", **kw)


def test_stage1_resume_is_bit_exact(corpus, tmp_path):
    """Stage 1 with gates and dropout on (both drawn from the state's
    generator): stopped after update 2 and resumed from ``last.pt`` to
    update 5, across an epoch end, it equals the uninterrupted run bit for
    bit: every parameter, moment, λ and the metrics of the resumed steps."""
    _, tsv = corpus
    full = _stage1_run(tsv, tmp_path / "full")
    stop_info = {}
    part = _stage1_run(tsv, tmp_path / "part", stop_at_step=2, stop_info=stop_info)
    assert stop_info["why"] == "stop_at_step" and part.step == 2
    ckpt = torch.load(tmp_path / "part" / "ckpts" / "last.pt", weights_only=True)
    assert (ckpt["epoch"], ckpt["batch_in_epoch"], ckpt["step"]) == (0, 2, 2)
    resumed = _stage1_run(tsv, tmp_path / "part", resume=tmp_path / "part" / "ckpts" / "last.pt")
    assert resumed.step == full.step == 5
    for (k, a), (_, b) in zip(full.named_params().items(), resumed.named_params().items()):
        assert torch.equal(a, b), k
    for k in full.opt_state.mu:
        assert torch.equal(full.opt_state.mu[k], resumed.opt_state.mu[k]), k
        assert torch.equal(full.opt_state.nu[k], resumed.opt_state.nu[k]), k
    assert torch.equal(full.generator.get_state(), resumed.generator.get_state())
    want = _read_metrics(tmp_path / "full" / "metrics.jsonl")[2:]
    got = _read_metrics(tmp_path / "part" / "metrics.jsonl")[2:]
    assert [r["step"] for r in got] == [3, 4, 5]
    for g, w in zip(got, want):
        for key in ("loss", "loss_reg", "grad_norm", "lambda1", "sparsity_expected"):
            assert g[key] == w[key], (g["step"], key)


def _common_flags(tsv, teacher):
    return ["--tsv_dir", str(tsv), "--train_subset", "train100", "--seconds_per_batch", "16",
            "--num_workers", "2", "--num_shapes", "2", "--precision", "fp32",
            "--teacher_ckpt", str(teacher), "--log_interval", "1", "--warmup_updates", "2",
            "--distill_layers", "0.1,3", "--device", "cpu"]


@pytest.fixture(scope="module")
def teacher_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("pretrained") / "teacher.pth"
    cfg = tiny_config()
    model = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(0), **cfg)
    save_checkpoint(path, cfg, model.state_dict())
    return path


def test_deadline_exits_76_and_sigterm_exits_75(corpus, teacher_ckpt, tmp_path, monkeypatch):
    """A deadline in the past stops stage 1 after its first step with a
    checkpoint and exit code 76, before any export; resuming with
    --resume_checkpoint finishes the stage.  A SIGTERM during training
    checkpoints and exits 75."""
    from dphubert_torch.cli import distill
    from dphubert_torch.train import trainer

    _, tsv = corpus
    exp = tmp_path / "stage1"
    argv = _common_flags(tsv, teacher_ckpt) + ["--student_ckpt", str(teacher_ckpt),
                                               "--exp_dir", str(exp), "--max_updates", "3"]
    monkeypatch.setenv("DPHUBERT_DEADLINE_TS", "1")  # 1970: always past
    with pytest.raises(SystemExit) as stop:
        distill.cli_main(argv)
    assert stop.value.code == 76
    last = exp / "ckpts" / "last.pt"
    assert torch.load(last, weights_only=True)["step"] == 1
    assert not (exp / "ckpts" / "distilled.pth").exists()
    monkeypatch.delenv("DPHUBERT_DEADLINE_TS")
    state = distill.cli_main(argv + ["--resume_checkpoint", str(last)])
    assert state.step == 3 and (exp / "ckpts" / "distilled.pth").exists()

    real_iter = trainer._epoch_iter

    def sigterm_after_first_batch(loader, epoch, skip):
        for i, batch in enumerate(real_iter(loader, epoch, skip)):
            yield batch
            if i == 0:
                os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(trainer, "_epoch_iter", sigterm_after_first_batch)
    exp2 = tmp_path / "stage1b"
    handler = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as stop:
        distill.cli_main(_common_flags(tsv, teacher_ckpt) + [
            "--student_ckpt", str(teacher_ckpt), "--exp_dir", str(exp2), "--max_updates", "3"])
    assert stop.value.code == 75
    assert torch.load(exp2 / "ckpts" / "last.pt", weights_only=True)["step"] == 1
    assert not (exp2 / "ckpts" / "distilled.pth").exists()
    assert signal.getsignal(signal.SIGTERM) == handler  # the trainer's handler is gone


# ---------------------------------------------------------------------------
# (g) the four CLI stages
# ---------------------------------------------------------------------------


def test_full_pipeline_cpu(corpus, teacher_ckpt, tmp_path):
    """prepare_data -> distill (gates and Lagrangian) -> prune -> final
    distill -> save_final_ckpt -> load_dpmodel, through the port's CLI
    functions with --device cpu: the torch counterpart of
    tests/test_pipeline_e2e.py."""
    from dphubert_torch.cli import (
        distill,
        final_distill,
        load_dpmodel,
        prepare_data,
        prune,
        save_final_ckpt,
    )

    root, _ = corpus
    tsv = tmp_path / "tsv"
    prepare_data.cli_main(["--data", str(root), "--out", str(tsv), "--extension", "wav"])
    assert len((tsv / "train100.tsv").read_text().strip().splitlines()) == 25
    common = _common_flags(tsv, teacher_ckpt)
    exp1, exp2 = tmp_path / "stage1", tmp_path / "stage2"

    distill.cli_main(common + [
        "--student_ckpt", str(teacher_ckpt), "--exp_dir", str(exp1), "--max_updates", "4",
        "--sparsity_warmup_updates", "2", "--target_sparsity", "0.5",
        "--pruning_units", "conv,head,interm,attlayer,ffnlayer",
    ])
    distilled = exp1 / "ckpts" / "distilled.pth"
    ck = load_checkpoint(distilled)
    assert any("hard_concrete" in k for k in ck["state_dict"])
    assert set(ck["distill_linear_projs"]) == {"0.weight", "0.bias", "1.weight", "1.bias",
                                               "2.weight", "2.bias"}
    assert ck["config"]["encoder_prune_attention_heads"] is True

    prune.cli_main(["--distilled_ckpt", str(distilled), "--original_ckpt", str(teacher_ckpt)])
    pruned = distilled.parent / "pruned_hubert_base.pth"
    pk = load_checkpoint(pruned)
    assert not any("hard_concrete" in k for k in pk["state_dict"])
    assert pk["config"]["extractor_prune_conv_channels"] is False

    state = final_distill.cli_main(common + ["--student_ckpt", str(pruned),
                                             "--exp_dir", str(exp2), "--max_updates", "2"])
    assert state.lambdas is None and state.step == 2
    distilled2 = exp2 / "ckpts" / "distilled.pth"

    save_final_ckpt.cli_main(["--config_path", str(pruned),
                              "--ckpt_after_final_distill", str(distilled2)])
    final = distilled2.parent / "pruned_hubert_base.pth"
    load_dpmodel.cli_main([str(final), "--device", "cpu"])
    model = model_from_checkpoint(load_checkpoint(final), device="cpu")
    with torch.no_grad():
        outs, _ = model.extract_features(torch.zeros(1, 32000))
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    n_teacher = sum(v.size for v in load_checkpoint(teacher_ckpt)["state_dict"].values())
    n_final = sum(v.size for v in load_checkpoint(final)["state_dict"].values())
    assert n_final < n_teacher


def test_merge_params_overlays_where_keys_coincide():
    template = {"a": 1, "b": 2, "gate.log_alpha": 3}
    assert t_common.merge_params(template, {"a": 10, "b": 20, "extra": 5}) == {
        "a": 10, "b": 20, "gate.log_alpha": 3}
