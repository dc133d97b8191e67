"""The port's WavLM against the TPU package on the CPU: the gated-bias
attention's plain versions against the Pallas kernels in interpret mode and
their ``jax.vjp``, the bucket table, per-layer features, gates and size, a
distill trajectory, prune surgery and the CLI stages.

Inputs come from numpy seeds; every model is tiny (64 wide, 3 layers of 4
heads x 16, as tests/test_forward_parity.py's ``_tiny_wavlm_config``) except
one full-width WavLM Base forward on 1 s.  On the CPU the port's attention
wrappers run their plain versions; the card's tests of the kernels are in
tests/test_torch_attention.py.
"""

import importlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dphubert_torch as pt
from dphubert_torch.interop.torch_ckpt import load_checkpoint, model_from_checkpoint, save_checkpoint
from dphubert_torch.models import components as t_components
from dphubert_torch.models import gates as t_gates
from dphubert_torch.models.size import model_size as t_model_size
from dphubert_torch.ops.attention_common import keep_mask
from dphubert_torch.ops.wavlm_attention import (
    WavLMAttentionFn,
    fused_max_len,
    wavlm_attention,
    wavlm_attention_bwd_dbias,
    wavlm_attention_bwd_dkv,
    wavlm_attention_bwd_dkv_general,
    wavlm_attention_bwd_dq,
    wavlm_attention_bwd_fused,
    wavlm_attention_bwd_reference,
    wavlm_attention_fwd,
    wavlm_attention_fwd_general,
    wavlm_attention_qkv,
    wavlm_route,
)
from dphubert_torch.params import unflatten_params
from dphubert_torch.prune import prune_model
from dphubert_torch.train import DistillConfig, init_train_state, make_train_step
from dphubert_tpu import wav2vec2_model as j_wav2vec2_model
from dphubert_tpu import wavlm_base as j_wavlm_base
from dphubert_tpu.models import components as j_components
from dphubert_tpu.models import gates as j_gates
from dphubert_tpu.models.size import model_size as j_model_size
from dphubert_tpu.params import tree_to_jax
from dphubert_tpu.train import distill_module as j_dm

from tests.test_forward_parity import _tiny_wavlm_config
from tests.test_torch_gates import PRUNE_FLAGS, jax_gate_draws, one_torch_thread  # noqa: F401
from tests.test_torch_pipeline import tiny_config, write_wav

REPO = pathlib.Path(__file__).resolve().parents[1]


def _j_wavlm_attention():
    # importlib: the TPU ops package exports functions named like its modules
    return importlib.import_module("dphubert_tpu.ops.wavlm_attention")


# ---------------------------------------------------------------------------
# The attention's plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _attention_inputs(seed, B, H, L, D):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((H, L, L)).astype(np.float32)
    gate = rng.uniform(0.5, 2.0, (B, H, L)).astype(np.float32)  # around gate_a_1's (1, 2)
    return q, k, v, bias, gate, do


def _jax_wavlm_vjp(q, k, v, bias, gate, do, lengths, rate, key_seed, block_kv):
    """The TPU WavLM kernels in interpret mode: forward and jax.vjp in q, k,
    v, bias and gate, plus the int32 seed the wrapper derives from its key."""
    j_fn = _j_wavlm_attention().wavlm_flash_attention
    j_len = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    rng = jax.random.key(key_seed) if rate else None
    seed = int(jax.random.bits(rng, (1,), jnp.uint32).astype(jnp.int32)[0]) if rate else 0

    def f(*args):
        return j_fn(*args, j_len, interpret=True, block_kv=block_kv, dropout_rate=rate,
                    dropout_rng=rng)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v, bias, gate)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))], seed


@pytest.mark.parametrize("B,H,L,D", [(2, 3, 200, 32), (2, 2, 256, 16)])
@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("block_kv", [None, 128])
def test_plain_attention_matches_pallas_vjp(B, H, L, D, with_lengths, rate, block_kv):
    """out, dq, dk, dv, dbias and dgate of the port (its wrappers' plain
    versions and WavLMAttentionFn) against ``wavlm_flash_attention`` in
    interpret mode and its custom VJP, given the same int32 seed: the single
    route (block_kv None: one KV block of Lp = 256) and the general one
    (block_kv 128: two KV blocks), with and without lengths, dropout off and
    at 0.1.  fp32, bound 1e-5 x max |reference| (summation order only; the
    JAX wrapper pads L to 256 with a zero bias and masks the pad)."""
    q, k, v, bias, gate, do = _attention_inputs(L + B + int(10 * rate) + with_lengths, B, H, L, D)
    lengths = [L, L * 2 // 3] if with_lengths else None
    want, want_grads, seed = _jax_wavlm_vjp(q, k, v, bias, gate, do, lengths, rate,
                                            key_seed=L + D, block_kv=block_kv)
    route = wavlm_route(L, block_kv=block_kv)
    assert route == ("single" if block_kv is None else "general")
    t_len = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    t_seed = torch.tensor([seed], dtype=torch.int32)
    tq, tk, tv, tb, tg = (torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias, gate))
    tdo = torch.from_numpy(do)

    def close(got, ref, what):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0, err_msg=what)

    out, m, l = wavlm_attention(tq.detach(), tk.detach(), tv.detach(), tb.detach(), tg.detach(),
                                t_len, dropout_rate=rate, seed=t_seed, block_kv=block_kv)
    close(out.numpy(), want, "out")
    got = WavLMAttentionFn.apply(tq, tk, tv, tb, tg, t_len, t_seed, D ** -0.5, rate, route)
    np.testing.assert_array_equal(got.detach().numpy(), out.numpy())
    got.backward(tdo)
    for name, t, w in zip(("dq", "dk", "dv", "dbias", "dgate"), (tq, tk, tv, tb, tg), want_grads):
        close(t.grad.numpy(), w, name)

    # every wrapper of the route runs the same plain version on the CPU
    args = [t.detach() for t in (tq, tk, tv, tb, tg)]
    kw = dict(scale=D ** -0.5, dropout_rate=rate, seed=t_seed)
    if route == "single":
        dq, dgate, dbias, di = wavlm_attention_bwd_fused(*args, out, tdo, m, l, t_len, **kw)
        dk, dv = wavlm_attention_bwd_dkv(*args, out, tdo, m, l, di, t_len, **kw)
    else:
        dq, dgate, di = wavlm_attention_bwd_dq(*args, out, tdo, m, l, t_len, **kw)
        dbias = wavlm_attention_bwd_dbias(*args, out, tdo, m, l, t_len, **kw)
        dk, dv = wavlm_attention_bwd_dkv_general(*args, out, tdo, m, l, di, t_len, **kw)
    for name, g, t in zip(("dq", "dk", "dv", "dbias", "dgate"), (dq, dk, dv, dbias, dgate),
                          (tq, tk, tv, tb, tg)):
        np.testing.assert_array_equal(g.numpy(), t.grad.numpy(), err_msg=name)
    np.testing.assert_allclose(di.numpy(), (out * tdo).sum(-1).numpy(), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, -123456789, 2**31 - 1])
def test_dropout_mask_is_the_tpu_packages(seed):
    """The mask the plain versions regenerate, (B, H, L, L) at the
    selected heads' indices, bit for bit the TPU package's
    ``_dropout_keep_mask`` at the same (b, h)."""
    j_mask = importlib.import_module("dphubert_tpu.ops.flash_attention")._dropout_keep_mask
    B, H, L, rate = 2, 3, 40, 0.1
    got = keep_mask(torch.tensor([seed], dtype=torch.int32), rate, B, H, L, "cpu").numpy()
    for b in range(B):
        for h in range(H):
            want = np.asarray(j_mask((L, L), 1.0 - rate, jnp.int32(seed), b, h, 0, 0))
            np.testing.assert_array_equal(got[b, h], want)


def test_routing_and_fused_limit():
    """The routing rule of ``wavlm_flash_attention`` (one KV block of Lp
    unless block_kv cuts it, and the single-block escape hatch) and the
    fused backward's length limit on the card."""
    assert [wavlm_route(L) for L in (49, 749, 780, 1299)] == ["single"] * 4
    assert wavlm_route(749, block_kv=128) == "general"
    assert wavlm_route(100, block_kv=128) == "single"  # Lp = 128: one block
    assert wavlm_route(300, block_kv=256) == "general"  # Lp = 512
    assert (fused_max_len(64), fused_max_len(80)) == (1344, 1216)


def test_plain_attention_fn_gradcheck():
    """gradcheck of WavLMAttentionFn in float64 on the CPU, in q, k, v, bias
    and gate, with lengths and dropout; 2 heads x 4 at L = 12."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 2, 12, 4, dtype=torch.float64, generator=gen, requires_grad=True)
               for _ in range(3))
    bias = torch.randn(2, 12, 12, dtype=torch.float64, generator=gen, requires_grad=True)
    gate = (1 + torch.rand(2, 2, 12, dtype=torch.float64, generator=gen)).requires_grad_()
    lens = torch.tensor([12, 7], dtype=torch.int32)
    seed = torch.tensor([77], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda *a: WavLMAttentionFn.apply(*a, lens, seed, 0.35, 0.2, "single"),
        (q, k, v, bias, gate))


def test_cpu_wrappers_count_nothing_and_forward_only_refuses_grad():
    counters = (wavlm_attention_fwd, wavlm_attention_fwd_general, wavlm_attention_bwd_fused,
                wavlm_attention_bwd_dkv, wavlm_attention_bwd_dq, wavlm_attention_bwd_dbias,
                wavlm_attention_bwd_dkv_general)
    before = [f.launches for f in counters]
    q, k, v, bias, gate, do = (torch.from_numpy(x) for x in _attention_inputs(0, 1, 2, 20, 16))
    qkv = torch.cat([t.transpose(1, 2).reshape(1, 20, 32) for t in (q, k, v)], -1)
    qkv.requires_grad_()
    wavlm_attention_qkv(qkv, bias, gate, num_heads=2).sum().backward()
    assert [f.launches for f in counters] == before
    with pytest.raises(NotImplementedError, match="WavLMAttentionFn"):
        wavlm_attention_fwd(q.requires_grad_(), k, v, bias, gate)


# ---------------------------------------------------------------------------
# The relative-position bias
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,num_buckets,max_distance", [
    (49, 320, 800), (749, 320, 800), (1299, 320, 800), (200, 32, 80), (7, 32, 80)])
def test_bucket_table_is_the_tpu_packages(L, num_buckets, max_distance):
    """The bucket ids bit for bit, and the (TH, L, L) bias gathered from a
    table equal to the TPU package's ``compute_wavlm_bias``."""
    got = t_components._relative_positions_bucket_np(L, num_buckets, max_distance)
    want = j_components._relative_positions_bucket_np(L, num_buckets, max_distance)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    table = np.random.default_rng(L).standard_normal((num_buckets, 4)).astype(np.float32)
    spec = pt.spec_from_config(**_tiny_wavlm_config(
        encoder_num_buckets=num_buckets, encoder_max_distance=max_distance)).layers[0].attention
    got = t_components.compute_wavlm_bias(torch.from_numpy(table), spec, L)
    want = j_components.compute_wavlm_bias({"rel_attn_embed": {"weight": jnp.asarray(table)}},
                                           spec, L)
    assert got.is_contiguous() and got.shape == (4, L, L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Per-layer features
# ---------------------------------------------------------------------------

TINY = {
    "tiny": _tiny_wavlm_config(),
    "pruned_heads": _tiny_wavlm_config(
        encoder_remaining_heads=[[0, 2, 3], [1], [0, 1, 2, 3]]),
    "layer0_attention_pruned": _tiny_wavlm_config(
        encoder_use_attention=[False, True, True],
        encoder_remaining_heads=[[], [0, 1, 2, 3], [1, 3]]),
    "pre_norm": _tiny_wavlm_config(encoder_layer_norm_first=True),
    # the Large family's layout: pre-norm, LayerNorm conv extractor, the
    # waveform normalised
    "large_layout": _tiny_wavlm_config(encoder_layer_norm_first=True, extractor_mode="layer_norm",
                                       normalize_waveform=True),
}


def _pair(cfg, seed):
    """Both packages with the same weights (the port's random init)."""
    tm = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(seed), **cfg)
    flat = {k: v.numpy() for k, v in tm.state_dict().items()}
    return j_wav2vec2_model(**cfg), tree_to_jax(unflatten_params(flat)), tm


def _wave(seed, B, T, lengths=None, scale=1.0):
    rng = np.random.default_rng(seed)
    wave = (scale * rng.standard_normal((B, T))).astype(np.float32)
    for b, n in enumerate(lengths or []):
        wave[b, n:] = 0.0
    return wave


def _compare(jm, params, tm, wave, lengths, atol):
    j_lens = None if lengths is None else np.asarray(lengths, np.int32)
    want, want_lens = jm.extract_features(params, wave, j_lens)
    with torch.no_grad():
        got, got_lens = tm.extract_features(
            torch.from_numpy(wave),
            None if lengths is None else torch.tensor(lengths, dtype=torch.int32))
    assert len(got) == len(want)
    if lengths is not None:
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == np.shape(w), f"layer {i}"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0,
                                   err_msg=f"layer {i}")


@pytest.mark.parametrize("kernels", ["dense", "pallas"])
@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_wavlm_per_layer(name, with_lengths, kernels, monkeypatch):
    """extract_features of every layer against the TPU package's dense path
    (additive -10000 mask, the bias materialised; bound 1e-4 as
    tests/test_forward_parity.py) and against its Pallas kernels in
    interpret mode (``DPHUBERT_FLASH_ATTENTION=1``; bound 2e-4 as
    tests/test_flash_in_model.py).  Layer 0's attention pruned away leaves
    every layer without a bias, as in the TPU package."""
    if kernels == "pallas":
        monkeypatch.setenv("DPHUBERT_FLASH_ATTENTION", "1")
    jm, params, tm = _pair(TINY[name], seed=0)
    lengths = [4000, 3310] if with_lengths else None
    _compare(jm, params, tm, _wave(1, 2, 4000, lengths), lengths,
             atol=1e-4 if kernels == "dense" else 2e-4)


def test_wavlm_base_one_second():
    """Full-width WavLM Base (12 layers of 12 heads x 64, 320 buckets) on
    1 s against the TPU package's dense path, bound 1e-4; the port's
    preset has the TPU package's state-dict keys and shapes."""
    tm = pt.wavlm_base(device="cpu", generator=torch.Generator().manual_seed(2))
    jm = j_wavlm_base()
    assert tm.config == jm.config
    shapes = jax.eval_shape(lambda key: jm.init(key), jax.random.key(0))
    want_keys = {k: tuple(v.shape) for k, v in pt.flatten_params(shapes).items()}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want_keys
    params = tree_to_jax(unflatten_params({k: v.numpy() for k, v in tm.state_dict().items()}))
    _compare(jm, params, tm, _wave(3, 1, 16000, scale=0.1), None, atol=1e-4)


def test_wavlm_large_preset_matches():
    """The port's ``wavlm_large`` (24 layers, 1024 wide, 16 heads x 64)
    has the TPU package's config and state-dict keys and shapes; its layout
    runs per layer in ``test_tiny_wavlm_per_layer[large_layout-...]``."""
    from dphubert_tpu import wavlm_large as j_wavlm_large

    tm = pt.wavlm_large(device="cpu")
    jm = j_wavlm_large()
    assert tm.config == jm.config
    shapes = pt.flatten_params(jax.eval_shape(lambda key: jm.init(key), jax.random.key(0)))
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in shapes.items()}


# ---------------------------------------------------------------------------
# Gates and size
# ---------------------------------------------------------------------------

GATED = _tiny_wavlm_config(**PRUNE_FLAGS)


def test_gates_and_model_size_match():
    """On a gated WavLM: the sampled gate tree (given the TPU package's
    draws) and the compiled one, and model_size with its gradient in every
    log_alpha, against the TPU package (bound 1e-6 relative)."""
    tm, jp = _pair(GATED, seed=1)[2], None
    with torch.no_grad():
        for n, p in tm.named_parameters():
            if n.endswith("log_alpha"):
                p.copy_(torch.from_numpy(np.random.default_rng(p.numel()).normal(
                    1.5, 2.0, p.numel()).astype(np.float32)))
    jp = tree_to_jax(unflatten_params({k: v.numpy() for k, v in tm.state_dict().items()}))
    spec = tm.spec
    tp = unflatten_params(dict(tm.named_parameters()))
    key = jax.random.key(5)
    want = pt.flatten_params(j_gates.sample_gates(spec, jp, key))
    got = pt.flatten_params(t_gates.sample_gates(spec, tp, u=jax_gate_draws(spec, jp, key)))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    want_c = pt.flatten_params(j_gates.compile_gates(spec, jp))
    got_c = pt.flatten_params(t_gates.compile_gates(spec, tp))
    assert list(got_c) == list(want_c)
    for k in want_c:
        np.testing.assert_array_equal(got_c[k].numpy(), want_c[k], err_msg=k)
    want_v, want_g = jax.value_and_grad(lambda p: j_model_size(p, spec))(jp)
    size = t_model_size(tp, spec)
    np.testing.assert_allclose(size.item(), float(want_v), rtol=1e-6)
    size.backward()
    want_flat = pt.flatten_params(jax.tree.map(np.asarray, want_g))
    for n, p in tm.named_parameters():
        if n.endswith("log_alpha"):
            np.testing.assert_allclose(p.grad.numpy(), want_flat[n], rtol=1e-6, atol=1e-3,
                                       err_msg=n)


# ---------------------------------------------------------------------------
# A distill trajectory
# ---------------------------------------------------------------------------


def test_dpwavlm_distill_trajectory_matches():
    """Twelve steps of the port's DPWavLM distill step (gated WavLM student,
    WavLM teacher, dropout off, the TPU step's gate draws injected) against
    make_train_step: every metric at every step within 1e-5 relative (+1e-6
    absolute) and every parameter after the last step within 2e-5 absolute,
    ``rel_attn_embed`` and ``gru_rel_pos_*`` included (fp32 on the CPU: the
    two autodiffs sum in different orders, the bias table's gradient over
    the L x L bucket gather too)."""
    cfg_t, cfg_s = _tiny_wavlm_config(), GATED
    jt, js = j_wav2vec2_model(**cfg_t), j_wav2vec2_model(**cfg_s)
    tp, sp = jt.init(jax.random.key(0)), js.init(jax.random.key(1))
    dcfg = j_dm.DistillConfig(
        distill_layer_groups=((0,), (1, 3)), warmup_updates=4, max_updates=20,
        sparsity_warmup_updates=5, target_sparsity=0.5)
    j_state, j_tx = j_dm.init_train_state(student=js, student_params=sp, cfg=dcfg,
                                          teacher_embed_dim=64, rng=jax.random.key(42))
    j_step = j_dm.make_train_step(jt, js, dcfg, j_tx, donate=False)
    teacher = pt.wav2vec2_model(device="cpu", **cfg_t)
    teacher.load_state_dict(pt.state_dict_from_jax(tp))
    cfg = DistillConfig(**{k: getattr(dcfg, k) for k in DistillConfig.__dataclass_fields__})
    state, tx = init_train_state(student=pt.wav2vec2_model(device="cpu", **cfg_s), cfg=cfg,
                                 teacher_embed_dim=64, device="cpu")
    state.load_params(pt.train_params_from_jax(jax.tree.map(np.asarray, j_state.params)))
    step = make_train_step(teacher, cfg, tx)
    spec = state.student.spec
    wave = np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32)
    for i in range(12):
        _, gate_key, _ = jax.random.split(j_state.rng, 3)
        gate_u = jax_gate_draws(spec, j_state.params["student"], gate_key)
        j_state, want = j_step(j_state, tp, (jnp.asarray(wave), None))
        state, got = step(state, (wave, None), gate_u=gate_u)
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
    want_params = pt.train_params_from_jax(jax.tree.map(np.asarray, j_state.params))
    names = state.named_params()
    assert any("rel_attn_embed" in n for n in names) and any("gru_rel_pos_const" in n
                                                             for n in names)
    for k, p in names.items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[k].numpy(), rtol=0, atol=2e-5,
                                   err_msg=k)
    # the bias table moved: its gradient reached it from every layer
    init = pt.train_params_from_jax(jax.tree.map(np.asarray, {"student": sp}))
    table = "student.encoder.transformer.layers.0.attention.rel_attn_embed.weight"
    assert not torch.equal(names[table].detach(), init[table])


# ---------------------------------------------------------------------------
# Prune surgery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layer0_dies", [False, True])
def test_wavlm_prune_surgery_matches(layer0_dies):
    """WavLM surgery on a gated tiny WavLM with log_alphas drawn so that
    heads, FFN units and channels go, and the attention sublayer of layer 1
    (or of layer 0, taking the bias table with it) dies: the same config
    (``encoder_remaining_heads`` index lists, ``encoder_total_num_heads``
    kept) and a bit-identical state dict as the TPU package's
    ``prune_model``, a strict reload, and the reloaded model's features."""
    cfg = _tiny_wavlm_config(**PRUNE_FLAGS)
    jm = j_wav2vec2_model(**cfg)
    flat = pt.flatten_params(jax.tree.map(np.asarray, jm.init(jax.random.key(7))))
    rng = np.random.default_rng(7)
    layers = "encoder.transformer.layers"
    for k, v in flat.items():
        if k.endswith("log_alpha"):
            flat[k] = rng.normal(0.5, 3.0, v.shape).astype(np.float32)
    dead = 0 if layer0_dies else 1
    for i in range(3):
        flat[f"{layers}.{i}.attention.hard_concrete_for_layer.log_alpha"] = np.full(
            1, -8.0 if i == dead else 6.0, np.float32)
    j_model, j_params = jm.prune(jax.tree.map(np.asarray, unflatten_params(flat)))
    j_sd = pt.flatten_params(jax.tree.map(np.asarray, j_params))
    gated = pt.wav2vec2_model(device="cpu", **cfg)
    gated.load_state_dict(pt.state_dict_from_jax(flat))
    new_cfg, new_sd = prune_model(gated.spec, gated.state_dict())
    assert new_cfg == j_model.config
    assert new_cfg["encoder_use_attention"][dead] is False
    assert new_cfg["encoder_total_num_heads"] == [4, 4, 4]
    assert all(isinstance(h, list) for h in new_cfg["encoder_remaining_heads"])
    assert set(new_sd) == set(j_sd)
    assert any("rel_attn_embed" in k for k in new_sd) != layer0_dies
    for k, v in j_sd.items():
        np.testing.assert_array_equal(new_sd[k], v, err_msg=k)
    pruned = model_from_checkpoint({"config": new_cfg, "state_dict": new_sd}, device="cpu")
    j_pruned = j_wav2vec2_model(**new_cfg)
    lengths = [4000, 3000]
    _compare(j_pruned, tree_to_jax(j_params), pruned, _wave(8, 2, 4000, lengths), lengths,
             atol=1e-4)


# ---------------------------------------------------------------------------
# The CLI stages
# ---------------------------------------------------------------------------


def test_wavlm_pipeline_cpu(tmp_path):
    """The torch counterpart of tests/test_pipeline_wavlm.py: prepare_data
    -> distill of a WavLM student (gates, Lagrangian) -> prune (emitting
    ``encoder_remaining_heads``) -> load_dpmodel -> final distill of the
    pruned WavLM student -> save_final_ckpt -> load_dpmodel, through the
    port's CLI functions with --device cpu, on synthetic WAVs with a tiny
    WavLM of the real conv stride."""
    from dphubert_torch.cli import (
        distill,
        final_distill,
        load_dpmodel,
        prepare_data,
        prune,
        save_final_ckpt,
    )

    root = tmp_path / "librispeech"
    rng = np.random.default_rng(0)
    for sub, prefix, n in (("train-clean-100/1/2", "u", 8), ("dev-clean/3/4", "d", 4)):
        (root / sub).mkdir(parents=True)
        for i in range(n):
            write_wav(root / sub / f"{prefix}{i:03d}.wav",
                      0.1 * rng.standard_normal(int(rng.integers(32_000, 48_000))))
    cfg = tiny_config()
    del cfg["encoder_num_heads"], cfg["encoder_head_dim"]
    cfg.update(encoder_total_num_heads=[4] * 3,
               encoder_remaining_heads=[list(range(4)) for _ in range(3)],
               encoder_num_buckets=32, encoder_max_distance=80)
    teacher = tmp_path / "wavlm_teacher.pth"
    model = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(0), **cfg)
    assert model.spec.is_wavlm
    save_checkpoint(teacher, cfg, model.state_dict())

    tsv = tmp_path / "tsv"
    prepare_data.cli_main(["--data", str(root), "--out", str(tsv), "--extension", "wav"])
    common = ["--tsv_dir", str(tsv), "--train_subset", "train100", "--seconds_per_batch", "16",
              "--num_workers", "2", "--num_shapes", "2", "--precision", "fp32",
              "--teacher_ckpt", str(teacher), "--log_interval", "1", "--warmup_updates", "1",
              "--distill_layers", "0.1,3", "--device", "cpu"]
    exp1, exp2 = tmp_path / "stage1", tmp_path / "stage2"
    distill.cli_main(common + [
        "--student_ckpt", str(teacher), "--exp_dir", str(exp1), "--max_updates", "2",
        "--sparsity_warmup_updates", "1", "--target_sparsity", "0.5",
        "--pruning_units", "conv,head,interm,attlayer,ffnlayer"])
    distilled = exp1 / "ckpts" / "distilled.pth"
    prune.cli_main(["--distilled_ckpt", str(distilled)])
    pruned = distilled.parent / "pruned_hubert_base.pth"
    ck = load_checkpoint(pruned)
    assert "encoder_remaining_heads" in ck["config"]
    assert all(isinstance(h, list) for h in ck["config"]["encoder_remaining_heads"])
    load_dpmodel.cli_main([str(pruned), "--device", "cpu"])

    state = final_distill.cli_main(common + ["--student_ckpt", str(pruned),
                                             "--exp_dir", str(exp2), "--max_updates", "2"])
    assert state.step == 2 and state.lambdas is None
    distilled2 = exp2 / "ckpts" / "distilled.pth"
    save_final_ckpt.cli_main(["--config_path", str(pruned),
                              "--ckpt_after_final_distill", str(distilled2)])
    final = distilled2.parent / "pruned_hubert_base.pth"
    load_dpmodel.cli_main([str(final), "--device", "cpu"])
    served = model_from_checkpoint(load_checkpoint(final), device="cpu")
    assert served.spec.is_wavlm
    with torch.no_grad():
        outs, _ = served.extract_features(torch.zeros(1, 32000))
    assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_pruned_wavlm_student_config_builds():
    """``docs/convergence_wavlm_r4_pruned_config.json`` (heads
    12/12/12/12/-/-/-/12/-/-/7/10) builds in the port with the TPU
    package's state-dict shapes."""
    cfg = json.loads((REPO / "docs" / "convergence_wavlm_r4_pruned_config.json").read_text())
    tm = pt.wav2vec2_model(device="cpu", **cfg)
    assert [len(l.attention.remaining_heads) if l.attention else 0
            for l in tm.spec.layers] == [12, 12, 12, 12, 0, 0, 0, 12, 0, 0, 7, 10]
    jm = j_wav2vec2_model(**cfg)
    shapes = pt.flatten_params(jax.eval_shape(lambda key: jm.init(key), jax.random.key(0)))
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in shapes.items()}
