"""The port's HardConcrete gates, model size and gated training forward
against the TPU package on the CPU.

Uniform draws come from ``jax.random`` and are handed to both packages
(``sample_mask(..., u=...)`` / ``sample_gates(..., u=...)``), since torch's
generators cannot reproduce JAX's streams.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dphubert_torch as pt
from dphubert_torch.models import gates as t_gates
from dphubert_torch.models import hardconcrete as t_hc
from dphubert_torch.models.size import model_size as t_model_size
from dphubert_torch.params import unflatten_params
from dphubert_tpu import wav2vec2_model as j_wav2vec2_model
from dphubert_tpu.models import gates as j_gates
from dphubert_tpu.models import hardconcrete as j_hc
from dphubert_tpu.models.components import RngStream
from dphubert_tpu.models.size import model_size as j_model_size
from dphubert_tpu.params import tree_to_jax

from tests.test_forward_parity import _tiny_w2v2_config
from tests.test_params import HUBERT_BASE_CONFIG

PRUNE_FLAGS = dict(
    extractor_prune_conv_channels=True,
    encoder_prune_attention_heads=True,
    encoder_prune_attention_layer=True,
    encoder_prune_feed_forward_intermediate=True,
    encoder_prune_feed_forward_layer=True,
)
GATED_TINY = _tiny_w2v2_config(**PRUNE_FLAGS)
GATED_BASE = dict(HUBERT_BASE_CONFIG, **PRUNE_FLAGS)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run each test with one intra-op thread: the inputs are tiny, and with
    several test workers on one machine torch's default of one OpenMP thread
    per core oversubscribes the cores (spinning threads slow tiny ops by
    orders of magnitude)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_gate_draws(spec, params, key):
    """The uniform draws the TPU package's ``sample_gates`` makes from
    ``key``, as a numpy tree of the gates' layout (same split order)."""
    rngs = RngStream(key)
    u: dict = {}
    for gate_path, param_path in t_gates.gate_paths(spec):
        leaf = params
        for k in param_path:
            leaf = leaf[k]
        node = u
        for k in gate_path[:-1]:
            node = node.setdefault(k, {})
        node[gate_path[-1]] = np.asarray(jax.random.uniform(
            rngs.next(), tuple(leaf.shape), jnp.float32,
            minval=j_hc.EPS, maxval=1.0 - j_hc.EPS,
        ))
    return u


def _models(cfg, seed):
    """The port's model (random init) and the same weights as a JAX tree."""
    tm = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(seed), **cfg)
    tm.train()
    flat = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    return tm, tree_to_jax(unflatten_params(flat))


def _log_alphas(n, seed):
    return np.random.default_rng(seed).normal(1.5, 2.0, n).astype(np.float32)


@pytest.mark.parametrize("n", [1, 12, 3072])
def test_l0_norm_sample_mask_and_grads(n):
    """l0_norm and sample_mask given u, with their gradients, against
    jax.grad; fp32, bound 1e-6 relative (only the summation order of l0's
    sum differs)."""
    la = _log_alphas(n, n)
    key = jax.random.key(n)
    u = np.asarray(jax.random.uniform(key, (n,), jnp.float32, minval=j_hc.EPS,
                                      maxval=1.0 - j_hc.EPS))
    # the draws the TPU package's sample_mask makes from key, handed over;
    # log and sigmoid differ by an ulp between the two libraries
    np.testing.assert_allclose(
        t_hc.sample_mask(torch.from_numpy(la), u=u).numpy(),
        np.asarray(j_hc.sample_mask(jnp.asarray(la), key)), rtol=1e-6, atol=1e-7,
    )
    w = np.random.default_rng(0).standard_normal(n).astype(np.float32)

    def j_obj(x):
        return j_hc.l0_norm(x) + jnp.sum(jnp.asarray(w) * j_hc.sample_mask(x, key))

    want_v, want_g = jax.value_and_grad(j_obj)(jnp.asarray(la))
    x = torch.from_numpy(la).requires_grad_()
    got = t_hc.l0_norm(x) + (torch.from_numpy(w) * t_hc.sample_mask(x, u=u)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want_v), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)
    # the port's own draws lie in (eps, 1 - eps) and give a mask in [0, 1]
    m = t_hc.sample_mask(torch.from_numpy(la), torch.Generator().manual_seed(0))
    assert m.shape == (n,) and bool(((m >= 0) & (m <= 1)).all())


def test_eval_mask_is_the_tpu_packages():
    for n, seed in ((1, 0), (12, 1), (512, 2), (3072, 3)):
        la = _log_alphas(n, seed)
        np.testing.assert_array_equal(t_hc.eval_mask(torch.from_numpy(la)), j_hc.eval_mask(la))


def test_gate_trees_match():
    """sample_gates (given the TPU package's draws) and compile_gates give
    the TPU package's trees, keys and values; an ungated spec has none."""
    tm, jp = _models(GATED_TINY, seed=0)
    spec = tm.spec
    key = jax.random.key(5)
    want = j_gates.sample_gates(spec, jp, key)
    tp = unflatten_params(dict(tm.named_parameters()))
    got = t_gates.sample_gates(spec, tp, u=jax_gate_draws(spec, jp, key))
    flat_w = pt.flatten_params(want)
    flat_g = pt.flatten_params(got)
    assert list(flat_g) == list(flat_w)  # same keys, same order
    for k in flat_w:
        np.testing.assert_allclose(flat_g[k].detach().numpy(), np.asarray(flat_w[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    want_c = pt.flatten_params(j_gates.compile_gates(spec, jp))
    got_c = pt.flatten_params(t_gates.compile_gates(spec, tp))
    assert list(got_c) == list(want_c)
    for k in want_c:
        np.testing.assert_array_equal(got_c[k].numpy(), want_c[k], err_msg=k)
    assert t_gates.has_gates(spec) and not t_gates.has_gates(pt.wav2vec2_model(
        device="cpu", **_tiny_w2v2_config()).spec)
    # the port's own draws come from a generator, in the same tree layout
    drawn = t_gates.sample_gates(spec, tp, torch.Generator().manual_seed(0))
    assert list(pt.flatten_params(drawn)) == list(flat_w)


@pytest.mark.parametrize("name", ["tiny", "hubert_base", "pruned_config_r2"])
def test_model_size_and_grad(name):
    """model_size and its gradient in every log_alpha against jax.grad,
    for a tiny gated config, gated HuBERT Base and an ungated pruned
    student; fp32, bound 1e-6 relative on the size (~9.4e7 at Base) and on
    the gradients."""
    cfg = {"tiny": GATED_TINY, "hubert_base": GATED_BASE}.get(name)
    if cfg is None:
        repo = pathlib.Path(__file__).resolve().parents[1]
        cfg = json.loads((repo / "docs" / "pruned_config_r2.json").read_text())
    tm, jp = _models(cfg, seed=1)
    spec = tm.spec
    # spread the gates so every l0 term matters
    with torch.no_grad():
        for n, p in tm.named_parameters():
            if n.endswith("log_alpha"):
                p.copy_(torch.from_numpy(_log_alphas(p.numel(), p.numel())))
    flat = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    jp = tree_to_jax(unflatten_params(flat))
    got = t_model_size(unflatten_params(dict(tm.named_parameters())), spec)
    if not t_gates.has_gates(spec):
        assert got == int(j_model_size(jp, spec))  # a plain count
        return
    want_v, want_g = jax.value_and_grad(lambda p: j_model_size(p, spec))(jp)
    np.testing.assert_allclose(got.item(), float(want_v), rtol=1e-6)
    got.backward()
    want_flat = pt.flatten_params(jax.tree.map(np.asarray, want_g))
    checked = 0
    for n, p in tm.named_parameters():
        if n.endswith("log_alpha"):
            np.testing.assert_allclose(p.grad.numpy(), want_flat[n], rtol=1e-6, atol=1e-3,
                                       err_msg=n)
            checked += 1
    assert checked == sum(1 for _ in t_gates.gate_paths(spec))


def test_gated_training_forward_matches():
    """extract_features(training=True) with the same gates and every
    dropout rate 0 against the TPU package: the conv channel, head, layer
    and intermediate gates are applied at the same places.  Bound 1e-4 per
    layer, as tests/test_forward_parity.py."""
    tm, jp = _models(GATED_TINY, seed=2)
    spec = tm.spec
    key = jax.random.key(7)
    j_model = j_wav2vec2_model(**GATED_TINY)
    gates = j_gates.sample_gates(spec, jp, key)
    wave = np.random.default_rng(3).standard_normal((2, 4000)).astype(np.float32)
    lengths = np.array([4000, 3100], np.int32)
    want, _ = j_model.extract_features(jp, wave, lengths, gates=gates, training=True,
                                       rng=jax.random.key(0))
    tp = unflatten_params(dict(tm.named_parameters()))
    t_gate_tree = t_gates.sample_gates(spec, tp, u=jax_gate_draws(spec, jp, key))
    with torch.no_grad():
        got, _ = tm.extract_features(torch.from_numpy(wave), torch.from_numpy(lengths),
                                     gates=t_gate_tree, training=True,
                                     generator=torch.Generator().manual_seed(0))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0,
                                   err_msg=f"layer {i}")
    with pytest.raises(ValueError, match="pass gates="):
        tm.extract_features(torch.from_numpy(wave), training=True)


def test_dropout_draws_from_the_generator():
    """With dropout on, a training forward is a function of the generator's
    seed: equal seeds give equal outputs, another seed another output, and
    eval ignores the generator."""
    cfg = _tiny_w2v2_config(encoder_projection_dropout=0.1, encoder_attention_dropout=0.1,
                            encoder_ff_interm_dropout=0.1, encoder_dropout=0.1)
    tm = pt.wav2vec2_model(device="cpu", **cfg)
    wave = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 4000)).astype(np.float32))

    def run(seed, training=True):
        with torch.no_grad():
            out, _ = tm.extract_features(wave, training=training,
                                         generator=torch.Generator().manual_seed(seed))
        return out[-1]

    assert torch.equal(run(1), run(1))
    assert not torch.allclose(run(1), run(2))
    assert torch.equal(run(1, training=False), run(2, training=False))
