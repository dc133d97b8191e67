"""The training forward with LayerDrop (``Wav2Vec2Model.forward(training=True)``)
against the TPU package's ``forward(training=True, rng=...)`` on the CPU.

Both sides hold the same weights, the same HardConcrete gates (the TPU
package's draws handed to the port) and, with LayerDrop on, the same
per-layer uniforms: the port takes them as ``layer_drop_u``, read off the
TPU package's key schedule (``transformer_forward`` splits one key a layer
for the layer bodies, then one a layer for ``u``).  Every dropout rate is 0,
since torch's generators cannot reproduce ``jax.random``.  Bound: 1e-4 on
the output, as tests/test_forward_parity.py, and 1e-4 of the norm on each
gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dphubert_torch as pt
from dphubert_torch.models import gates as t_gates
from dphubert_torch.params import unflatten_params
from dphubert_tpu import wav2vec2_model as j_wav2vec2_model
from dphubert_tpu.models import gates as j_gates
from dphubert_tpu.models.components import RngStream
from dphubert_tpu.params import tree_to_jax

from tests.test_forward_parity import _tiny_w2v2_config, _tiny_wavlm_config
from tests.test_torch_gates import PRUNE_FLAGS, jax_gate_draws, one_torch_thread  # noqa: F401

CONFIGS = {
    "hubert": lambda **kw: _tiny_w2v2_config(**PRUNE_FLAGS, **kw),
    "wavlm": lambda **kw: _tiny_wavlm_config(**PRUNE_FLAGS, **kw),
}
RNG_KEY = 7  # the TPU forward's key: with it, layer_drop 0.5 drops layer 1 of 3
LENGTHS = np.array([4000, 3100], np.int32)


def _setup(family: str, layer_drop: float, seed: int = 0):
    cfg = CONFIGS[family](encoder_layer_drop=layer_drop)
    tm = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(seed), **cfg)
    flat = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    jp = tree_to_jax(unflatten_params(flat))
    jm = j_wav2vec2_model(**cfg)
    gates, t_gate_tree = None, None
    if t_gates.has_gates(tm.spec):
        key = jax.random.key(seed + 7)
        gates = j_gates.sample_gates(tm.spec, jp, key)
        tp = unflatten_params(dict(tm.named_parameters()))
        t_gate_tree = t_gates.sample_gates(tm.spec, tp, u=jax_gate_draws(tm.spec, jp, key))
    wave = np.random.default_rng(seed + 3).standard_normal((2, 4000)).astype(np.float32)
    return tm, jm, jp, gates, t_gate_tree, wave


def jax_layer_drop_u(n_layers: int, key) -> np.ndarray:
    """The uniforms ``transformer_forward`` draws with every dropout rate 0:
    n keys for the layer bodies first, then one ``u`` a layer."""
    rngs = RngStream(key)
    for _ in range(n_layers):
        rngs.next()
    return np.array([float(jax.random.uniform(rngs.next(), ())) for _ in range(n_layers)],
                    np.float32)


@pytest.mark.parametrize("family", ["hubert", "wavlm"])
@pytest.mark.parametrize("layer_drop", [0.0, 0.5])
def test_training_forward_matches_jax(family, layer_drop):
    tm, jm, jp, gates, t_gate_tree, wave = _setup(family, layer_drop)
    key = jax.random.key(RNG_KEY)
    want, want_lens = jm.forward(jp, wave, LENGTHS, gates=gates, training=True, rng=key)
    u = jax_layer_drop_u(tm.spec.num_layers, key)
    if layer_drop:
        assert (u <= layer_drop).any() and (u > layer_drop).any(), u  # some dropped, some kept
    with torch.no_grad():
        got, got_lens = tm.forward(torch.from_numpy(wave), torch.from_numpy(LENGTHS),
                                   gates=t_gate_tree, training=True,
                                   generator=torch.Generator().manual_seed(0),
                                   layer_drop_u=torch.from_numpy(u) if layer_drop else None)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("family", ["hubert", "wavlm"])
def test_training_forward_gradient_matches_jax(family):
    """The gradient of mean(out^2) in every parameter (the gates' draws
    fixed, layer 1 dropped) against ``jax.grad``: 1e-4 of each gradient's
    norm."""
    tm, jm, jp, _, _, wave = _setup(family, 0.5, seed=1)
    spec = tm.spec
    key = jax.random.key(RNG_KEY)
    u = jax_layer_drop_u(spec.num_layers, key)
    gate_key = jax.random.key(8)
    u_gates = jax_gate_draws(spec, jp, gate_key) if t_gates.has_gates(spec) else None

    def j_loss(p):
        g = j_gates.sample_gates(spec, p, gate_key) if u_gates is not None else None
        out, _ = jm.forward(p, wave, LENGTHS, gates=g, training=True, rng=key)
        return jnp.mean(jnp.square(out))

    want_v, want_g = jax.value_and_grad(j_loss)(jp)
    gates = (t_gates.sample_gates(spec, unflatten_params(dict(tm.named_parameters())),
                                  u=u_gates) if u_gates is not None else None)
    # every parameter but the frozen carrier of the conv gate's soft mask
    named = {n: p for n, p in tm.named_parameters() if p.requires_grad}
    assert set(dict(tm.named_parameters())) - set(named) == {"feature_extractor.dummy_weight"}
    out, _ = tm.forward(torch.from_numpy(wave), torch.from_numpy(LENGTHS), gates=gates,
                        training=True, generator=torch.Generator().manual_seed(0),
                        layer_drop_u=torch.from_numpy(u))
    loss = out.square().mean()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    want_flat = pt.flatten_params(jax.tree.map(np.asarray, want_g))
    got = {n: np.zeros_like(want_flat[n]) if g is None else g.numpy()
           for n, g in zip(named, grads)}
    assert len(got) == len(want_flat) - 1
    norm = np.sqrt(sum(float(np.sum(want_flat[n] ** 2)) for n in got))
    diff = np.sqrt(sum(float(np.sum((got[n] - want_flat[n]) ** 2)) for n in got))
    assert diff <= 1e-4 * norm, diff / norm
    # each leaf that carries a share of the gradient, to 1e-4 of its own
    # norm (the smallest are fp32 rounding noise: the k bias's is 0 in exact
    # arithmetic, the softmax being invariant to it)
    for n in got:
        leaf = float(np.linalg.norm(want_flat[n]))
        if leaf >= 1e-3 * norm:
            assert np.linalg.norm(got[n] - want_flat[n]) <= 1e-4 * leaf, n
    # a dropped layer's parameters get no gradient through the output
    dropped = [i for i in range(spec.num_layers) if u[i] <= 0.5]
    assert dropped
    for (name, p), g in zip(named.items(), grads):
        if any(name.startswith(f"encoder.transformer.layers.{i}.feed_forward.") for i in dropped):
            assert g is None or not bool(g.any()), name


@pytest.mark.parametrize("family", ["hubert", "wavlm"])
def test_a_dropped_layer_is_the_identity_bit_for_bit(family):
    """The input of the layer after a dropped one is the dropped layer's
    input, bit for bit, though every layer is computed (each layer's
    forward runs once a call whatever is dropped)."""
    tm, _, _, _, gate_tree, wave = _setup(family, 0.5)
    calls, inputs = [], []
    for i, layer in enumerate(tm.encoder.transformer.layers):
        layer.register_forward_hook(lambda m, args, out, i=i: calls.append(i))
        layer.register_forward_pre_hook(lambda m, args: inputs.append(args[0].clone()))
    u = torch.tensor([0.9, 0.2, 0.7])  # layer 1 dropped (u <= 0.5)
    with torch.no_grad():
        out, _ = tm.forward(torch.from_numpy(wave), training=True, gates=gate_tree,
                            generator=torch.Generator().manual_seed(0), layer_drop_u=u)
    assert calls == [0, 1, 2]
    assert torch.equal(inputs[2], inputs[1]) and not torch.equal(inputs[1], inputs[0])
    # every layer dropped: each layer, and the output, is the first layer's
    # input (the post-norm layout normalises before the layers, not after)
    assert tm.encoder.transformer.layer_norm_first
    inputs.clear()
    with torch.no_grad():
        out, _ = tm.forward(torch.from_numpy(wave), training=True, gates=gate_tree,
                            generator=torch.Generator().manual_seed(0),
                            layer_drop_u=torch.zeros(3))
    assert len(inputs) == 3 and all(torch.equal(x, inputs[0]) for x in inputs + [out])


def test_layer_drop_u_of_ones_is_the_forward_without_layer_drop():
    """u = 1 everywhere keeps every layer: bit for bit the forward of the
    same weights with ``layer_drop = 0``."""
    tm, _, _, _, gate_tree, wave = _setup("hubert", 0.1)
    t0 = pt.wav2vec2_model(device="cpu", **CONFIGS["hubert"](encoder_layer_drop=0.0))
    t0.load_state_dict(tm.state_dict())
    kw = dict(training=True, gates=gate_tree)
    with torch.no_grad():
        got, _ = tm.forward(torch.from_numpy(wave), generator=torch.Generator().manual_seed(0),
                            layer_drop_u=torch.ones(3), **kw)
        want, _ = t0.forward(torch.from_numpy(wave), generator=torch.Generator().manual_seed(0),
                             **kw)
    assert torch.equal(got, want)


def test_layer_drop_draws_one_uniform_a_layer_from_the_generator():
    """Without ``layer_drop_u`` the uniforms are the generator's next
    ``num_layers`` draws (every dropout rate 0: nothing is drawn before
    them); without a generator, or in eval, nothing is dropped; the
    argument errors."""
    tm, _, _, _, gate_tree, wave = _setup("hubert", 0.5)
    x = torch.from_numpy(wave)
    with torch.no_grad():
        drawn, _ = tm.forward(x, training=True, gates=gate_tree,
                              generator=torch.Generator().manual_seed(4))
        u = torch.rand(3, generator=torch.Generator().manual_seed(4))
        injected, _ = tm.forward(x, training=True, gates=gate_tree,
                                 generator=torch.Generator().manual_seed(5), layer_drop_u=u)
        kept, _ = tm.forward(x, training=True, gates=gate_tree,
                             generator=torch.Generator().manual_seed(5),
                             layer_drop_u=torch.ones(3))
        no_gen, _ = tm.forward(x, training=True, gates=gate_tree)
    assert torch.equal(drawn, injected)
    assert torch.equal(no_gen, kept)
    assert bool((u <= 0.5).any()) and not torch.equal(drawn, kept)
    with pytest.raises(ValueError, match="layer_drop_u"):
        tm.forward(x, training=True, gates=gate_tree, layer_drop_u=u)
    with pytest.raises(ValueError, match="shape"):
        tm.forward(x, training=True, gates=gate_tree, generator=torch.Generator(),
                   layer_drop_u=torch.ones(4))
    with pytest.raises(ValueError, match="pass gates="):
        tm.forward(x, training=True, generator=torch.Generator())
