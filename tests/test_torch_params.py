"""The port's state-dict layout against the TPU package's parameter tree, and
the port's independence from JAX."""

import json
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import dphubert_torch as pt
from dphubert_tpu import flatten_params, init_params, spec_from_config

from tests.test_forward_parity import _tiny_w2v2_config
from tests.test_params import HUBERT_BASE_CONFIG

REPO = pathlib.Path(__file__).resolve().parents[1]
PRUNED_R2 = json.loads((REPO / "docs" / "pruned_config_r2.json").read_text())

CONFIGS = {
    "tiny_post_norm": _tiny_w2v2_config(),
    "tiny_pre_norm": _tiny_w2v2_config(layer_norm_first=True),
    "tiny_layer_norm_extractor": _tiny_w2v2_config(
        layer_norm_first=True, extractor_mode="layer_norm"
    ),
    "tiny_irregular": _tiny_w2v2_config(
        encoder_use_attention=[True, False, True],
        encoder_use_feed_forward=[True, True, False],
        encoder_num_heads=[3, 0, 2],
        encoder_ff_interm_features=[96, 48, 0],
    ),
    "tiny_prune_flags": _tiny_w2v2_config(
        extractor_prune_conv_channels=True,
        encoder_prune_attention_heads=True,
        encoder_prune_attention_layer=True,
        encoder_prune_feed_forward_intermediate=True,
        encoder_prune_feed_forward_layer=True,
        aux_num_out=7,
    ),
    "hubert_base": HUBERT_BASE_CONFIG,
    "pruned_config_r2": PRUNED_R2,
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_layout_matches_jax(name):
    cfg = CONFIGS[name]
    spec = spec_from_config(**cfg)
    ref = flatten_params(jax.eval_shape(lambda key: init_params(spec, key), jax.random.key(0)))
    ours = pt.Wav2Vec2Model(pt.spec_from_config(**cfg)).state_dict()
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k
        assert ours[k].dtype == torch.float32, k


@pytest.mark.parametrize("name", ["tiny_prune_flags", "tiny_irregular"])
def test_state_dict_from_jax_loads_strictly(name):
    cfg = CONFIGS[name]
    tree = init_params(spec_from_config(**cfg), jax.random.key(1))
    model = pt.Wav2Vec2Model(pt.spec_from_config(**cfg))
    model.load_state_dict(pt.state_dict_from_jax(tree), strict=True)
    flat = flatten_params(tree)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(flat[k]), err_msg=k)


def test_init_distributions_mirror_jax():
    """Same distributions (not bits): bounds of the uniform inits, unit
    norms, HardConcrete means, and g = ||v|| of the weight-normed conv."""
    cfg = CONFIGS["tiny_prune_flags"]
    sd = pt.wav2vec2_model(device="cpu", **cfg).state_dict()
    w = sd["encoder.transformer.layers.0.feed_forward.intermediate_dense.weight"]
    assert w.abs().max() <= 1 / np.sqrt(w.shape[1]) and w.std() > 0
    assert torch.all(sd["encoder.transformer.layers.0.layer_norm.weight"] == 1)
    assert torch.all(sd["feature_extractor.dummy_weight"] == 1)
    la = sd["encoder.transformer.layers.0.feed_forward.hard_concrete_for_intermediate.log_alpha"]
    assert abs(la.mean().item()) < 0.01  # log(1 - 0.5) - log(0.5) = 0
    v = sd["encoder.transformer.pos_conv_embed.conv.weight_v"]
    g = sd["encoder.transformer.pos_conv_embed.conv.weight_g"]
    torch.testing.assert_close(g, v.square().sum(dim=(0, 1), keepdim=True).sqrt())


def test_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['dphubert_tpu'] = None; "
        "import dphubert_torch, dphubert_torch.serve, dphubert_torch.interop, "
        "dphubert_torch.cli.load_dpmodel; "
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules "
        "if sys.modules[m] is not None)"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


def test_no_file_names_jax():
    pattern = re.compile(r"\bjax\b|dphubert_tpu", re.IGNORECASE)
    offenders = [
        str(p.relative_to(REPO))
        for p in (REPO / "dphubert_torch").rglob("*")
        if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".md")
        and pattern.search(p.read_text())
    ]
    assert offenders == []


def test_wavlm_builds_and_the_training_forward_runs():
    # WavLM is ported: the preset builds, and the ``encoder_remaining_heads``
    # key selects the WavLM architecture, which then needs its own keys
    assert pt.wavlm_base(device="cpu").spec.is_wavlm
    wavlm_cfg = dict(CONFIGS["tiny_post_norm"], encoder_remaining_heads=[[0]] * 3)
    with pytest.raises(KeyError, match="encoder_total_num_heads"):
        pt.wav2vec2_model(device="cpu", **wavlm_cfg)
    model = pt.wav2vec2_model(device="cpu", **dict(CONFIGS["tiny_post_norm"],
                                                   encoder_layer_drop=0.5))
    # forward(training=True) runs, with LayerDrop (tests/test_torch_layerdrop.py
    # holds it against the TPU package); the distill path (extract_features)
    # trains every layer
    out, _ = model.forward(torch.zeros(1, 800), training=True,
                           generator=torch.Generator().manual_seed(0))
    assert out.shape[0] == 1 and bool(torch.isfinite(out).all())
    outs, _ = model.extract_features(torch.zeros(1, 800), training=True,
                                     generator=torch.Generator().manual_seed(0))
    assert len(outs) == 4


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.hubert_base()
    from dphubert_torch.serve import Predictor

    model = pt.wav2vec2_model(device="cpu", **CONFIGS["tiny_post_norm"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(model)
