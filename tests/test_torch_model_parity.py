"""Per-layer parity of the port's model against the TPU package on the CPU.

Both packages hold the same parameters and run ``extract_features`` on the
same numpy waveforms in fp32.  On the CPU the port's attention runs
the plain versions of its kernels (key mask from the lengths), the TPU
package its dense path (additive -10000 mask).  Bound: 1e-4 absolute, as
tests/test_forward_parity.py.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import dphubert_torch as pt
from dphubert_tpu import unflatten_params
from dphubert_tpu import wav2vec2_model as j_wav2vec2_model
from dphubert_tpu.params import tree_to_jax

from tests.test_forward_parity import _tiny_w2v2_config
from tests.test_params import HUBERT_BASE_CONFIG

REPO = pathlib.Path(__file__).resolve().parents[1]

TINY = {
    "post_norm": _tiny_w2v2_config(),
    "pre_norm_layer_norm_extractor": _tiny_w2v2_config(
        layer_norm_first=True, extractor_mode="layer_norm"
    ),
    "irregular": _tiny_w2v2_config(
        encoder_use_attention=[True, False, True],
        encoder_use_feed_forward=[True, True, False],
        encoder_num_heads=[3, 0, 2],
        encoder_ff_interm_features=[96, 48, 0],
    ),
    # gate parameters held, no gates applied in eval (gates=None)
    "gated": _tiny_w2v2_config(
        extractor_prune_conv_channels=True,
        encoder_prune_attention_heads=True,
        encoder_prune_attention_layer=True,
        encoder_prune_feed_forward_intermediate=True,
        encoder_prune_feed_forward_layer=True,
    ),
}


def _pair(cfg, seed):
    """Both models with the same weights: the port initialises them (much
    faster than the JAX init at full width) and the JAX package gets them
    by unflattening the state dict; tests/test_torch_params.py checks the
    other direction, ``state_dict_from_jax``."""
    tm = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(seed), **cfg)
    flat = {k: v.numpy() for k, v in tm.state_dict().items()}
    return j_wav2vec2_model(**cfg), tree_to_jax(unflatten_params(flat)), tm


def _wave(seed, B, T, lengths=None, scale=1.0):
    rng = np.random.default_rng(seed)
    wave = (scale * rng.standard_normal((B, T))).astype(np.float32)
    if lengths is not None:
        for b, n in enumerate(lengths):
            wave[b, n:] = 0.0
    return wave


def _compare(jm, params, tm, wave, lengths, atol=1e-4):
    j_lens = None if lengths is None else np.asarray(lengths, np.int32)
    want, want_lens = jm.extract_features(params, wave, j_lens)
    with torch.no_grad():
        got, got_lens = tm.extract_features(
            torch.from_numpy(wave),
            None if lengths is None else torch.tensor(lengths, dtype=torch.int32),
        )
    assert len(got) == len(want)
    if lengths is not None:
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == np.shape(w), f"layer {i}"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0,
                                   err_msg=f"layer {i}")


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_configs_per_layer(name, with_lengths):
    jm, params, tm = _pair(TINY[name], seed=0)
    lengths = [4000, 3310, 2600] if with_lengths else None
    _compare(jm, params, tm, _wave(1, 3, 4000, lengths), lengths)


@pytest.mark.parametrize("name", ["hubert_base", "pruned_config_r2"])
def test_full_width_one_second(name):
    cfg = (HUBERT_BASE_CONFIG if name == "hubert_base"
           else json.loads((REPO / "docs" / "pruned_config_r2.json").read_text()))
    jm, params, tm = _pair(cfg, seed=2)
    _compare(jm, params, tm, _wave(3, 1, 16000, scale=0.1), None)


def test_forward_with_aux_head():
    cfg = dict(TINY["post_norm"], aux_num_out=5)
    jm, params, tm = _pair(cfg, seed=3)
    wave = _wave(4, 2, 4000, [4000, 2900])
    lengths = np.array([4000, 2900], np.int32)
    want, want_lens = jm.forward(params, wave, lengths)
    with torch.no_grad():
        got, got_lens = tm(torch.from_numpy(wave), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_against_pallas_kernels_in_model(monkeypatch):
    """The TPU package with its attention kernels forced on (interpret mode)
    against the port's plain versions, bound 2e-4 as
    tests/test_flash_in_model.py."""
    monkeypatch.setenv("DPHUBERT_FLASH_ATTENTION", "1")
    jm, params, tm = _pair(TINY["post_norm"], seed=4)
    lengths = [4000, 2500]
    _compare(jm, params, tm, _wave(5, 2, 4000, lengths), lengths, atol=2e-4)
