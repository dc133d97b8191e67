"""The port's Predictor and checkpoint interop against the TPU package's."""

import jax
import numpy as np
import pytest
import torch

import dphubert_torch as pt
from dphubert_torch.interop import torch_ckpt as t_ckpt
from dphubert_torch.serve import Predictor
from dphubert_tpu import flatten_params
from dphubert_tpu import wav2vec2_model as j_wav2vec2_model
from dphubert_tpu.interop import torch_ckpt as j_ckpt
from dphubert_tpu.serve import Predictor as JPredictor

from tests.test_forward_parity import _tiny_w2v2_config


def _models(seed=0):
    cfg = _tiny_w2v2_config()
    jm = j_wav2vec2_model(**cfg)
    params = jm.init(jax.random.key(seed))
    tm = pt.Wav2Vec2Model(pt.spec_from_config(**cfg))
    tm.load_state_dict(pt.state_dict_from_jax(params), strict=True)
    return cfg, jm, params, tm


def test_predictor_matches_jax_predictor():
    _, jm, params, tm = _models()
    rng = np.random.default_rng(0)
    # mixed lengths, more clips than max_batch, buckets of 800 samples
    waves = [rng.standard_normal(n).astype(np.float32)
             for n in (3000, 800, 2417, 1601, 4000, 999)]
    want = JPredictor(jm, params, length_step=800, max_batch=4).extract(waves)
    got = Predictor(tm, length_step=800, max_batch=4, device="cpu").extract(waves)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32
        assert g.shape == np.shape(w), f"clip {i}"
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0,
                                   err_msg=f"clip {i}")


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_checkpoint_round_trips_both_ways(tmp_path, suffix):
    cfg, jm, params, tm = _models(seed=1)
    flat = flatten_params(params)

    # port -> TPU package
    path = tmp_path / f"port{suffix}"
    t_ckpt.save_checkpoint(path, cfg, tm.state_dict())
    back = j_ckpt.load_checkpoint(path)
    assert back["config"] == cfg
    assert set(back["state_dict"]) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back["state_dict"][k], np.asarray(v), err_msg=k)

    # TPU package -> port, through the serving loader
    path = tmp_path / f"tpu{suffix}"
    j_ckpt.save_checkpoint(path, cfg, {k: np.asarray(v) for k, v in flat.items()})
    loaded = t_ckpt.load_model(path, device="cpu")
    assert loaded.config == cfg
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(flat[k]), err_msg=k)
    t_ckpt.verify_strict(loaded, back["state_dict"])
    with pytest.raises(ValueError, match="strict load failed"):
        t_ckpt.verify_strict(loaded, {k: v for k, v in back["state_dict"].items()
                                      if "dummy_weight" not in k})


def test_load_dpmodel_cli(tmp_path, capsys):
    from dphubert_torch.cli.load_dpmodel import cli_main

    cfg, _, params, _ = _models(seed=2)
    path = tmp_path / "student.pth"
    j_ckpt.save_checkpoint(path, cfg, {k: np.asarray(v) for k, v in flatten_params(params).items()})
    cli_main([str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "extract_features: 4 layers, last (1, 799, 64)" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main([str(path)])
