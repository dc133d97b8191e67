"""The port's HuggingFace / fairseq import, its converters and the released-
checkpoint check, on the CPU.

* Tiny randomly initialised ``transformers`` HuBERT, wav2vec 2.0 (post-norm,
  and pre-norm with the layer-norm extractor) and WavLM models, as
  ``tests/test_hf_import.py`` builds them: the port's per-layer features
  against HF's hidden states within 1e-4, and its state dict equal to the
  TPU package's ``import_huggingface_model`` bit for bit on every key HF
  provides; ``convert_from_hf`` writes a checkpoint both packages load.
* fairseq: the rename equals the TPU package's on
  ``tests/test_fairseq_convert.py``'s synthetic dict, and
  ``convert_from_fairseq`` gives back a model's state dict bit for bit from
  its fairseq-named copy.
* ``grad_multiply``: value and gradient, as the TPU package's.
* ``verify_against_released`` against a stand-in ``wav2vec2/model.py``
  (written into a temporary directory, wrapping the TPU package's CPU model
  as the oracle): a checkpoint passes with exit code 0, and one with a
  non-finite weight fails with exit code 1.
"""

import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dphubert_torch as pt
from dphubert_torch.interop import import_huggingface_model, load_model, rename_fairseq_state_dict
from dphubert_torch.utils import grad_multiply
from dphubert_tpu.interop import hf as j_hf
from dphubert_tpu.interop import torch_ckpt as j_ckpt
from dphubert_tpu.params import flatten_params as j_flatten
from dphubert_tpu.utils.grad import grad_multiply as j_grad_multiply

from chip_smoke import to_fairseq
from tests.test_forward_parity import _tiny_w2v2_config
from tests.test_hf_import import _tiny_hubert, _tiny_wavlm
from tests.test_torch_gates import one_torch_thread  # noqa: F401

transformers = pytest.importorskip("transformers")


def _tiny_wav2vec2(stable: bool):
    """Tiny HF wav2vec 2.0: post-norm with a group-norm extractor, or
    pre-norm (``do_stable_layer_norm``) with a layer-norm extractor and conv
    biases, the Large-lv60k layout."""
    from transformers import Wav2Vec2Config, Wav2Vec2Model

    cfg = Wav2Vec2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=[8, 8, 8], conv_kernel=[10, 3, 3], conv_stride=[5, 2, 2],
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        feat_extract_norm="layer" if stable else "group", do_stable_layer_norm=stable,
        conv_bias=stable, hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        feat_proj_dropout=0.0, layerdrop=0.0,
    )
    torch.manual_seed(2)
    return Wav2Vec2Model(cfg)


HF_MODELS = {"hubert": _tiny_hubert, "wavlm": _tiny_wavlm,
             "wav2vec2": lambda: _tiny_wav2vec2(False),
             "wav2vec2_stable": lambda: _tiny_wav2vec2(True)}


@pytest.mark.parametrize("name", sorted(HF_MODELS))
def test_hf_import_matches_transformers_and_the_jax_import(name):
    """Hidden states of layers 1..N-1 against HF's ``hidden_states`` (HF's
    entry 0 is the encoder's normalised input, and it applies a pre-norm
    model's final LayerNorm to its last entry), the final output of
    ``forward`` against ``last_hidden_state``; a model with the layer-norm
    extractor normalises the waveform itself (``normalize_waveform``), which
    HF leaves to its feature extractor, so HF gets it normalised."""
    hf = HF_MODELS[name]().eval()
    model, sd = import_huggingface_model(hf, device="cpu")
    assert model.spec.is_wavlm == (name == "wavlm")
    wave = np.random.default_rng(0).standard_normal((2, 4000), dtype=np.float32)
    hf_wave = wave
    if model.spec.normalize_waveform:
        hf_wave = ((wave - wave.mean(1, keepdims=True))
                   / np.sqrt(wave.var(1, keepdims=True) + 1e-5)).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(hf_wave), output_hidden_states=True)
        outs, _ = model.extract_features(torch.from_numpy(wave))
        last, _ = model(torch.from_numpy(wave))
    n = model.spec.num_layers
    assert len(outs) == len(ref.hidden_states) == n + 1
    for i in range(1, n):
        err = (outs[i] - ref.hidden_states[i]).abs().max().item()
        assert err <= 1e-4, (i, err)
    assert (last - ref.last_hidden_state).abs().max().item() <= 1e-4

    # the TPU package's import of the same HF model, bit for bit
    _, j_params = j_hf.import_huggingface_model(hf)
    want = j_flatten(jax.tree.map(np.asarray, j_params))
    assert set(sd) == set(want)
    hf_keys = set(j_hf.rename_hf_state_dict(
        {k: v.numpy() for k, v in hf.state_dict().items()}))
    assert set(sd) - hf_keys == {"feature_extractor.dummy_weight"}  # port-only, fresh init
    for k in hf_keys & set(sd):
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_convert_from_hf_writes_what_both_packages_load(tmp_path):
    from dphubert_torch.cli import convert_from_hf

    hf = _tiny_hubert().eval()
    hf.save_pretrained(tmp_path / "hf")
    out = tmp_path / "converted.pth"
    convert_from_hf.cli_main(["--model", str(tmp_path / "hf"), "--type", "hubert",
                              "--out", str(out)])
    model = load_model(out, device="cpu")
    j_model, j_params = j_ckpt.load_model(out)
    assert j_model.config == model.config
    wave = np.random.default_rng(1).standard_normal((1, 4000), dtype=np.float32)
    with torch.no_grad():
        outs, _ = model.extract_features(torch.from_numpy(wave))
    j_outs, _ = j_model.extract_features(j_params, wave)
    for a, b in zip(outs, j_outs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)


def test_convert_from_hf_imports_without_transformers():
    """The card's host has no ``transformers``: the module imports without it."""
    code = ("import sys; sys.modules['transformers'] = None; "
            "import dphubert_torch.cli.convert_from_hf as m; print(m.cli_main.__name__)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "cli_main" in proc.stdout, proc.stderr


FAIRSEQ_SYNTHETIC = {
    "feature_extractor.conv_layers.0.0.weight": np.zeros((512, 1, 10)),
    "feature_extractor.conv_layers.0.2.1.weight": np.zeros((512,)),
    "feature_extractor.conv_layers.1.0.weight": np.zeros((512, 512, 3)),
    "post_extract_proj.weight": np.zeros((768, 512)),
    "post_extract_proj.bias": np.zeros((768,)),
    "layer_norm.weight": np.zeros((512,)),
    "layer_norm.bias": np.zeros((512,)),
    "encoder.pos_conv.0.bias": np.zeros((768,)),
    "encoder.pos_conv.0.weight_g": np.zeros((1, 1, 128)),
    "encoder.pos_conv.0.weight_v": np.zeros((768, 48, 128)),
    "encoder.layer_norm.weight": np.zeros((768,)),
    "encoder.layers.0.self_attn.k_proj.weight": np.zeros((768, 768)),
    "encoder.layers.0.self_attn.out_proj.bias": np.zeros((768,)),
    "encoder.layers.0.self_attn_layer_norm.weight": np.zeros((768,)),
    "encoder.layers.0.fc1.weight": np.zeros((3072, 768)),
    "encoder.layers.0.fc2.weight": np.zeros((768, 3072)),
    "encoder.layers.0.final_layer_norm.weight": np.zeros((768,)),
    "quantizer.vars": np.zeros((1,)),
    "project_q.weight": np.zeros((256, 256)),
    "final_proj.weight": np.zeros((256, 768)),
    "mask_emb": np.zeros((768,)),
    "label_embs_concat": np.zeros((504, 256)),
}

def test_fairseq_rename_matches_the_jax_one():
    got, want = rename_fairseq_state_dict(FAIRSEQ_SYNTHETIC), j_hf.rename_fairseq_state_dict(
        FAIRSEQ_SYNTHETIC)
    assert list(got) == list(want) and len(got) == 17
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_convert_from_fairseq_round_trip(tmp_path, monkeypatch, capsys):
    """A tiny model's state dict in fairseq's names (``chip_smoke.to_fairseq``,
    which the card's Large round trip uses), converted back with the CLI:
    the original bit for bit, ``dummy_weight`` (fairseq has none) from the
    fresh init."""
    from dphubert_torch.cli import convert_from_fairseq as cff

    cfg = _tiny_w2v2_config()
    tiny = lambda **kw: pt.wav2vec2_model(**kw, **cfg)  # noqa: E731
    monkeypatch.setattr(cff, "model_factories", types.SimpleNamespace(tiny=tiny))
    monkeypatch.setitem(cff.ARCHES, "tiny", "tiny")
    model = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(3), **cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["feature_extractor.dummy_weight"].fill_(0.5)  # changed: must come back from the init
    fairseq = to_fairseq(sd)
    fairseq["mask_emb"] = torch.zeros(64)  # pretraining-only: dropped
    torch.save({"model": fairseq}, tmp_path / "fairseq.pt")
    out = tmp_path / "converted.pth"
    cff.cli_main(["--ckpt", str(tmp_path / "fairseq.pt"), "--arch", "tiny", "--out", str(out)])
    assert "Missing (fresh init): ['feature_extractor.dummy_weight']" in capsys.readouterr().out
    back = load_model(out, device="cpu").state_dict()
    assert set(back) == set(sd)
    for k, v in back.items():
        want = torch.ones_like(v) if k == "feature_extractor.dummy_weight" else sd[k]
        assert torch.equal(v, want), k


def test_grad_multiply_matches_the_jax_one():
    x = torch.ones(4, requires_grad=True)
    y = grad_multiply(x, 0.3)
    assert torch.equal(y.detach(), torch.ones(4))
    (g,) = torch.autograd.grad(y.sum(), x)
    want = jax.grad(lambda x: jnp.sum(j_grad_multiply(x, 0.3)))(jnp.ones(4))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    np.testing.assert_allclose(g.numpy(), 0.3)


STAND_IN = '''"""A stand-in for the reference's torch model, for the tests: the TPU
package's model on the CPU, behind the reference's interface."""
import numpy as np
import torch

from dphubert_tpu import wav2vec2_model as _jax_model
from dphubert_tpu.params import tree_to_jax, unflatten_params


class _Loaded:
    def __init__(self, missing, unexpected):
        self.missing_keys, self.unexpected_keys = missing, unexpected


class _Model:
    def __init__(self, config):
        self.model = _jax_model(**config)
        self.params = None

    def load_state_dict(self, state_dict, strict=True):
        self.params = tree_to_jax(unflatten_params({k: v.numpy() for k, v in state_dict.items()}))
        return _Loaded([], [])

    def eval(self):
        return self

    def extract_features(self, waveforms):
        outs, lengths = self.model.extract_features(self.params, waveforms.numpy())
        return [torch.from_numpy(np.array(o)) for o in outs], lengths


def wav2vec2_model(**config):
    return _Model(config)
'''


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference")
    (root / "wav2vec2").mkdir()
    (root / "wav2vec2" / "__init__.py").write_text("")
    (root / "wav2vec2" / "model.py").write_text(STAND_IN)
    yield root
    for name in ("wav2vec2.model", "wav2vec2"):
        sys.modules.pop(name, None)


def test_verify_against_released_passes_and_fails(reference_dir, tmp_path):
    """A pruned checkpoint in the released format (``tests/
    test_verify_released.py``'s config) passes on the CPU (exit 0); with a
    NaN in one weight it fails (exit 1); a parameter count other than the
    expected one fails (exit 1)."""
    from dphubert_torch.cli import verify_against_released
    from dphubert_torch.interop import save_checkpoint

    from tests.test_verify_released import _small_pruned_config

    cfg = _small_pruned_config()
    model = pt.wav2vec2_model(device="cpu", generator=torch.Generator().manual_seed(4), **cfg)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    good = tmp_path / "released_style.pth"
    save_checkpoint(good, cfg, sd)
    common = ["--reference_dir", str(reference_dir), "--seconds", "0.5", "--device", "cpu"]
    assert verify_against_released.cli_main(["--ckpt", str(good)] + common) == 0
    n = sum(v.size for v in sd.values())
    assert verify_against_released.cli_main(
        ["--ckpt", str(good), "--expect_params", str(n)] + common) == 0
    assert verify_against_released.cli_main(
        ["--ckpt", str(good), "--expect_params", str(n + 1)] + common) == 1

    key = "encoder.transformer.layers.2.final_layer_norm.weight"
    bad = dict(sd)
    bad[key] = bad[key].copy()
    bad[key][0] = np.nan
    corrupt = tmp_path / "corrupt.pth"
    save_checkpoint(corrupt, cfg, bad)
    assert verify_against_released.cli_main(["--ckpt", str(corrupt)] + common) == 1
