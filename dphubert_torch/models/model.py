"""Top-level model API: the :class:`Wav2Vec2Model` module and its factories.

``wav2vec2_model(**config)`` accepts the portable config dict verbatim;
the named presets build the published architectures.  Every factory builds
on the card unless the caller passes ``device="cpu"``, and raises when CUDA
is asked for and absent.  Random init draws from an explicit
``torch.Generator`` (seed 0 unless one is given) with the distributions of
torch's default initialisers, as the TPU package's ``init_params`` does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..configs import ModelSpec, config_from_spec, spec_from_config
from . import components
from .gates import has_gates

def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it asks for CUDA and there is
    none (the port does not carry on silently on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


class Wav2Vec2Model(nn.Module):
    """wav2vec 2.0 / HuBERT / WavLM with the portable state-dict layout.

    Parameters are created uninitialised; the factories initialise them
    (``reset_parameters``) and ``load_model`` loads them from a checkpoint.
    """

    def __init__(self, spec: ModelSpec, config_override: Optional[dict] = None):
        super().__init__()
        self.spec = spec
        # surgery emits configs that keep what a spec cannot represent (the
        # recorded FFN width of a dead layer); keep the dict for checkpoints
        self._config_override = config_override
        self.feature_extractor = components.FeatureExtractor(spec)
        self.encoder = components.Encoder(spec)
        if spec.aux_num_out is not None:
            self.aux = components.Linear(spec.embed_dim, spec.aux_num_out)

    @property
    def config(self) -> dict:
        if self._config_override is not None:
            return dict(self._config_override)
        return config_from_spec(self.spec, prune_flags=True)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init in module order from ``generator`` (a CPU generator
        for parameters on the CPU)."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def extract_features(
        self,
        waveforms: torch.Tensor,
        lengths: Optional[torch.Tensor] = None,
        num_layers: Optional[int] = None,
        *,
        gates: Optional[dict] = None,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
        remat: bool = False,
    ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        """Per-layer hidden states (index 0 = projected CNN features) and
        the valid output lengths.

        ``gates`` is the nested HardConcrete gate dict of
        ``models/gates.py`` (sampled for training, compiled for eval), or
        None for no gates.  ``training=True`` turns dropout on, drawn from
        ``generator`` (on the waveforms' device; no generator, no dropout, as
        the TPU package without an rng); a gated spec must then get gates.
        ``remat`` checkpoints each encoder layer (activations recomputed in
        the backward; the feature extractor is not checkpointed).
        LayerDrop never applies here: distillation sees every layer."""
        if gates is None and training and has_gates(self.spec):
            raise ValueError("spec has HardConcrete gates; pass gates= (see sample_gates)")
        generator = generator if training else None
        if self.spec.normalize_waveform:
            waveforms = components.normalize_waveform(waveforms, lengths)
        x, lengths = self.feature_extractor(waveforms, lengths, gates)
        return (self.encoder.extract_features(x, lengths, num_layers, gates, generator, remat),
                lengths)

    def forward(
        self,
        waveforms: torch.Tensor,
        lengths: Optional[torch.Tensor] = None,
        *,
        gates: Optional[dict] = None,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
        layer_drop_u: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Final encoder output (through the aux head if configured) and
        the valid output lengths (the TPU package's ``forward``).

        ``gates`` and ``training`` as in ``extract_features``; in training
        with a ``generator`` dropout is on and LayerDrop applies
        (``Transformer.forward``; its per-layer uniforms drawn from
        ``generator`` or injected as ``layer_drop_u``).  No generator, no
        dropout and no LayerDrop, as the TPU package without an rng."""
        if gates is None and training and has_gates(self.spec):
            raise ValueError("spec has HardConcrete gates; pass gates= (see sample_gates)")
        generator = generator if training else None
        if layer_drop_u is not None and generator is None:
            raise ValueError("layer_drop_u applies in training with a generator")
        if self.spec.normalize_waveform:
            waveforms = components.normalize_waveform(waveforms, lengths)
        x, lengths = self.feature_extractor(waveforms, lengths, gates)
        x = self.encoder(x, lengths, gates, generator, layer_drop_u)
        if self.spec.aux_num_out is not None:
            x = self.aux(x)
        return x, lengths


def _build(spec: ModelSpec, device, generator: Optional[torch.Generator]) -> Wav2Vec2Model:
    device = resolve_device(device)
    model = Wav2Vec2Model(spec)
    model.reset_parameters(
        generator if generator is not None else torch.Generator().manual_seed(0)
    )
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------


def wav2vec2_model(
    *, device="cuda", generator: Optional[torch.Generator] = None, **configs
) -> Wav2Vec2Model:
    """Build a randomly initialised model from a portable config dict
    (wav2vec 2.0 / HuBERT, or WavLM: the ``encoder_remaining_heads`` key
    selects it, as in the reference's ``model.py:172-178``)."""
    return _build(spec_from_config(**configs), device, generator)


def wav2vec2_model_original(**configs) -> Wav2Vec2Model:
    if "encoder_remaining_heads" in configs:
        raise ValueError("WavLM configs must go through wavlm_model")
    return wav2vec2_model(**configs)


def wavlm_model(**configs) -> Wav2Vec2Model:
    """A WavLM model; named presets pass uniform head counts
    (``encoder_num_heads``), which expand to index lists."""
    if "encoder_remaining_heads" not in configs:
        n = configs["encoder_num_layers"]
        heads = configs.pop("encoder_num_heads")
        configs["encoder_total_num_heads"] = [heads] * n
        configs["encoder_remaining_heads"] = [list(range(heads)) for _ in range(n)]
    return wav2vec2_model(**configs)


def _base_like(
    *,
    extractor_mode: str,
    embed_dim: int,
    num_layers: int,
    num_heads: int,
    ff_interm: int,
    layer_norm_first: bool,
    conv_bias: bool = False,
    normalize_waveform: bool = False,
    encoder_projection_dropout: float = 0.1,
    encoder_attention_dropout: float = 0.1,
    encoder_ff_interm_dropout: float = 0.1,
    encoder_dropout: float = 0.1,
    encoder_layer_drop: float = 0.1,
    aux_num_out: Optional[int] = None,
    **kw,
) -> Wav2Vec2Model:
    return wav2vec2_model(
        extractor_mode=extractor_mode,
        extractor_conv_layer_config=None,
        extractor_conv_bias=conv_bias,
        encoder_embed_dim=embed_dim,
        encoder_projection_dropout=encoder_projection_dropout,
        encoder_pos_conv_kernel=128,
        encoder_pos_conv_groups=16,
        encoder_num_layers=num_layers,
        encoder_use_attention=[True] * num_layers,
        encoder_use_feed_forward=[True] * num_layers,
        encoder_num_heads=[num_heads] * num_layers,
        encoder_head_dim=embed_dim // num_heads,
        encoder_attention_dropout=encoder_attention_dropout,
        encoder_ff_interm_features=[ff_interm] * num_layers,
        encoder_ff_interm_dropout=encoder_ff_interm_dropout,
        encoder_dropout=encoder_dropout,
        encoder_layer_norm_first=layer_norm_first,
        encoder_layer_drop=encoder_layer_drop,
        aux_num_out=aux_num_out,
        normalize_waveform=normalize_waveform,
        **kw,  # device, generator and the prune flags
    )


def wav2vec2_base(**kw) -> Wav2Vec2Model:
    """wav2vec 2.0 Base."""
    return _base_like(
        extractor_mode="group_norm", embed_dim=768, num_layers=12,
        num_heads=12, ff_interm=3072, layer_norm_first=False, **kw,
    )


def wav2vec2_large(**kw) -> Wav2Vec2Model:
    return _base_like(
        extractor_mode="group_norm", embed_dim=1024, num_layers=24,
        num_heads=16, ff_interm=4096, layer_norm_first=False, **kw,
    )


def wav2vec2_large_lv60k(**kw) -> Wav2Vec2Model:
    return _base_like(
        extractor_mode="layer_norm", conv_bias=True, embed_dim=1024,
        num_layers=24, num_heads=16, ff_interm=4096, layer_norm_first=True,
        normalize_waveform=True, **kw,
    )


def hubert_base(**kw) -> Wav2Vec2Model:
    """HuBERT Base: 12 layers, 768 wide, 12 heads x 64, FFN 3072."""
    kw.setdefault("encoder_ff_interm_dropout", 0.0)
    kw.setdefault("encoder_layer_drop", 0.05)
    return _base_like(
        extractor_mode="group_norm", embed_dim=768, num_layers=12,
        num_heads=12, ff_interm=3072, layer_norm_first=False, **kw,
    )


def _no_dropout(kw: dict) -> dict:
    for k in ("encoder_projection_dropout", "encoder_attention_dropout",
              "encoder_ff_interm_dropout", "encoder_dropout", "encoder_layer_drop"):
        kw.setdefault(k, 0.0)
    return kw


def hubert_large(**kw) -> Wav2Vec2Model:
    return _base_like(
        extractor_mode="layer_norm", embed_dim=1024, num_layers=24,
        num_heads=16, ff_interm=4096, layer_norm_first=True,
        normalize_waveform=True, **_no_dropout(kw),
    )


def hubert_xlarge(**kw) -> Wav2Vec2Model:
    return _base_like(
        extractor_mode="layer_norm", embed_dim=1280, num_layers=48,
        num_heads=16, ff_interm=5120, layer_norm_first=True,
        normalize_waveform=True, **_no_dropout(kw),
    )


def _wavlm_like(*, extractor_mode: str, embed_dim: int, num_layers: int, num_heads: int,
                ff_interm: int, ff_interm_dropout: float, layer_norm_first: bool,
                normalize_waveform: bool, aux_num_out: Optional[int] = None,
                device="cuda", generator: Optional[torch.Generator] = None,
                **kw) -> Wav2Vec2Model:
    """The TPU package's WavLM presets: the dropout rates may be overridden
    through ``kw``; its other keys (prune flags) are ignored there and
    here."""
    n = num_layers
    return wavlm_model(
        device=device,
        generator=generator,
        extractor_mode=extractor_mode,
        extractor_conv_layer_config=None,
        extractor_conv_bias=False,
        encoder_embed_dim=embed_dim,
        encoder_projection_dropout=kw.get("encoder_projection_dropout", 0.1),
        encoder_pos_conv_kernel=128,
        encoder_pos_conv_groups=16,
        encoder_num_layers=n,
        encoder_use_attention=[True] * n,
        encoder_use_feed_forward=[True] * n,
        encoder_num_heads=num_heads,
        encoder_num_buckets=320,
        encoder_max_distance=800,
        encoder_attention_dropout=kw.get("encoder_attention_dropout", 0.1),
        encoder_ff_interm_features=[ff_interm] * n,
        encoder_ff_interm_dropout=kw.get("encoder_ff_interm_dropout", ff_interm_dropout),
        encoder_dropout=kw.get("encoder_dropout", 0.1),
        encoder_layer_norm_first=layer_norm_first,
        encoder_layer_drop=kw.get("encoder_layer_drop", 0.1),
        aux_num_out=aux_num_out,
        normalize_waveform=normalize_waveform,
    )


def wavlm_base(**kw) -> Wav2Vec2Model:
    """WavLM Base: 12 layers, 768 wide, 12 heads x 64, FFN 3072, 320
    buckets, max distance 800."""
    return _wavlm_like(extractor_mode="group_norm", embed_dim=768, num_layers=12,
                       num_heads=12, ff_interm=3072, ff_interm_dropout=0.1,
                       layer_norm_first=False, normalize_waveform=False, **kw)


def wavlm_large(**kw) -> Wav2Vec2Model:
    """WavLM Large: 24 layers, 1024 wide, 16 heads x 64, FFN 4096."""
    return _wavlm_like(extractor_mode="layer_norm", embed_dim=1024, num_layers=24,
                       num_heads=16, ff_interm=4096, ff_interm_dropout=0.0,
                       layer_norm_first=True, normalize_waveform=True, **kw)
