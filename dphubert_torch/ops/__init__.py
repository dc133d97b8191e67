"""Hand-written CUDA kernels of the port, each beside its plain version,
the positional conv's autograd function (``PosConvFn``), and the launch
counters of all of them."""

from .attention_common import dropout_keep_mask, dropout_threshold
from .flash_attention import (
    FlashAttentionFn,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_qkv,
    flash_attention_reference,
)
from .packed_attention import (
    PackedAttentionFn,
    packed_attention,
    packed_attention_bwd_dkv,
    packed_attention_bwd_dq,
    packed_attention_bwd_reference,
    packed_attention_qkv,
    packed_attention_reference,
    packed_num_groups,
)
from .norm import NormFn, layer_norm, norm_bwd, norm_fwd
from .pos_conv import PosConvFn
from .wavlm_attention import (
    WavLMAttentionFn,
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
    wavlm_attention_reference,
    wavlm_route,
)


class RematLayerCount:
    """``models.components.remat_layer`` counts in ``launches`` each
    checkpointed encoder layer whose forward a backward recomputes, on any
    device.  No kernel of its own: a count that a trace of replayed graphs,
    which carry no annotations, can be checked against."""

    launches = 0


# every kernel's wrapper by the kernel's name; each wrapper's ``launches``
# counts its launches (a CUDA graph's capture counts once, its replays not);
# ``pos_conv_dgrad`` counts the pos conv's input gradients taken as forward
# convs (cuDNN's kernels, not the port's), ``remat_layer`` the layers
# recomputed under remat
LAUNCH_COUNTERS = {
    "packed_attention_fwd": packed_attention,
    "flash_attention_fwd": flash_attention,
    "packed_attention_bwd_dq": packed_attention_bwd_dq,
    "packed_attention_bwd_dkv": packed_attention_bwd_dkv,
    "flash_attention_bwd_dq": flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
    "wavlm_attention_fwd": wavlm_attention_fwd,
    "wavlm_attention_bwd_dkv": wavlm_attention_bwd_dkv,
    "wavlm_attention_bwd_fused": wavlm_attention_bwd_fused,
    "wavlm_attention_fwd_general": wavlm_attention_fwd_general,
    "wavlm_attention_bwd_dkv_general": wavlm_attention_bwd_dkv_general,
    "wavlm_attention_bwd_dq": wavlm_attention_bwd_dq,
    "wavlm_attention_bwd_dbias": wavlm_attention_bwd_dbias,
    "norm_fwd": norm_fwd,
    "norm_bwd": norm_bwd,
    "pos_conv_dgrad": PosConvFn,
    "remat_layer": RematLayerCount,
}


def kernel_launches() -> dict:
    """Each kernel's launch counter, by name (``LAUNCH_COUNTERS``)."""
    return {name: fn.launches for name, fn in LAUNCH_COUNTERS.items()}


__all__ = [
    "LAUNCH_COUNTERS",
    "FlashAttentionFn",
    "NormFn",
    "PackedAttentionFn",
    "PosConvFn",
    "RematLayerCount",
    "WavLMAttentionFn",
    "dropout_keep_mask",
    "dropout_threshold",
    "flash_attention",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_reference",
    "flash_attention_qkv",
    "flash_attention_reference",
    "kernel_launches",
    "layer_norm",
    "norm_bwd",
    "norm_fwd",
    "packed_attention",
    "packed_attention_bwd_dkv",
    "packed_attention_bwd_dq",
    "packed_attention_bwd_reference",
    "packed_attention_qkv",
    "packed_attention_reference",
    "packed_num_groups",
    "wavlm_attention",
    "wavlm_attention_bwd_dbias",
    "wavlm_attention_bwd_dkv",
    "wavlm_attention_bwd_dkv_general",
    "wavlm_attention_bwd_dq",
    "wavlm_attention_bwd_fused",
    "wavlm_attention_bwd_reference",
    "wavlm_attention_fwd",
    "wavlm_attention_fwd_general",
    "wavlm_attention_qkv",
    "wavlm_attention_reference",
    "wavlm_route",
]
