"""Hand-written CUDA kernels of the port, each beside its plain version."""

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

__all__ = [
    "FlashAttentionFn",
    "PackedAttentionFn",
    "dropout_keep_mask",
    "dropout_threshold",
    "flash_attention",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_reference",
    "flash_attention_qkv",
    "flash_attention_reference",
    "packed_attention",
    "packed_attention_bwd_dkv",
    "packed_attention_bwd_dq",
    "packed_attention_bwd_reference",
    "packed_attention_qkv",
    "packed_attention_reference",
    "packed_num_groups",
]
