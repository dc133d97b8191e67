"""Hand-written CUDA kernels of the port, each beside its plain version."""

from .flash_attention import flash_attention, flash_attention_reference
from .packed_attention import (
    packed_attention,
    packed_attention_reference,
    packed_num_groups,
)

__all__ = [
    "flash_attention",
    "flash_attention_reference",
    "packed_attention",
    "packed_attention_reference",
    "packed_num_groups",
]
