"""The data pipeline: decode, manifests, static-shape batching, the loader."""

from .audio import audio_info, load_audio
from .loader import AudioDataset, DistillDataLoader, crop_to
from .manifest import create_tsv, read_manifest
from .sampler import (
    BucketizeBatchSampler,
    DistributedBatchSampler,
    StaticShapeBatcher,
)

__all__ = [
    "load_audio",
    "audio_info",
    "create_tsv",
    "read_manifest",
    "AudioDataset",
    "DistillDataLoader",
    "crop_to",
    "BucketizeBatchSampler",
    "DistributedBatchSampler",
    "StaticShapeBatcher",
]
