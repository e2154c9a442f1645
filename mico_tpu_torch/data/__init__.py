"""Data engine of the port (counterpart of `mico_tpu/data/`): annotation
datasets, tar-shard streams, samplers, loaders and the CUDA prefetcher.

Decoding runs on the host in numpy; batches are fixed-shape float32
arrays, tokenized between the loader and the step
(`tokenize_collate.BatchTokenizer`), and copied to the card one batch
ahead (`loader.CudaPrefetcher`). Task sampling and every draw come from
seeded Python and numpy generators in the JAX package's order, so one
corpus and seed give its batches.
"""

from mico_tpu_torch.data.anno_dataset import AnnoIndexedDataset, anno_collate
from mico_tpu_torch.data.build import (
    create_train_dataloaders,
    create_val_dataloaders,
)
from mico_tpu_torch.data.loader import CudaPrefetcher, DataLoader, MetaLoader
from mico_tpu_torch.data.mappers import AudioMapper, DepthMapper, VisionMapper
from mico_tpu_torch.data.sampler import ShardedSampler
from mico_tpu_torch.data.shards import ShardIndexedDataset

# data_registry (reference: data/data/__init__.py:1-9)
data_registry = {
    "annoindexed": AnnoIndexedDataset,
    "srcindexed": ShardIndexedDataset,
}

__all__ = [
    "AnnoIndexedDataset",
    "AudioMapper",
    "CudaPrefetcher",
    "DataLoader",
    "DepthMapper",
    "MetaLoader",
    "ShardIndexedDataset",
    "ShardedSampler",
    "VisionMapper",
    "anno_collate",
    "create_train_dataloaders",
    "create_val_dataloaders",
    "data_registry",
]
