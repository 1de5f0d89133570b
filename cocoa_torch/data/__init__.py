from cocoa_torch.data.libsvm import LibsvmData, load_libsvm
from cocoa_torch.data.sharding import ShardedDataset, shard_dataset

__all__ = ["LibsvmData", "load_libsvm", "ShardedDataset", "shard_dataset"]
