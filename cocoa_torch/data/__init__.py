from cocoa_torch.data.fleet import (
    FleetDataset, TenantSpec, build_fleet, fleet_from_datasets,
    load_fleet_manifest, parse_dataset_ref, synth_fleet_specs,
    write_fleet_manifest,
)
from cocoa_torch.data.ingest import (
    IngestIndex, IngestReport, build_index, resolve_ingest_mode,
    stream_shard_dataset,
)
from cocoa_torch.data.libsvm import LibsvmData, load_libsvm
from cocoa_torch.data.sharding import ShardedDataset, shard_dataset
from cocoa_torch.data.slab_cache import SlabCache

__all__ = ["LibsvmData", "load_libsvm", "ShardedDataset", "shard_dataset",
           "FleetDataset", "TenantSpec", "build_fleet",
           "fleet_from_datasets", "load_fleet_manifest",
           "parse_dataset_ref", "synth_fleet_specs",
           "write_fleet_manifest", "IngestIndex", "IngestReport",
           "build_index", "resolve_ingest_mode", "stream_shard_dataset",
           "SlabCache"]
