"""Multi-card parallelism, the cohort runtime and knee batching (port of
`oai_analysis_2_tpu/parallel/`): a (data, space) device mesh over the ranks
of a `torch.distributed` process group, one process per card, with sharded
training and inference; the resumable, failure-isolating work queue over a
per-host JSONL manifest; and the knee-batched pipeline, on one card or
split over a mesh's data axis."""

from oai_analysis_2_tpu_torch.parallel.sharding import (
    make_device_mesh,
    make_sharded_train_step,
    shard_batch,
)
from oai_analysis_2_tpu_torch.parallel.cohort import CohortManifest, CohortRunner
from oai_analysis_2_tpu_torch.parallel.batch import BatchKneePipeline

__all__ = [
    "make_device_mesh",
    "make_sharded_train_step",
    "shard_batch",
    "CohortRunner",
    "CohortManifest",
    "BatchKneePipeline",
]
