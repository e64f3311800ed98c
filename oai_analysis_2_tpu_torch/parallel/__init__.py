"""Cohort runtime and knee batching (port of `oai_analysis_2_tpu/parallel/`):
the resumable, failure-isolating work queue over a per-host JSONL manifest,
and the knee-batched pipeline. The JAX package's sharding helpers
(`make_device_mesh`, `make_sharded_train_step`, `shard_batch`) have no
counterpart: the port's target is one card."""

from oai_analysis_2_tpu_torch.parallel.batch import BatchKneePipeline
from oai_analysis_2_tpu_torch.parallel.cohort import CohortManifest, CohortRunner

__all__ = ["BatchKneePipeline", "CohortManifest", "CohortRunner"]
