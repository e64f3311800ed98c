"""Cohort runtime and knee batching (port of `oai_analysis_2_tpu/parallel/`):
the resumable, failure-isolating work queue over a per-host JSONL manifest,
and the knee-batched pipeline."""

from oai_analysis_2_tpu_torch.parallel.batch import BatchKneePipeline
from oai_analysis_2_tpu_torch.parallel.cohort import CohortManifest, CohortRunner

__all__ = ["BatchKneePipeline", "CohortManifest", "CohortRunner"]
