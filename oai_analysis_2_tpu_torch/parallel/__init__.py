"""Cohort runtime (port of `oai_analysis_2_tpu/parallel/`): the resumable,
failure-isolating work queue over a per-host JSONL manifest."""

from oai_analysis_2_tpu_torch.parallel.cohort import CohortManifest, CohortRunner

__all__ = ["CohortManifest", "CohortRunner"]
