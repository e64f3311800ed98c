"""Training-config JSON reader (copy of `oai_analysis_2_tpu/utils/config.py:118`)."""

from __future__ import annotations

import json


def load_json_to_dict(json_file) -> dict:
    """Load a training-config JSON into a plain dict."""
    with open(json_file) as f:
        return json.load(f)
