"""sha256-pinned release artifacts and the data directory layout (host copy
of `oai_analysis_2_tpu/utils/data.py:18-108`).

The registry names the reference's release tarballs with their pins. A
directory that already holds an artifact's extracted tree (pre-seeded
through `OAI_TPU_DATA_DIR`) is returned without touching the network;
otherwise the tarball is downloaded with retries, checked and extracted.
Without `OAI_TPU_DATA_DIR` the data lives in `build/data/` at the root of
the checkout (git-ignored, beside the kernels' `build/kernels/`).
"""

from __future__ import annotations

import hashlib
import os
import tarfile
import time
import urllib.request
from pathlib import Path

_GITHUB_RELEASE_TAG = "v2.0.0"
_BASE_URL = f"https://github.com/uncbiag/OAI_analysis_2/releases/download/{_GITHUB_RELEASE_TAG}/"

# artifact -> (sha256, extraction directory), as the reference publishes them
REGISTRY = {
    "oai-analysis-test-data.tar.gz": (
        "bfb5d5f17ff0886f5815c79fba119fc4294c35b8f9fcd586a171d9310cd90cdf",
        "test_data",
    ),
    "oai-analysis-atlases.tar.gz": (
        "9332f6756efcc6f525a8cf1807cfe793405181047f850d68fd962ad8e5ac1d7a",
        "atlases",
    ),
    "oai-analysis-models.tar.gz": (
        "ffd081ba26f9908f17790ecdb8b1d025bff32ccbdced9bf55158166561064458",
        "models",
    ),
}


def data_dir() -> Path:
    d = os.environ.get("OAI_TPU_DATA_DIR")
    p = Path(d) if d else Path(__file__).resolve().parents[2] / "build" / "data"
    p.mkdir(parents=True, exist_ok=True)
    return p


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fetch(name: str, retries: int = 5) -> Path:
    """The extracted directory of one registry artifact: returned at once
    when it exists and is not empty (pre-seeded), else downloaded, checked
    against its sha256 and extracted."""
    sha, extract_dir = REGISTRY[name]
    root = data_dir()
    out = root / extract_dir
    if out.exists() and any(out.iterdir()):
        return out

    tarball = root / name
    if not (tarball.exists() and _sha256(tarball) == sha):
        url = _BASE_URL + name
        last = None
        for attempt in range(retries):
            try:
                urllib.request.urlretrieve(url, tarball)
                break
            except Exception as e:  # noqa: BLE001
                last = e
                time.sleep(min(2**attempt, 30))
        else:
            raise RuntimeError(f"could not download {url} ({last}); pre-seed {out} to run offline")
        got = _sha256(tarball)
        if got != sha:
            tarball.unlink(missing_ok=True)
            raise RuntimeError(f"sha256 mismatch for {name}: {got} != {sha}")

    out.mkdir(parents=True, exist_ok=True)
    with tarfile.open(tarball) as tf:
        tf.extractall(out, filter="data")
    return out


def test_data_dir() -> Path:
    return fetch("oai-analysis-test-data.tar.gz")


def atlases_dir() -> Path:
    return fetch("oai-analysis-atlases.tar.gz")


def models_dir() -> Path:
    return fetch("oai-analysis-models.tar.gz")
