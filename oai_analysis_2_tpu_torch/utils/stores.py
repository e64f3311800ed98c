"""Byte stores for zarr volumes: local directories, HTTP(S), and S3; a host
copy of `oai_analysis_2_tpu/utils/stores.py:1-232`.

The reference cohort reads `s3://…` zarr stores directly through
xarray/s3fs (reference dask_processing.py:32-36; DaskComputationCoiled
cell 3 opens OAI image volumes from an S3 bucket). This module is the
dependency-free equivalent: a tiny key->bytes store
abstraction that `utils.zarr_io.read_zarr_volume` iterates over, with

  * `DirectoryStore` — posix directory stores,
  * `HTTPStore`     — any HTTP(S)-served store (bounded retries with
    backoff on transient errors, parallel chunk fetch), and
  * `S3Store`       — `s3://bucket/prefix` stores over S3's REST API:
    anonymous (public buckets) by default, AWS Signature V4 when
    credentials are present in the environment (AWS_ACCESS_KEY_ID /
    AWS_SECRET_ACCESS_KEY [/ AWS_SESSION_TOKEN]). The endpoint is
    derivable (virtual-hosted `https://{bucket}.s3.{region}.amazonaws.com`)
    or overridable via OAI_TPU_S3_ENDPOINT (path-style; also how the tests
    stand up a local S3 emulation without network egress).

Reads are the production path (the cohort pulls knees from the store);
writes stay local — results land in the manifest/output directory.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional

_RETRIES = 3
_BACKOFF_S = 0.5
_FETCH_THREADS = 16


class DirectoryStore:
    """Key -> bytes view of a posix directory (zarr v2 directory store)."""

    def __init__(self, root):
        self.root = Path(root)

    def get(self, key: str) -> Optional[bytes]:
        p = self.root / key
        try:
            return p.read_bytes()
        except (FileNotFoundError, IsADirectoryError):
            return None

    def getmany(self, keys: Iterable[str]) -> Dict[str, Optional[bytes]]:
        return {k: self.get(k) for k in keys}


class HTTPStore:
    """Key -> bytes over HTTP(S) GETs.

    Missing keys (404 / NoSuchKey) return None — zarr treats absent chunks
    as fill_value, so a sparse store reads correctly. Transient failures
    (5xx, connection resets) retry with linear backoff, bounded at
    `retries` attempts; remote object stores throttle and hiccup, and one
    chunk's hiccup must not kill a 1000-knee cohort run.
    """

    def __init__(self, base_url: str, retries: int = _RETRIES, signer=None):
        self.base_url = base_url.rstrip("/")
        self.retries = retries
        self.signer = signer  # callable(url) -> dict of extra headers

    def _url(self, key: str) -> str:
        return f"{self.base_url}/{urllib.parse.quote(key)}"

    def get(self, key: str) -> Optional[bytes]:
        url = self._url(key)
        last: Optional[Exception] = None
        for attempt in range(1, self.retries + 1):
            headers = self.signer(url) if self.signer else {}
            req = urllib.request.Request(url, headers=headers, method="GET")
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.read()
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    return None
                if e.code == 403 and self.signer is None:
                    # Anonymous S3 answers 403 for missing keys without
                    # ListBucket permission -> absent. With a SigV4 signer
                    # attached, 403 means auth failure (expired credentials,
                    # clock skew) — returning None would let zarr fill the
                    # chunk with fill_value and silently zero a volume, so
                    # signed reads must raise instead.
                    return None
                if e.code == 403:
                    raise IOError(
                        f"GET {url} -> 403 with SigV4 signer attached: "
                        "authentication failure (expired credentials / clock "
                        "skew), not a missing key; refusing to zero-fill"
                    ) from e
                last = e
            except (urllib.error.URLError, ConnectionError, TimeoutError) as e:
                last = e
            if attempt < self.retries:
                time.sleep(_BACKOFF_S * attempt)
        raise IOError(f"GET {url} failed after {self.retries} attempts: {last!r}")

    def getmany(self, keys: Iterable[str]) -> Dict[str, Optional[bytes]]:
        """Parallel fetch — remote stores are latency-bound, and a volume is
        hundreds of chunks; 16 concurrent GETs keep the pipe full."""
        keys = list(keys)
        with ThreadPoolExecutor(max_workers=min(_FETCH_THREADS, max(len(keys), 1))) as ex:
            vals = list(ex.map(self.get, keys))
        return dict(zip(keys, vals))


# ---------------------------------------------------------------------------
# AWS Signature Version 4 (GET-only, unsigned payload) — self-contained so
# private buckets work without boto; see the S3 REST API / SigV4 spec.
# ---------------------------------------------------------------------------


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class SigV4Signer:
    """Produces SigV4 `Authorization` (+ x-amz-*) headers for GET requests."""

    def __init__(
        self,
        access_key: str,
        secret_key: str,
        region: str,
        service: str = "s3",
        session_token: Optional[str] = None,
    ):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.service = service
        self.session_token = session_token

    def __call__(self, url: str, now: Optional[datetime.datetime] = None) -> Dict[str, str]:
        u = urllib.parse.urlsplit(url)
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        payload_hash = _sha256_hex(b"")  # GET: empty body

        headers = {
            "host": u.netloc,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        signed_names = ";".join(sorted(headers))
        canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
        # the key is quote()d by HTTPStore._url; S3 signs the encoded path
        canonical_request = "\n".join(
            [
                "GET",
                u.path or "/",
                u.query,  # already encoded; zarr keys carry no query
                canonical_headers,
                signed_names,
                payload_hash,
            ]
        )
        scope = f"{datestamp}/{self.region}/{self.service}/aws4_request"
        string_to_sign = "\n".join(
            ["AWS4-HMAC-SHA256", amz_date, scope, _sha256_hex(canonical_request.encode())]
        )
        k = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, self.service)
        k = _hmac(k, "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
        out = {k2: v for k2, v in headers.items() if k2 != "host"}
        out["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_names}, Signature={signature}"
        )
        return out


def _s3_store(url: str) -> HTTPStore:
    """`s3://bucket/prefix` -> an HTTPStore over S3's REST API.

    Endpoint: OAI_TPU_S3_ENDPOINT when set (path-style `{endpoint}/{bucket}`
    — MinIO/localstack/tests), else virtual-hosted
    `https://{bucket}.s3.{region}.amazonaws.com`. Signs with SigV4 when the
    standard AWS env credentials exist; anonymous otherwise (public
    buckets, e.g. registry-of-open-data mirrors of OAI imaging)."""
    u = urllib.parse.urlsplit(url)
    bucket, prefix = u.netloc, u.path.strip("/")
    region = os.environ.get("AWS_REGION") or os.environ.get("AWS_DEFAULT_REGION") or "us-east-1"
    endpoint = os.environ.get("OAI_TPU_S3_ENDPOINT")
    if endpoint:
        base = f"{endpoint.rstrip('/')}/{bucket}"
    else:
        base = f"https://{bucket}.s3.{region}.amazonaws.com"
    if prefix:
        base = f"{base}/{prefix}"
    access, secret = os.environ.get("AWS_ACCESS_KEY_ID"), os.environ.get("AWS_SECRET_ACCESS_KEY")
    signer = (
        SigV4Signer(access, secret, region, session_token=os.environ.get("AWS_SESSION_TOKEN"))
        if access and secret
        else None
    )
    return HTTPStore(base, signer=signer)


def is_remote(path) -> bool:
    return isinstance(path, str) and path.startswith(("s3://", "http://", "https://"))


def open_store(path):
    """Dispatch a path/URL to the right store: s3:// | http(s):// | posix."""
    if isinstance(path, str) and path.startswith("s3://"):
        return _s3_store(path)
    if isinstance(path, str) and path.startswith(("http://", "https://")):
        return HTTPStore(path)
    return DirectoryStore(path)
