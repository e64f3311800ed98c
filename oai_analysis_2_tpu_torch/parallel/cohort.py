"""Cohort batch runtime — the Dask replacement (host copy of
`oai_analysis_2_tpu/parallel/cohort.py:1-716`).

The reference fans a per-knee delayed DAG (segment ∥ register -> warp ->
thickness) out to cloud GPU workers via Dask's TCP scheduler
(dask_processing.py, DaskComputationCoiled.ipynb), re-downloading models per
task and with no recompute avoidance (SURVEY.md §5). Here the dynamic task
DAG collapses into a static compiled per-knee pipeline plus a simple,
fault-tolerant work queue:

  * an append-only JSONL manifest records per-item status (done/failed +
    error) — a restarted run skips completed items (the reference's
    planned-but-missing Dagster recompute avoidance). Each host appends to
    its OWN shard file (`<name>.h<id>.jsonl`) and reads merge all shards, so
    N concurrent writers on a shared filesystem never clobber each other
    (a read-modify-rewrite single JSON file loses cross-host updates);
  * items are processed by a user pipeline callable; failures are caught,
    recorded, and do not kill the run;
  * multi-host fan-out with DYNAMIC claim-based scheduling (default): hosts
    claim items by appending claim records to their own shard, so a fast
    host drains the queue while a slow or dead host strands nothing — the
    load-balancing Dask's distributed scheduler provides the reference
    (dask_processing.py:1-7). Stale claims (host died mid-item) are stolen
    after `claim_ttl`. Static index striding remains available
    (scheduling="static");
  * per-stage wall times are recorded per item (the reference's only timing
    was a notebook %%time, SURVEY.md §5), and the runner surfaces live
    progress + ETA and writes a machine-readable run summary
    (`<manifest>.summary.json`) — the stand-in for Dask's dashboard.

The manifest records are the JAX package's, key for key, so a cohort that
one package started can be resumed by the other. The host index and count
come from `torch.distributed` when a process group is up (JAX's tunnel
probing has no counterpart here).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class CohortManifest:
    """Resumable run state, persisted after every item.

    On disk: one append-only JSONL shard per host (`<name>.h<id>.jsonl`,
    one `{"key": ..., "status": ..., "time": ...}` record per line; last
    record per key wins). A host only ever appends to its own shard —
    single-`write` + O_APPEND, so concurrent hosts on a shared filesystem
    cannot lose each other's updates. A legacy single-JSON manifest at
    `path` is read as the baseline if present.
    """

    path: Path
    host: int = 0
    items: Dict[str, dict] = dataclasses.field(default_factory=dict)

    @classmethod
    def open(cls, path, host: Optional[int] = None) -> "CohortManifest":
        path = Path(path)
        if host is None:
            host, _ = _host_info()
        m = cls(path=path, host=host)
        m.reload()
        return m

    def _shard_paths(self) -> List[Path]:
        return sorted(self.path.parent.glob(self.path.name + ".h*.jsonl"))

    def _own_shard(self) -> Path:
        return self.path.parent / f"{self.path.name}.h{self.host}.jsonl"

    @staticmethod
    def _prefer(cur: Optional[dict], rec: dict) -> dict:
        """Merge rule: a TERMINAL record (done / failed-with-exhausted-
        retries) beats any non-terminal one regardless of timestamp — a
        claim heartbeat racing an item's completion must never mask the
        completion. Within the same tier, newest time wins (ties to the
        later-read record)."""
        if cur is None:
            return rec
        terminal = ("done", "failed")
        cur_t, rec_t = cur.get("status") in terminal, rec.get("status") in terminal
        if cur_t != rec_t:
            return cur if cur_t else rec
        return rec if rec.get("time", 0) >= cur.get("time", 0) else cur

    def reload(self) -> None:
        """Merge the legacy JSON baseline + every host's shard via
        `_prefer` (terminal records win; else newest)."""
        items: Dict[str, dict] = {}
        if self.path.exists():
            with open(self.path) as f:
                items.update(json.load(f))
        for shard in self._shard_paths():
            with open(shard) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    key = rec.pop("key")
                    items[key] = self._prefer(items.get(key), rec)
        self.items = items

    def is_done(self, key: str) -> bool:
        return self.items.get(key, {}).get("status") == "done"

    def mark(self, key: str, status: str, **info) -> None:
        rec = {"status": status, "time": time.time(), **info}
        # in-memory view follows the same merge rule as reload(): a racing
        # heartbeat claim must not clobber a completion
        self.items[key] = self._prefer(self.items.get(key), rec)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        line = (json.dumps({"key": key, **rec}) + "\n").encode()
        # one write(2) on an O_APPEND descriptor: a record lands whole
        fd = os.open(self._own_shard(), os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)

    def summary(self) -> dict:
        counts: Dict[str, int] = {}
        for v in self.items.values():
            counts[v["status"]] = counts.get(v["status"], 0) + 1
        return counts


def _host_info() -> Tuple[int, int]:
    """(rank, world size) of the initialized `torch.distributed` process
    group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CohortRunner:
    """Run a pipeline over a cohort of items with resume + failure isolation.

    pipeline: Callable[(item) -> dict of result metadata (json-serializable)].
    Heavy outputs (probmaps, meshes) should be written to disk by the
    pipeline; the returned metadata lands in the manifest.
    """

    def __init__(
        self,
        pipeline: Callable[[Any], dict],
        manifest_path="cohort_manifest.json",
        max_retries: int = 1,
        verbose: bool = True,
        host: Optional[int] = None,
        n_hosts: Optional[int] = None,
        scheduling: str = "dynamic",
        claim_ttl: float = 1800.0,
        claim_heartbeat: Optional[float] = None,
        claim_settle="auto",
        poll_seconds: float = 2.0,
        batch_pipeline: Optional[Callable[[List[Any]], List[dict]]] = None,
        batch_size: int = 1,
        prepare: Optional[Callable[[Any], Any]] = None,
        prefetch_depth: int = 2,
    ):
        """host / n_hosts override torch.distributed's rank / world size —
        for external schedulers (SLURM array jobs) and tests.

        scheduling: "dynamic" (default) — hosts claim items first-come
        through the shard manifests, so slow/dead hosts strand no work;
        "static" — fixed index striding (deterministic assignment).

        claim_ttl: seconds after which another host may steal an unfinished
        claim. With heartbeats (below) this only needs to exceed a few
        heartbeat intervals; without them it MUST exceed the worst-case
        per-item wall time, else a slow item gets double-processed
        (at-least-once semantics, like Dask's worker-loss retry).

        claim_settle: pause between staking a claim and resolving the winner
        — must exceed the shared filesystem's write-visibility lag so
        contemporaneous claims see each other (claim timestamps are taken
        before their writes land). "auto" (default) measures the manifest
        directory's write->reopen-read latency once at construction and
        sets max(20x worst probe, 0.1 s), capped at 2 s — local disks land
        on the 0.1 s floor, laggy network filesystems scale up. A single
        host cannot observe CROSS-host visibility on asynchronously-
        replicated filesystems, so the safety factor is generous and an
        explicit float still overrides.

        claim_heartbeat: while executing claimed items, a daemon thread
        re-appends fresh claim records every `claim_heartbeat` seconds —
        the liveness signal Dask workers send their scheduler. A live host
        processing a slow item keeps its claim fresh indefinitely; a dead
        host's claims go stale one ttl after its last heartbeat. Defaults
        to claim_ttl/3 (capped at 60 s); pass 0 to disable.

        batch_pipeline + batch_size: claim up to batch_size items and run
        them through ONE call (any callable, e.g. a knee-batched
        pipeline). Returns one result dict per
        item, in order. claim_ttl must exceed the worst-case BATCH wall
        time (claims are staked while the batch accumulates). `pipeline`
        stays the single-item fallback for retries of partial batches.

        prepare + prefetch_depth: host-side input preparation (NIfTI/zarr
        read + decode) run on a background thread up to `prefetch_depth`
        items AHEAD of execution, so decoding knee k+1 overlaps knee k's
        device compute — the double-buffered host->device feed (SURVEY §7;
        Dask gets this from worker thread pools). The pipeline then
        receives prepare(item) instead of item. Speculative prefetches of
        items another host claims first cost only a wasted read.
        """
        auto_host, auto_n = _host_info()
        self.host = auto_host if host is None else host
        self.n_hosts = auto_n if n_hosts is None else n_hosts
        self.pipeline = pipeline
        self.manifest = CohortManifest.open(manifest_path, host=self.host)
        self.max_retries = max_retries
        self.verbose = verbose
        if scheduling not in ("dynamic", "static"):
            raise ValueError(f"scheduling must be 'dynamic' or 'static', got {scheduling!r}")
        self.scheduling = scheduling
        self.claim_ttl = claim_ttl
        self.claim_heartbeat = (
            min(claim_ttl / 3.0, 60.0) if claim_heartbeat is None else claim_heartbeat
        )
        self.claim_settle = (
            self._measure_claim_settle() if claim_settle == "auto"
            else float(claim_settle)
        )
        self.poll_seconds = poll_seconds
        self.batch_pipeline = batch_pipeline
        self.batch_size = max(int(batch_size), 1)
        self.prepare = prepare
        self.prefetch_depth = max(int(prefetch_depth), 1)
        self._prefetched: Dict[str, Any] = {}  # key -> Future
        if self.batch_size > 1 and batch_pipeline is None:
            raise ValueError("batch_size > 1 requires a batch_pipeline")

    def _measure_claim_settle(self) -> float:
        """Calibrate the claim settle delay to the manifest filesystem: probe
        write+fsync -> reopen-read latency 3x, take the worst, apply a 20x
        safety factor, clamp to [0.1 s, 2 s]. See the constructor docstring
        for why this is a lower bound on cross-host visibility."""
        import uuid

        probe = self.manifest.path.parent / f".settle_probe_{uuid.uuid4().hex}"
        worst = 0.0
        try:
            probe.parent.mkdir(parents=True, exist_ok=True)
            for i in range(3):
                payload = f"{self.host}:{i}"
                t0 = time.time()
                with open(probe, "w") as f:
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                while time.time() - t0 < 2.0:
                    try:
                        if probe.read_text() == payload:
                            break
                    except OSError:
                        pass
                    time.sleep(0.005)
                worst = max(worst, time.time() - t0)
        except OSError:
            return 0.1  # unprobeable filesystem: the local-disk floor
        finally:
            try:
                probe.unlink()
            except OSError:
                pass
        return float(min(max(worst * 20.0, 0.1), 2.0))

    # -- item state helpers -------------------------------------------------------

    def _is_finished(self, rec: Optional[dict]) -> bool:
        return bool(rec) and (
            rec["status"] == "done"
            or (rec["status"] == "failed" and rec.get("attempts", 0) > self.max_retries)
        )

    def _is_fresh_claim(self, rec: Optional[dict]) -> bool:
        return (
            bool(rec)
            and rec["status"] == "claim"
            and (time.time() - rec.get("time", 0)) < self.claim_ttl
        )

    def _progress_line(self, keys: Sequence[str]) -> str:
        recs = [self.manifest.items.get(k) for k in keys]
        done = sum(1 for r in recs if r and r["status"] == "done")
        failed = sum(1 for r in recs if r and r["status"] == "failed")
        secs = [r.get("seconds", 0.0) for r in recs if r and r["status"] == "done"]
        eta = ""
        if secs and done < len(keys):
            per_item = sum(secs) / len(secs)
            remaining = len(keys) - done - failed
            eta = f", ETA ~{per_item * remaining / max(self.n_hosts, 1):.0f}s"
        return f"[cohort] {done}/{len(keys)} done, {failed} failed{eta}"

    def _run_item(self, key: str, item: Any) -> None:
        attempts = self.manifest.items.get(key, {}).get("attempts", 0)
        t0 = time.time()
        try:
            result = self.pipeline(self._take_prepared(key, item))
            self.manifest.mark(
                key, "done", seconds=time.time() - t0, attempts=attempts + 1,
                result=result,
            )
            if self.verbose:
                print(f"[cohort] done: {key} ({time.time() - t0:.1f}s)")
        except Exception as e:  # noqa: BLE001 — isolate item failures
            status = "failed" if attempts + 1 > self.max_retries else "retry"
            self.manifest.mark(
                key, status, seconds=time.time() - t0, attempts=attempts + 1,
                error=f"{type(e).__name__}: {e}",
                trace=traceback.format_exc(limit=8),
            )
            if self.verbose:
                print(f"[cohort] {status}: {key}: {e}")

    def _write_summary(self, keys: Sequence[str], wall_seconds: float) -> dict:
        """Machine-readable run summary next to the manifest — the cohort
        observability surface the reference gets from Dask's dashboard."""
        summary = self.manifest.summary()
        secs = [
            r.get("seconds", 0.0)
            for k in keys
            if (r := self.manifest.items.get(k)) and r["status"] == "done"
        ]
        out = {
            "counts": summary,
            "n_items": len(keys),
            "wall_seconds": round(wall_seconds, 2),
            "mean_item_seconds": round(sum(secs) / len(secs), 2) if secs else None,
            "items_per_hour": round(3600.0 * len(secs) / wall_seconds, 2)
            if wall_seconds > 0 and secs
            else None,
            "host": self.host,
            "n_hosts": self.n_hosts,
            "scheduling": self.scheduling,
        }
        atlas = self._aggregate_thickness_atlas(keys)
        if atlas is not None:
            out["thickness_atlas"] = atlas
        path = self.manifest.path.parent / (self.manifest.path.name + ".summary.json")
        try:
            path.write_text(json.dumps(out, indent=1))
        except OSError:
            pass
        return summary

    def _aggregate_thickness_atlas(self, keys: Sequence[str]):
        """Fold every done knee's atlas-mapped 2D raster (the
        `thickness_2d` path a KneePipeline(atlas_products=True).run_path
        records) into a population mean/count thickness atlas — written as
        `<manifest>.thickness_atlas.npz`. Reads the MERGED manifest, so on a
        multi-host run whichever host finishes last aggregates every host's
        knees. Returns scalar stats for the summary JSON, or None when no
        knee produced rasters."""
        t2d_paths = [
            p
            for k in keys
            if (r := self.manifest.items.get(k))
            and r.get("status") == "done"
            and (p := (r.get("result") or {}).get("thickness_2d"))
        ]
        if not t2d_paths:
            return None
        from oai_analysis_2_tpu_torch.engine.atlas_products import aggregate_thickness_maps

        atlas_path = self.manifest.path.parent / (
            self.manifest.path.name + ".thickness_atlas.npz"
        )
        try:
            agg = aggregate_thickness_maps(t2d_paths, out_path=atlas_path)
        except OSError:
            return None
        if agg is None:
            return None
        stats = {"path": str(atlas_path), "n_knees": int(agg["n_knees"])}
        for name in ("fc", "tc"):
            c = agg[f"{name}_counts"]
            m = agg[f"{name}_mean"]
            occ = c > 0
            stats[f"{name}_mean_thickness_mm"] = (
                round(float(m[occ].mean()), 4) if occ.any() else 0.0
            )
            stats[f"{name}_raster_coverage"] = round(float(occ.mean()), 4)
        return stats

    # -- scheduling loops ---------------------------------------------------------

    # -- input prefetch (double-buffered host feed) --------------------------------

    def _pump_prefetch(self) -> None:
        """Submit prepare() for upcoming candidates until `prefetch_depth`
        are outstanding. Bounded: at most prefetch_depth decoded items live."""
        if self.prepare is None:
            return
        if getattr(self, "_prefetch_pool", None) is None:
            from concurrent.futures import ThreadPoolExecutor

            self._prefetch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="cohort-prefetch"
            )
        queue = getattr(self, "_prefetch_queue", [])
        while queue and len(self._prefetched) < self.prefetch_depth:
            key, item = queue.pop(0)
            if key not in self._prefetched:
                self._prefetched[key] = self._prefetch_pool.submit(self.prepare, item)

    def _set_prefetch_queue(self, candidates) -> None:
        """Replace the upcoming-candidate list ((key, item) pairs, in
        expected execution order) and top up the in-flight prefetches."""
        if self.prepare is None:
            return
        self._prefetch_queue = [
            (k, it) for k, it in candidates if k not in self._prefetched
        ]
        self._pump_prefetch()

    def _take_prepared(self, key: str, item: Any) -> Any:
        """The prepared value for `key`: a finished/running prefetch if one
        exists, else prepare() inline. Errors surface here, inside the
        caller's failure-isolation try."""
        if self.prepare is None:
            return item
        fut = self._prefetched.pop(key, None)
        self._pump_prefetch()  # keep the lookahead full while we wait
        return fut.result() if fut is not None else self.prepare(item)

    def _heartbeat_claims(self, keys: Sequence[str]):
        """Daemon thread re-appending fresh claim records for in-flight keys
        every `claim_heartbeat` seconds (a live host processing a slow item
        keeps its claims fresh; peers see the newest record — a fresh claim —
        and keep waiting). Returns a stop callable; no-op when disabled."""
        import threading

        if self.scheduling != "dynamic" or self.claim_heartbeat <= 0:
            return lambda: None
        stop = threading.Event()
        attempts = {
            k: self.manifest.items.get(k, {}).get("attempts", 0) for k in keys
        }

        def beat():
            while not stop.wait(self.claim_heartbeat):
                for k in keys:
                    rec = self.manifest.items.get(k, {})
                    # refresh ONLY still-claimed keys: once an item lands
                    # done/retry/failed, a beat must not overwrite its record
                    # (a claim with stale attempts would reset the retry
                    # counter and mask the recorded error)
                    if rec.get("status") == "claim":
                        self.manifest.mark(
                            k, "claim", claim_host=self.host,
                            attempts=max(attempts[k], rec.get("attempts", 0)),
                        )

        t = threading.Thread(target=beat, daemon=True)
        t.start()

        def stopper():
            stop.set()
            t.join(timeout=5.0)

        return stopper

    def _run_batch_items(self, keys: List[str], items: List[Any]) -> None:
        """Run a claimed batch through batch_pipeline; on failure fall back
        to per-item execution so one poisoned item doesn't sink the batch.
        Claims are heartbeat-refreshed while items execute."""
        stop_heartbeat = self._heartbeat_claims(keys)
        try:
            self._run_batch_items_inner(keys, items)
        finally:
            stop_heartbeat()

    def _run_batch_items_inner(self, keys: List[str], items: List[Any]) -> None:
        if len(keys) == 1 or self.batch_pipeline is None:
            for k, it in zip(keys, items):
                self._run_item(k, it)
            return
        t0 = time.time()
        attempts = {
            k: self.manifest.items.get(k, {}).get("attempts", 0) for k in keys
        }
        try:
            prepared = [self._take_prepared(k, it) for k, it in zip(keys, items)]
            results = self.batch_pipeline(prepared)
            per = (time.time() - t0) / len(keys)
            for k, res in zip(keys, results):
                self.manifest.mark(
                    k, "done", seconds=per, attempts=attempts[k] + 1, result=res
                )
            if self.verbose:
                print(f"[cohort] done batch of {len(keys)} ({time.time() - t0:.1f}s)")
        except Exception as e:  # noqa: BLE001 — isolate batch failures
            if self.verbose:
                print(f"[cohort] batch failed ({e}); retrying items singly")
            for k, it in zip(keys, items):
                self._run_item(k, it)

    def _run_static(self, keys, items) -> None:
        todo: List[Tuple[str, Any]] = []
        for idx, (key, item) in enumerate(zip(keys, items)):
            if idx % self.n_hosts != self.host:
                continue
            if self.manifest.is_done(key):
                if self.verbose:
                    print(f"[cohort] skip (done): {key}")
                continue
            todo.append((key, item))
        # deterministic order: prefetch-decode ahead of execution
        self._set_prefetch_queue(list(todo))
        pending: List[Tuple[str, Any]] = []
        for key, item in todo:
            pending.append((key, item))
            if len(pending) >= self.batch_size:
                self._run_batch_items(*map(list, zip(*pending)))
                pending = []
        if pending:
            self._run_batch_items(*map(list, zip(*pending)))

    def _run_dynamic(self, keys, items) -> None:
        """Claim-based work queue over the shard manifests.

        Claim protocol: append a claim record, re-read all shards, and
        proceed only when our claim is the winner (earliest fresh claim,
        ties broken by host id). A dead host's claim goes stale after
        `claim_ttl` and the item is stolen. This is filesystem-visibility
        best-effort: like Dask's retry-on-worker-loss, execution is
        at-least-once, and `claim_ttl` must exceed the slowest item.
        """
        by_key = dict(zip(keys, items))
        while True:
            self.manifest.reload()
            if self.prepare is not None:
                # drop prefetches for items finished elsewhere; top up with
                # the currently-runnable candidates in execution order
                for k in list(self._prefetched):
                    if self._is_finished(self.manifest.items.get(k)):
                        self._prefetched.pop(k, None)
                self._set_prefetch_queue(
                    (k, by_key[k])
                    for k in keys
                    if not self._is_finished(self.manifest.items.get(k))
                    and not (
                        self._is_fresh_claim(self.manifest.items.get(k))
                        and self.manifest.items.get(k, {}).get("claim_host")
                        != self.host
                    )
                )
            progress = False
            waiting = False
            pending: List[str] = []

            def flush():
                nonlocal progress, pending
                if pending:
                    self._run_batch_items(pending, [by_key[k] for k in pending])
                    progress = True
                    if self.verbose:
                        print(self._progress_line(keys))
                    pending = []

            for key in keys:
                rec = self.manifest.items.get(key)
                if self._is_finished(rec):
                    continue
                if self._is_fresh_claim(rec) and rec.get("claim_host") != self.host:
                    waiting = True
                    continue
                # stake a claim, then check we won it. The settle delay
                # closes the visibility race: a claim's timestamp is taken
                # BEFORE its write lands, so two hosts staking within each
                # other's write lag could each see only themselves and both
                # win. Waiting > the filesystem's write-visibility lag before
                # resolving makes contemporaneous claims mutually visible
                # (coordination-free two-phase claim; Dask linearizes through
                # its central scheduler instead).
                self.manifest.mark(
                    key, "claim", claim_host=self.host,
                    attempts=self.manifest.items.get(key, {}).get("attempts", 0),
                )
                if self.n_hosts > 1:  # no contender can exist single-host
                    time.sleep(self.claim_settle)
                    self.manifest.reload()
                contenders: List[Tuple[float, int]] = []
                rec2 = self.manifest.items.get(key)
                if rec2 is not None and self._is_finished(rec2):
                    continue  # someone finished it in the window
                # collect every fresh claim visible across shards for key
                for shard_rec in self._all_claims(key):
                    if (time.time() - shard_rec.get("time", 0)) < self.claim_ttl:
                        contenders.append(
                            (shard_rec.get("time", 0), shard_rec.get("claim_host", -1))
                        )
                # winner = host of the EARLIEST fresh claim. Compare by host,
                # not by exact (time, host) record: our own earlier claims
                # (a previous attempt's stake, a heartbeat) must count FOR us
                # — matching the exact record livelocked retries forever (the
                # retried item's old fresh claim always outranked the new one)
                if contenders and min(contenders)[1] != self.host:
                    waiting = True
                    continue
                pending.append(key)
                if len(pending) >= self.batch_size:
                    flush()
            flush()
            self.manifest.reload()
            if all(self._is_finished(self.manifest.items.get(k)) for k in keys):
                return
            if not progress:
                if not waiting:
                    # remaining items are unclaimable (e.g. exhausted retries
                    # recorded as non-final by an older writer) — avoid spin
                    return
                time.sleep(self.poll_seconds)

    def _all_claims(self, key: str) -> List[dict]:
        """Every claim record for `key` across all shards (not just the
        newest merged record) — needed to detect simultaneous claimants."""
        claims = []
        for shard in self.manifest._shard_paths():
            try:
                with open(shard) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        rec = json.loads(line)
                        if rec.get("key") == key and rec.get("status") == "claim":
                            claims.append(rec)
            except OSError:
                continue
        return claims

    def run(self, items: Sequence[Any], keys: Optional[Sequence[str]] = None) -> dict:
        keys = list(keys) if keys is not None else [str(i) for i in items]
        t0 = time.time()
        try:
            if self.scheduling == "static":
                self._run_static(keys, items)
            else:
                self._run_dynamic(keys, items)
        finally:
            self._prefetched.clear()
            pool = getattr(self, "_prefetch_pool", None)
            if pool is not None:
                pool.shutdown(wait=False)
                self._prefetch_pool = None
        # pick up every host's records before summarizing
        self.manifest.reload()
        summary = self._write_summary(keys, time.time() - t0)
        if self.verbose:
            print(self._progress_line(keys))
        return summary
