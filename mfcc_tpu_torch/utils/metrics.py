"""Structured counters + JSON-lines metrics: the port of
`mfcc_tpu/utils/metrics.py`, as it is.

Plain stdlib: a MetricsLogger accumulates counters and periodically (or on
demand) appends one JSON object per line to a per-process file; stdout
logging stays human-readable via `logging`.

Counter inventory (set by the CLI; emit() also stamps
elapsed_s/audio_s_per_s/ts): audio_seconds, utterances, frames,
shards[_skipped], pad_occupancy, devices, dispatch_ms (host-side H2D +
launch wall per batch), extract_s (wall time in `sharded_extract_batch`,
dispatch and device work), decode_queue_depth, decode_errors, wrong_rate,
truncated, long_split.
"""

from __future__ import annotations

import json
import pathlib
import time
from collections import defaultdict


class Timer:
    """Context-manager wall timer: `with Timer() as t: ...; t.seconds`."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


class MetricsLogger:
    def __init__(self, path=None, context: dict | None = None):
        self.path = pathlib.Path(path) if path else None
        self.context = context or {}
        self.counters: dict[str, float] = defaultdict(float)
        self._t0 = time.time()
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def add(self, **kv) -> None:
        for k, v in kv.items():
            self.counters[k] += v

    def set(self, **kv) -> None:
        for k, v in kv.items():
            self.counters[k] = v

    def snapshot(self) -> dict:
        out = dict(self.context)
        out.update(self.counters)
        elapsed = time.time() - self._t0
        out["elapsed_s"] = elapsed
        if "audio_seconds" in self.counters and elapsed > 0:
            out["audio_s_per_s"] = self.counters["audio_seconds"] / elapsed
        if "utterances" in self.counters and elapsed > 0:
            out["utterances_per_s"] = self.counters["utterances"] / elapsed
        return out

    def emit(self, event: str = "progress") -> dict:
        snap = self.snapshot()
        snap["event"] = event
        snap["ts"] = time.time()
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(snap) + "\n")
        return snap
