"""Threaded wav decode pool + bucketed batch streaming: the port of
`mfcc_tpu/io/reader.py` up to its multi-process feed.

The host feed path: N decode threads pull paths from a work queue, decode
via the C++ fast path, and push into a bounded results queue (no shared
mutable state). The batcher groups utterances into length buckets and emits
fixed-shape padded batches, one of a few shapes a bucket.

Rows stay flat `[B, T]` (the JAX package's blocked and slab feed layouts are
TPU layouts and are not ported), so the same files give the same batches as
the JAX package's feeds with `layouts="resample"` on a config that does not
resample. `stream_batches_direct` decodes into rows of a `RowPool`: pinned
host memory for a CUDA target, so the batch's host-to-device copy is
asynchronous; a released buffer is refilled only once that copy has
completed. The multi-process feed (`stream_batches_mp`) is not ported yet.

Failure detection: corrupt/undecodable files are logged, counted and
skipped — one bad file never kills a corpus run (SURVEY.md §5 failure row).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
from typing import Iterable, Iterator, Sequence

import numpy as np

from mfcc_tpu_torch.config import FrontendConfig
from mfcc_tpu_torch.io import wav
from mfcc_tpu_torch.pipeline import Batch, RowPool, bucket_for, make_buckets, pad_batch
from mfcc_tpu_torch.pipeline.batch import required_samples

log = logging.getLogger(__name__)

_SENTINEL = object()

# Phase-A header read size: covers fmt+data chunk headers of essentially
# all real wavs (typically < 100 bytes in); exotic layouts fall back to a
# full read.
_HEADER_PREFIX = 8192

# Decode jobs per pool submission in the direct (threaded) path:
# amortizes the per-future Python overhead over 8 files; larger chunks
# hurt its SYNCHRONOUS flush's tail latency (r4 sweep).
_DECODE_CHUNK = 8

def _parse_header_counted(path, expect_sr: int, stats: "DecodeStats"):
    """Phase A of the decode-into-buffer path: (valid sample count) from a
    prefix read + stat; None on skip, with stats counted. ~tens of µs per
    file, so callers run it serially in the consumer."""
    try:
        with open(path, "rb") as f:
            prefix = f.read(_HEADER_PREFIX)
            if len(prefix) == _HEADER_PREFIX:
                size = os.fstat(f.fileno()).st_size
                try:
                    fsr, n = wav.parse_wav_header(prefix, file_size=size)
                except ValueError:
                    # fmt/data chunk beyond the prefix: full read
                    fsr, n = wav.parse_wav_header(prefix + f.read())
            else:
                fsr, n = wav.parse_wav_header(prefix)
    except (OSError, ValueError) as e:
        log.warning("skipping %s: %s", path, e)
        stats.errors += 1
        return None
    if fsr != expect_sr:
        log.warning(
            "skipping %s: sample rate %d != expected %d", path, fsr, expect_sr
        )
        stats.wrong_rate += 1
        return None
    return n


@dataclasses.dataclass
class DecodeStats:
    decoded: int = 0
    errors: int = 0
    wrong_rate: int = 0
    truncated: int = 0
    audio_seconds: float = 0.0
    # over-long utterances deferred to the split/stitch path (long_mode
    # "defer"): recorded here for the caller to process via
    # pipeline.extract_long after the bucketed stream drains
    long_deferred: int = 0
    long_paths: list = dataclasses.field(default_factory=list)
    # gauge: decode jobs in flight when the last batch was flushed
    # (observability — SURVEY.md §5 metrics row)
    queue_depth: int = 0


def shard_files(files: Sequence, process_index: int, process_count: int) -> list:
    """Per-process file-list sharding: process i takes files[i::n].
    Deterministic, no coordination needed (the CLI takes i and n from
    `parallel.mesh.process_index` / `process_count`)."""
    return list(files)[process_index::process_count]


def _ordered_map(paths, item_fn, num_threads: int, queue_depth: int):
    """Run item_fn(idx, path) -> result-or-None over a thread pool, yielding
    (path, result) in INPUT ORDER (reorder buffer), skipping None results.

    Ordering makes shard contents — and therefore resume markers —
    deterministic across runs. In-flight work is capped at
    queue_depth + num_threads items even when one early item is slow: the
    feeder holds a window semaphore the consumer releases as indices are
    yielded, so workers can never run arbitrarily far ahead of a slow item
    and pile decoded audio into the reorder buffer. Worker death is
    survivable: the finally-sentinel plus the pre-raise gap report keep the
    consumer from waiting forever, and the drain path releases everything
    if all workers die (tests/test_structure.py fault injection).
    """
    work: "queue.Queue" = queue.Queue(maxsize=queue_depth)
    out: "queue.Queue" = queue.Queue(maxsize=queue_depth)
    window = threading.Semaphore(queue_depth + num_threads)
    paths = list(paths)

    def _feed():
        for i, p in enumerate(paths):
            window.acquire()
            work.put((i, p))
        for _ in range(num_threads):
            work.put(_SENTINEL)

    def _worker():
        try:
            while True:
                item = work.get()
                if item is _SENTINEL:
                    return
                idx, path = item
                try:
                    res = item_fn(idx, path)
                except BaseException:
                    out.put((idx, None))
                    raise
                out.put((idx, res))
        finally:
            out.put(_SENTINEL)

    threading.Thread(target=_feed, daemon=True).start()
    threads = [
        threading.Thread(target=_worker, daemon=True) for _ in range(num_threads)
    ]
    for t in threads:
        t.start()

    done = 0
    next_idx = 0
    held: dict[int, object] = {}
    while next_idx < len(paths):
        if next_idx in held:
            res = held.pop(next_idx)
            path = paths[next_idx]
            next_idx += 1
            window.release()
            if res is not None:
                yield path, res
            continue
        if done >= num_threads:
            # every worker exited: drain stragglers, release the rest in
            # order treating still-missing indices as skipped
            while True:
                try:
                    item = out.get_nowait()
                except queue.Empty:
                    break
                if item is not _SENTINEL:
                    held[item[0]] = item[1]
            while next_idx < len(paths):
                res = held.pop(next_idx, None)
                path = paths[next_idx]
                next_idx += 1
                window.release()  # unblock the feeder so it can drain too
                if res is not None:
                    yield path, res
            break
        item = out.get()
        if item is _SENTINEL:
            done += 1
            continue
        held[item[0]] = item[1]
    # unblock workers still parked in their finally-sentinel put: out is
    # bounded at queue_depth, so with num_threads > queue_depth not every
    # sentinel fits once the consumer stops draining — without this the
    # joins below deadlock (all real items were yielded, so anything left
    # is sentinels)
    while done < num_threads:
        if out.get() is _SENTINEL:
            done += 1
    for t in threads:
        t.join()


def decode_stream(
    files: Iterable,
    cfg: FrontendConfig,
    num_threads: int = 4,
    queue_depth: int = 64,
    downmix: str = "first",
    native: bool | None = None,
    stats: DecodeStats | None = None,
) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (path, float32 samples) decoded by a thread pool in input order
    (see _ordered_map)."""
    stats = stats if stats is not None else DecodeStats()
    expect_sr = cfg.input_sample_rate or cfg.sample_rate
    lock = threading.Lock()

    def item_fn(idx, path):
        try:
            sr, samples = wav.read_wav(path, downmix=downmix, native=native)
        except (OSError, ValueError) as e:
            log.warning("skipping %s: %s", path, e)
            with lock:
                stats.errors += 1
            return None
        except BaseException:
            with lock:
                stats.errors += 1
            raise
        if sr != expect_sr:
            log.warning(
                "skipping %s: sample rate %d != expected %d", path, sr, expect_sr
            )
            with lock:
                stats.wrong_rate += 1
            return None
        with lock:
            stats.decoded += 1
            stats.audio_seconds += samples.shape[0] / sr
        return samples

    yield from _ordered_map(files, item_fn, num_threads, queue_depth)


def stream_batches(
    files: Iterable,
    cfg: FrontendConfig,
    batch_size: int = 64,
    max_len_s: float = 10.0,
    n_buckets: int = 4,
    num_threads: int = 4,
    downmix: str = "first",
    native: bool | None = None,
    pad_batch_rows: bool = True,
    stats: DecodeStats | None = None,
    long_mode: str = "defer",
) -> Iterator[Batch]:
    """files → padded, bucketed Batch stream of flat rows in cfg.dtype.

    Utterances longer than the largest bucket are deferred to the
    split/stitch path (long_mode "defer", the default: path recorded in
    stats.long_paths for the caller to run pipeline.extract_long on) or
    truncated to the top bucket (long_mode "truncate", counted in
    stats.truncated). Partial per-bucket batches are flushed at end of
    input, zero-padded to batch_size rows when pad_batch_rows so every
    batch of a bucket shares one compiled shape.
    """
    import concurrent.futures

    stats = stats if stats is not None else DecodeStats()
    sr = cfg.input_sample_rate or cfg.sample_rate
    buckets = make_buckets(max_len_s, cfg, n_buckets)
    # at a non-native input rate the bucket grid scales with the rate
    if sr != cfg.sample_rate:
        scale = sr / cfg.sample_rate
        buckets = tuple(int(round(b * scale)) for b in buckets)
    pending: dict[int, list[tuple[str, np.ndarray]]] = {b: [] for b in buckets}
    copy_pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=max(2, num_threads)
    )

    def flush(blen: int, pad_rows: bool) -> Batch | None:
        items = pending[blen]
        if not items:
            return None
        pending[blen] = []
        return pad_batch(
            [s for _, s in items],
            cfg,
            bucket_len=blen,
            ids=[p for p, _ in items],
            pad_batch_to=batch_size if pad_rows else None,
            copy_pool=copy_pool,
        )

    try:
        for path, samples in decode_stream(
            files, cfg, num_threads=num_threads, downmix=downmix, native=native,
            stats=stats,
        ):
            if samples.shape[0] > buckets[-1]:
                if long_mode == "defer":
                    stats.long_deferred += 1
                    stats.long_paths.append(path)
                    continue
                stats.truncated += 1
                samples = samples[: buckets[-1]]
            if samples.shape[0] == 0:
                log.warning("skipping %s: empty audio", path)
                stats.errors += 1
                continue
            blen = bucket_for(samples.shape[0], buckets)
            pending[blen].append((path, samples))
            if len(pending[blen]) >= batch_size:
                b = flush(blen, False)
                if b is not None:
                    yield b
        for blen in buckets:
            b = flush(blen, pad_batch_rows)
            if b is not None:
                yield b
    finally:
        copy_pool.shutdown(wait=False)


def stream_batches_direct(
    files: Iterable,
    cfg: FrontendConfig,
    batch_size: int = 64,
    max_len_s: float = 10.0,
    n_buckets: int = 4,
    num_threads: int = 4,
    downmix: str = "first",
    native: bool | None = None,
    pad_batch_rows: bool = True,
    stats: DecodeStats | None = None,
    long_mode: str = "defer",
    dtype: str = "f32",
    skip_ids: frozenset | set | None = None,
    pool: RowPool | None = None,
) -> Iterator[Batch]:
    """Decode-into-buffer batch streaming (the host-feed fast path).

    Two phases, fully deterministic:
      A. INLINE in the consumer: read a few-KB header PREFIX + stat —
         gives the sample rate and length for bucket/row assignment
         without pulling the whole file through memory twice (full-read
         fallback for exotic chunk layouts). ~tens of µs per file, so a
         serial loop sustains hundreds of thousands of audio-s/s and
         needs no ordering machinery at all.
      B. decode each utterance DIRECTLY into its padded batch row via one
         C++ open+read+decode call (truncation + zero-fill inside C, GIL
         released) — no Python bytes object, no intermediate sample
         array, no serial assembly copy. Decode jobs are submitted to the
         thread pool in CHUNKS of rows, so per-file Python overhead
         (future + queue hop) is amortized ~8×.

    dtype "f32" or "i16": int16 rows halve decode-output, memcpy and H2D
    bytes (PCM16 sources pass through bit-exactly; other widths quantize
    at ±0.5 LSB of the int16 scale); the chain casts on device.

    pool: the `RowPool` the batch buffers come from and go back to on
    `Batch.release()` (pinned for a CUDA target: `RowPool(pin=True)`); a
    pool of unpinned buffers by default.

    Semantics match stream_batches (same batches, same order); a rare
    decode failure after a successful header parse zeroes the row and
    drops its id (consumers pair ids with rows, skipping None).
    """
    import concurrent.futures

    stats = stats if stats is not None else DecodeStats()
    expect_sr = cfg.input_sample_rate or cfg.sample_rate
    sr = expect_sr
    buckets = make_buckets(max_len_s, cfg, n_buckets)
    if sr != cfg.sample_rate:
        scale = sr / cfg.sample_rate
        buckets = tuple(int(round(b * scale)) for b in buckets)
    lock = threading.Lock()
    if dtype not in ("f32", "i16"):
        raise ValueError(f"dtype={dtype!r} must be 'f32' or 'i16'")
    row_dtype = np.float32 if dtype == "f32" else np.int16

    def parse_header(path):
        return _parse_header_counted(path, expect_sr, stats)

    rows_pool = pool if pool is not None else RowPool()

    class _Open:
        """One partially-filled batch of a bucket."""

        def __init__(self, blen: int):
            self.blen = blen
            self.T = required_samples(blen, cfg)
            self.audio = rows_pool.take(batch_size, self.T, row_dtype)
            self.lengths = np.zeros(batch_size, dtype=np.int32)
            self.ids: list = []
            self.futures: list = []
            self.jobs: list = []  # (row, path) awaiting chunk submission

    workers = concurrent.futures.ThreadPoolExecutor(max_workers=max(2, num_threads))
    pending: dict[int, _Open] = {}

    def decode_chunk(ob: _Open, jobs: list) -> None:
        for row, path in jobs:
            try:
                fsr, n_valid = wav.decode_file_into(
                    path, ob.audio[row, : ob.blen],
                    downmix=downmix, native=native,
                )
                if fsr != sr or n_valid != ob.lengths[row]:
                    # the file changed between the phase-A header parse
                    # and this decode (re-encode, truncated copy): the
                    # recorded length/rate no longer describe the bytes —
                    # corrupt features must not reach shards silently
                    raise ValueError(
                        f"file changed since header parse: decoded "
                        f"{n_valid} samples at {fsr} Hz, header said "
                        f"{ob.lengths[row]} at {sr}"
                    )
            except (OSError, ValueError, RuntimeError, wav.WavError) as e:
                log.warning("decode failed for %s: %s", path, e)
                secs = ob.lengths[row] / sr  # undo the header credit
                ob.audio[row, : ob.blen] = 0
                ob.lengths[row] = 0
                ob.ids[row] = None
                with lock:
                    stats.errors += 1
                    stats.decoded -= 1
                    stats.audio_seconds -= secs
            ob.audio[row, ob.blen :] = 0  # tail beyond the bucket span

    def submit(ob: _Open) -> None:
        if ob.jobs:
            ob.futures.append(workers.submit(decode_chunk, ob, ob.jobs))
            ob.jobs = []

    def flush(blen: int, pad_rows: bool) -> Batch | None:
        ob = pending.pop(blen, None)
        if ob is None or not ob.ids:
            return None
        submit(ob)
        stats.queue_depth = sum(
            1 for o in pending.values() for f in o.futures if not f.done()
        ) + sum(1 for f in ob.futures if not f.done())
        for f in ob.futures:
            f.result()  # decode_chunk catches decode errors; raise the rest
        rows = len(ob.ids)
        if pad_rows:
            ob.audio[rows:] = 0
            out_rows = batch_size
        else:
            out_rows = rows
        ids = ob.ids + [None] * (out_rows - rows)
        buf = ob.audio
        return Batch(
            audio=buf[:out_rows],
            lengths=ob.lengths[:out_rows],
            ids=ids,
            # the buffer goes back to the pool with the events of the copies
            # that read it; the pool refills it only once they completed
            on_release=lambda b: rows_pool.give(buf, b.copy_events),
        )

    try:
        for path in files:
            n = parse_header(path)
            if n is None:
                continue
            if n == 0:
                log.warning("skipping %s: empty audio", path)
                stats.errors += 1
                continue
            if n > buckets[-1]:
                if long_mode == "defer":
                    stats.long_deferred += 1
                    stats.long_paths.append(path)
                    continue
                stats.truncated += 1
                n = buckets[-1]
            with lock:
                stats.decoded += 1
                stats.audio_seconds += n / sr
            blen = bucket_for(n, buckets)
            ob = pending.get(blen)
            if ob is None:
                ob = pending[blen] = _Open(blen)
            row = len(ob.ids)
            ob.ids.append(path)
            ob.lengths[row] = n
            if skip_ids is None or path not in skip_ids:
                ob.jobs.append((row, path))
            # else: row content is never read (the caller resume-skips the
            # whole batch) — composition/lengths stay identical either way
            if len(ob.jobs) >= _DECODE_CHUNK:
                submit(ob)
            if len(ob.ids) >= batch_size:
                b = flush(blen, False)
                if b is not None:
                    yield b
        for blen in buckets:
            b = flush(blen, pad_batch_rows)
            if b is not None:
                yield b
    finally:
        workers.shutdown(wait=False)
