"""Threaded and multi-process wav decode + bucketed batch streaming: the
port of `mfcc_tpu/io/reader.py`.

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
completed. `stream_batches_mp` gives the same batches in the same order,
decoded by `io/feed_worker.py` subprocesses into shared-memory slabs
(`SlabPool`: for a CUDA target each slab is page-locked once, so its rows
copy asynchronously, and it goes back to a worker only once that copy has
completed).

Failure detection: corrupt/undecodable files are logged, counted and
skipped — one bad file never kills a corpus run (SURVEY.md §5 failure row).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import logging
import os
import pathlib
import queue
import subprocess
import sys
import tempfile
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

# Decode jobs per worker request in the multi-process feed: it finishes
# batches asynchronously, so a chunk's tail latency hides behind the next
# batch's accumulation and the binding cost is the IPC round trip (the
# reference's sweep: 32 jobs a request, FEED_r05.json).
_DECODE_CHUNK_MP = 32


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


# ---------------------------------------------------------------------------
# Multi-process feed: worker subprocesses decoding into shared-memory slabs
# ---------------------------------------------------------------------------


def _shm_dir() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


def _cuda_host_register(arr: np.ndarray) -> None:
    """Page-lock arr's pages for the card (`cudaHostRegister`), so a copy
    from them is asynchronous; raises on an error."""
    import torch

    rc = torch.cuda.cudart().cudaHostRegister(arr.ctypes.data, arr.nbytes, 0)
    if int(rc) != 0:
        raise RuntimeError(f"cudaHostRegister of a {arr.nbytes}-byte feed slab failed: {rc}")


def _cuda_host_unregister(arr: np.ndarray) -> None:
    import torch

    torch.cuda.cudart().cudaHostUnregister(arr.ctypes.data)


class SlabPool(RowPool):
    """The shared-memory slab files of a multi-process feed: [rows, T] row
    buffers (`np.memmap`s, each named by its `filename`) that the workers
    decode into and the batches hand out. A `RowPool` whose buffers are
    files: `give` takes a slab back with the events of the copies that
    read it, and `take` waits on them before it hands the slab out to be
    decoded into again; every slab made is kept.

    Every file is named with the pool's own prefix (`prefix`: the process id
    and a number of the pool), so a caller that counts or removes files
    sees only its own. pin=True (for a CUDA target) page-locks each slab
    once, when it is made, so the host-to-device copy of its rows is
    asynchronous. `close` unlinks every file, after the card has finished
    every copy when the slabs are pinned."""

    _numbers = itertools.count()

    def __init__(self, pin: bool = False, directory: str | None = None):
        super().__init__(pin, capacity=None)
        self.directory = directory or _shm_dir()
        self.prefix = f"mfcc_tpu_torch_slab_{os.getpid()}_{next(SlabPool._numbers)}_"
        self._made: list[np.memmap] = []  # every slab made

    @property
    def names(self) -> list[str]:
        with self._lock:
            return [arr.filename for arr in self._made]

    def _alloc(self, rows: int, T: int, dtype: np.dtype) -> np.memmap:
        fd, name = tempfile.mkstemp(prefix=self.prefix, dir=self.directory)
        try:
            os.ftruncate(fd, rows * T * dtype.itemsize)
        finally:
            os.close(fd)
        arr = np.memmap(name, dtype=dtype, mode="r+", shape=(rows, T))
        with self._lock:
            self._made.append(arr)
        if self.pin:
            _cuda_host_register(arr)
        return arr

    def close(self) -> None:
        with self._lock:
            made, self._made, self._free = self._made, [], {}
        if self.pin and made:
            import torch

            torch.cuda.synchronize()  # no copy still reads a slab
            for arr in made:
                _cuda_host_unregister(arr)
        for arr in made:
            try:
                os.unlink(arr.filename)
            except OSError:
                pass


class _MpJob:
    """One dispatched worker request: completion event + response fields."""

    __slots__ = ("event", "fails", "error", "rows", "heads")

    def __init__(self):
        self.event = threading.Event()
        self.fails: list = []
        self.error: str | None = None
        self.rows: list = []  # the rows this chunk covers (for death cleanup)
        self.heads: list | None = None  # parse_headers responses


class _MpPool:
    """Pool of `io/feed_worker.py` subprocesses speaking JSON lines over
    pipes.

    Plain subprocess.Popen, not multiprocessing: no `__main__` re-import in
    the children, no fork of a parent holding CUDA or BLAS threads, and a
    dead worker is an EOF on its stdout. One reader thread a worker resolves
    its replies."""

    def __init__(self, num_workers: int):
        repo_root = str(pathlib.Path(__file__).resolve().parents[2])
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        self._env = env
        self._lock = threading.Lock()
        self._pending: dict[int, _MpJob] = {}
        self._by_worker: dict[int, set] = {}
        self._next_id = 0
        self._rr = 0
        self._procs: list = [None] * num_workers
        for w in range(num_workers):
            self._spawn(w)

    def _spawn(self, w: int) -> None:
        p = subprocess.Popen(
            [sys.executable, "-m", "mfcc_tpu_torch.io.feed_worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=self._env, bufsize=1,
        )
        self._procs[w] = p
        # each process generation has its own set of owed jobs: a respawned
        # slot's jobs must not be failed by the dead one's reader thread
        owned: set = set()
        self._by_worker[w] = owned
        threading.Thread(target=self._reader, args=(owned, p), daemon=True).start()

    def _reader(self, owned: set, proc) -> None:
        for line in proc.stdout:
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            jid = msg.get("id")
            with self._lock:
                job = self._pending.pop(jid, None)
                owned.discard(jid)
            if job is not None:
                job.fails = msg.get("fails", [])
                job.heads = msg.get("heads")
                job.error = msg.get("error")
                job.event.set()
        # EOF: the worker died; fail everything this generation still owed
        with self._lock:
            owed = [self._pending.pop(j, None) for j in owned]
            owned.clear()
        for job in owed:
            if job is not None:
                job.error = "feed worker died"
                job.event.set()

    def _send(self, w: int, proc, cmd: dict) -> _MpJob:
        """Register a job on worker w and write cmd (with its id) to it."""
        job = _MpJob()
        with self._lock:
            jid = self._next_id
            self._next_id += 1
            self._pending[jid] = job
            self._by_worker[w].add(jid)
        try:
            proc.stdin.write(json.dumps(dict(cmd, id=jid)) + "\n")
            proc.stdin.flush()
        except (OSError, ValueError):
            with self._lock:
                self._pending.pop(jid, None)
                self._by_worker[w].discard(jid)
            job.error = "feed worker died"
            job.event.set()
        return job

    def broadcast(self, cmd: dict) -> list[_MpJob]:
        """Send cmd to every worker (drop_slabs at the end of a stream)."""
        return [self._send(w, proc, cmd) for w, proc in enumerate(self._procs)]

    def submit(self, cmd: dict) -> _MpJob:
        with self._lock:
            w = self._rr
            self._rr = (self._rr + 1) % len(self._procs)
            # a dead worker (OOM kill, crash) is respawned in place, or every
            # len(procs)-th chunk would fail from then on (its owed jobs were
            # already failed by its reader thread)
            if self._procs[w].poll() is not None:
                log.warning("feed worker %d died; respawning", w)
                self._spawn(w)
            proc = self._procs[w]
        return self._send(w, proc, cmd)

    def close(self) -> None:
        for p in self._procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in self._procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def alive(self) -> bool:
        return any(p.poll() is None for p in self._procs)

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)


class MpPoolCache:
    """Worker pools kept warm across streams: spawning workers and importing
    numpy in them costs ~1-2 s, which would otherwise be paid a stream.

    `acquire(n)` returns (pool, private). The cached pool is shared while
    its worker count matches and it is alive; a concurrent stream asking for
    another count gets a private pool instead of the cached one being
    closed under the first stream's jobs. `release` hands a pool back (a
    private one is closed). The pool cached at interpreter exit is closed
    then. `POOL_CACHE` is the process's default; a caller (a test) can make
    its own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pool: _MpPool | None = None
        self._size = 0
        self._users = 0
        self._at_exit = False

    def acquire(self, num_workers: int) -> tuple[_MpPool, bool]:
        with self._lock:
            if self._pool is not None and self._size == num_workers and self._pool.alive():
                self._users += 1
                return self._pool, False
            if self._pool is not None and self._users > 0:
                return _MpPool(num_workers), True  # busy with another size: keep it
            if self._pool is not None:
                self._pool.close()
            self._pool, self._size, self._users = _MpPool(num_workers), num_workers, 1
            if not self._at_exit:
                import atexit

                atexit.register(self.close)
                self._at_exit = True
            return self._pool, False

    def release(self, pool: _MpPool, private: bool) -> None:
        if private:
            pool.close()
            return
        with self._lock:
            if pool is self._pool:
                self._users = max(0, self._users - 1)

    def close(self) -> None:
        with self._lock:
            pool, self._pool, self._users = self._pool, None, 0
        if pool is not None:
            pool.close()


POOL_CACHE = MpPoolCache()


def _mp_header_stream(files, pool, expect_sr: int, stats: "DecodeStats",
                      chunk: int = 64, depth: int = 4):
    """Yield (path, n_samples) in file order with the phase-A header parses
    run by the worker pool (`chunk` paths a request, `depth` requests in
    flight). Skip / log / stats semantics are `_parse_header_counted`'s; a
    dead worker degrades its chunk to the serial parse instead of dropping
    files.

    Collecting a chunk blocks until `chunk` paths are there, so a lazy
    producer (a generator that finds files over time) would stall the feed:
    such callers keep the serial parse; sequences (the CLI's globbed lists)
    take the pooled one."""
    if not isinstance(files, (list, tuple)):
        for path in files:
            n = _parse_header_counted(path, expect_sr, stats)
            if n is not None:
                yield path, n
        return

    it = iter(files)
    inflight: collections.deque = collections.deque()

    def submit_next() -> bool:
        paths = list(itertools.islice(it, chunk))
        if not paths:
            return False
        job = pool.submit({"op": "parse_headers", "paths": [str(p) for p in paths]})
        inflight.append((paths, job))
        return True

    for _ in range(depth):
        if not submit_next():
            break
    while inflight:
        paths, job = inflight.popleft()
        job.event.wait()
        heads = job.heads if job.error is None else None
        for i, path in enumerate(paths):
            if heads is None:  # worker died: the serial parse for this chunk
                n = _parse_header_counted(path, expect_sr, stats)
                if n is not None:
                    yield path, n
                continue
            h = heads[i]
            if len(h) > 2:
                log.warning("skipping %s: %s", path, h[2])
                stats.errors += 1
                continue
            fsr, n = h
            if fsr != expect_sr:
                log.warning("skipping %s: sample rate %d != expected %d", path, fsr, expect_sr)
                stats.wrong_rate += 1
                continue
            yield path, n
        submit_next()


def stream_batches_mp(
    files: Iterable,
    cfg: FrontendConfig,
    batch_size: int = 64,
    max_len_s: float = 10.0,
    n_buckets: int = 4,
    num_threads: int = 4,
    downmix: str = "first",
    pad_batch_rows: bool = True,
    stats: DecodeStats | None = None,
    long_mode: str = "defer",
    dtype: str = "i16",
    skip_ids: frozenset | set | None = None,
    slabs: SlabPool | None = None,
    pool_cache: MpPoolCache | None = None,
) -> Iterator[Batch]:
    """Multi-process decode-into-buffer batch streaming.

    The same phases, semantics and batches, in the same order, as
    `stream_batches_direct`, but the decode chunks (and, for a list of
    files, the header parses) run in `io/feed_worker.py` subprocesses that
    write straight into the rows of shared-memory slabs: the per-file
    Python work runs under the workers' own interpreter locks, so the
    consumer's goes to batch bookkeeping. num_threads sets the number of
    worker processes (from `pool_cache`, `POOL_CACHE` by default).

    slabs: the `SlabPool` the rows come from (pinned for a CUDA target:
    `SlabPool(pin=True)`); a batch's slab goes back to it on
    `Batch.release()` with the batch's copy events, and is decoded into
    again only once they completed. Its files are unlinked when the stream
    ends. A fresh unpinned pool by default.

    The consumer loop mirrors `stream_batches_direct`'s on purpose (the
    two are held byte-identical by tests/test_torch_mpfeed.py), but it
    finishes batches asynchronously: a full batch's decodes run on while
    the next batch's headers are read and its chunks dispatched, and the
    batches are yielded in order as their decodes land.
    """
    stats = stats if stats is not None else DecodeStats()
    sr = cfg.input_sample_rate or cfg.sample_rate
    buckets = make_buckets(max_len_s, cfg, n_buckets)
    if sr != cfg.sample_rate:
        scale = sr / cfg.sample_rate
        buckets = tuple(int(round(b * scale)) for b in buckets)
    if dtype not in ("f32", "i16"):
        raise ValueError(f"dtype={dtype!r} must be 'f32' or 'i16'")
    row_dtype = np.int16 if dtype == "i16" else np.float32
    slabs = slabs if slabs is not None else SlabPool()
    cache = pool_cache if pool_cache is not None else POOL_CACHE
    pool, private = cache.acquire(max(1, num_threads))

    class _Open:
        """One partially filled batch of a bucket, in its slab."""

        def __init__(self, blen: int):
            self.blen = blen
            self.T = required_samples(blen, cfg)
            self.audio = slabs.take(batch_size, self.T, row_dtype)
            self.lengths = np.zeros(batch_size, dtype=np.int32)
            self.ids: list = []
            self.mp_jobs: list[_MpJob] = []
            self.jobs: list = []  # (row, path) awaiting chunk submission

    pending: dict[int, _Open] = {}

    def submit(ob: _Open) -> None:
        if not ob.jobs:
            return
        job = pool.submit({
            "op": "decode_chunk", "slab": ob.audio.filename, "shape": [batch_size, ob.T], "dtype": dtype,
            "blen": ob.blen, "downmix": downmix, "sr": sr,
            # each row's header length: the worker fails a row whose decode
            # disagrees (the file changed since its header was read)
            "jobs": [[row, str(p), int(ob.lengths[row])] for row, p in ob.jobs],
        })
        job.rows = [row for row, _ in ob.jobs]
        ob.mp_jobs.append(job)
        ob.jobs = []

    # full batches whose decodes are still landing, yielded in FIFO order;
    # at most _MAX_FINISHING of them hold slabs before the oldest is waited for
    finishing: collections.deque = collections.deque()
    _MAX_FINISHING = 3

    def begin_finish(blen: int) -> None:
        ob = pending.pop(blen, None)
        if ob is None or not ob.ids:
            return
        submit(ob)
        stats.queue_depth = pool.depth()
        finishing.append(ob)

    def ready(ob: _Open) -> bool:
        return all(j.event.is_set() for j in ob.mp_jobs)

    def materialize(ob: _Open, pad_rows: bool) -> Batch:
        for job in ob.mp_jobs:
            job.event.wait()
            if job.error is not None:
                # the worker died mid-chunk: those rows' contents are unknown
                log.error("feed worker failure: %s", job.error)
                job.fails = [[row, job.error] for row in job.rows]
            for row, msg in job.fails:
                log.warning("decode failed for %s: %s", ob.ids[row], msg)
                secs = ob.lengths[row] / sr  # undo the header credit
                ob.audio[row] = 0
                ob.lengths[row] = 0
                ob.ids[row] = None
                stats.errors += 1
                stats.decoded -= 1
                stats.audio_seconds -= secs
        rows = len(ob.ids)
        if pad_rows:
            ob.audio[rows:] = 0
            out_rows = batch_size
        else:
            out_rows = rows
        buf = ob.audio
        return Batch(
            audio=np.asarray(buf[:out_rows]),
            lengths=ob.lengths[:out_rows],
            ids=ob.ids + [None] * (out_rows - rows),
            # the slab goes back with the events of the copies that read it
            on_release=lambda b: slabs.give(buf, b.copy_events),
        )

    try:
        for path, n in _mp_header_stream(files, pool, sr, stats):
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
            # else: the row is never read (the caller resume-skips the whole
            # batch); the batch's composition and lengths stay the same
            if len(ob.jobs) >= _DECODE_CHUNK_MP:
                submit(ob)
            if len(ob.ids) >= batch_size:
                begin_finish(blen)
            while finishing and (ready(finishing[0]) or len(finishing) >= _MAX_FINISHING):
                yield materialize(finishing.popleft(), False)
        while finishing:
            yield materialize(finishing.popleft(), False)
        for blen in buckets:
            begin_finish(blen)
        while finishing:
            yield materialize(finishing.popleft(), pad_batch_rows)
    finally:
        # the worker pool stays warm for the next stream; the slab files are
        # this stream's: the workers drop their mappings (or the unlinked
        # pages stay resident in them), then the files go
        for job in pool.broadcast({"op": "drop_slabs", "names": slabs.names}):
            job.event.wait(timeout=5)
        slabs.close()
        cache.release(pool, private)
