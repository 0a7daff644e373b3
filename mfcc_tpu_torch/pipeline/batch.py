"""Host-side batching: pad-to-bucket with length masks.

The port of `mfcc_tpu/pipeline/batch.py` for its flat feed. Utterances are
grouped into a few bucket lengths, so a batch has one of a few shapes;
lengths travel with the batch and every stage is mask-aware. The port's feed
is flat rows `[B, T]` with `T = required_samples(bucket)`, int16 or the
compute dtype. (The JAX package's chunk-slab and blocked layouts exist for
the TPU's VMEM and are not ported.)

`RowPool` recycles the feed's row buffers; for a CUDA target they are pinned
(page-locked) host memory, so the host-to-device copy of a batch is
asynchronous, and a buffer goes back into use only once the copy that reads
it has completed (the CUDA events recorded after the copy, `Batch.copy_events`).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Sequence

import numpy as np
import torch

from mfcc_tpu_torch.config import FrontendConfig


def required_samples(bucket_len: int, cfg: FrontendConfig) -> int:
    """Samples the time axis must hold so the last frame of a
    bucket_len-sample utterance stays in bounds: (F-1)*S + L >= bucket_len."""
    f = cfg.num_frames(bucket_len)
    return max(bucket_len, cfg.padded_length(f))


def make_buckets(
    max_len_s: float, cfg: FrontendConfig, n_buckets: int = 4
) -> tuple[int, ...]:
    """Geometric bucket boundaries in samples, aligned to whole frame hops so
    bucket edges land on frame boundaries (keeps F per bucket minimal)."""
    sr = cfg.sample_rate
    max_len = int(round(max_len_s * sr))
    S = cfg.frame_step
    lo = min(0.5 * sr, max_len)  # never emit buckets beyond max_len
    ratio = (max_len / lo) ** (1.0 / max(1, n_buckets - 1)) if max_len > lo else 1.0
    raw = [lo * ratio**i for i in range(n_buckets)]
    top = int(np.ceil(max_len / S)) * S
    buckets = sorted(
        {min(int(np.ceil(b / S)) * S, top) for b in raw} | {top}
    )
    return tuple(buckets)


def bucket_for(n_samples: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n_samples (clamps to the largest: caller truncates
    or splits over-long audio upstream)."""
    for b in buckets:
        if n_samples <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class Batch:
    """One padded batch ready for device transfer."""

    audio: np.ndarray  # [B, T] int16 or compute dtype
    lengths: np.ndarray  # [B] int32 valid sample counts
    ids: list  # opaque per-utterance keys (paths, indices)
    on_release: object = None  # producer callback: audio buffer reusable
    # CUDA events recorded after the host-to-device copies that read `audio`
    # (`parallel.sharded_extract_batch(copy_events=...)`): the buffer is
    # reused only once they have completed
    copy_events: list = dataclasses.field(default_factory=list)

    @property
    def pad_occupancy(self) -> float:
        """Fraction of the audio buffer holding real samples (1.0 = no waste)."""
        return float(self.lengths.sum()) / float(self.audio.size)

    def release(self) -> None:
        """Hand the audio buffer back to the producer for reuse (optional;
        an unreleased batch is simply garbage-collected). The producer's
        pool waits on `copy_events` before it fills the buffer again, so a
        batch may be released as soon as its copy is enqueued."""
        cb, self.on_release = self.on_release, None
        if cb is not None:
            cb(self)


_TORCH_DTYPES = {np.dtype(np.int16): torch.int16, np.dtype(np.float32): torch.float32}


class RowPool:
    """Recycled [rows, T] host row buffers of the feed.

    pin=True allocates them in pinned (page-locked) memory, for a CUDA
    target: the host-to-device copy from such a buffer is asynchronous.
    Pin only for a CUDA target (a CPU-only torch cannot pin). `give` takes a
    buffer back with the events of the copies that read it; `take` waits on
    those events before it hands the buffer out again, so a buffer is never
    overwritten under a copy. At most `capacity` free buffers are kept a
    shape (None: all); the rest are dropped. A subclass changes where the
    buffers live by overriding `_alloc` (`io.reader.SlabPool`)."""

    def __init__(self, pin: bool = False, capacity: int | None = 4):
        self.pin = pin
        self.capacity = capacity
        self._lock = threading.Lock()
        self._free: dict[tuple, list] = {}

    def take(self, rows: int, T: int, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        with self._lock:
            stack = self._free.get((rows, T, dtype))
            entry = stack.pop() if stack else None
        if entry is not None:
            buf, events = entry
            for ev in events:
                ev.synchronize()  # the copy that read this buffer has completed
            return buf
        return self._alloc(rows, T, dtype)

    def _alloc(self, rows: int, T: int, dtype: np.dtype) -> np.ndarray:
        if not self.pin:
            return np.empty((rows, T), dtype=dtype)
        # the ndarray keeps the pinned tensor (its base) alive
        return torch.empty((rows, T), dtype=_TORCH_DTYPES[dtype], pin_memory=True).numpy()

    def give(self, buf: np.ndarray, events=()) -> None:
        with self._lock:
            stack = self._free.setdefault((buf.shape[0], buf.shape[1], buf.dtype), [])
            if self.capacity is None or len(stack) < self.capacity:
                stack.append((buf, list(events)))


def pad_batch(
    utterances: Iterable[np.ndarray],
    cfg: FrontendConfig,
    bucket_len: int | None = None,
    ids: Sequence | None = None,
    pad_batch_to: int | None = None,
    copy_pool=None,
    dtype=None,
) -> Batch:
    """Stack variable-length utterances into a zero-padded [B, T] buffer.

    T = required_samples(bucket_len or max utterance length). Over-long
    utterances (> bucket_len) raise instead of being truncated silently.
    pad_batch_to: right-pad the batch axis with zero-length rows so every
    batch in a stream shares one shape. copy_pool: optional
    concurrent.futures.Executor that fills rows in parallel (NumPy releases
    the GIL for these copies). dtype: the row dtype, cfg.dtype by default;
    "int16" gives the int16 PCM feed (values are cast, not rescaled).
    """
    utts = [np.asarray(u) for u in utterances]
    if not utts:
        raise ValueError("empty batch")
    lengths = np.array([u.shape[0] for u in utts], dtype=np.int32)
    blen = bucket_len if bucket_len is not None else int(lengths.max())
    too_long = lengths > blen
    if too_long.any():
        raise ValueError(
            f"{int(too_long.sum())} utterance(s) exceed bucket {blen}; "
            "split or re-bucket upstream"
        )
    T = required_samples(blen, cfg)
    B = len(utts)
    rows = B if pad_batch_to is None else max(B, pad_batch_to)
    # np.empty + explicit tail zeroing: zeroing the whole buffer costs a
    # full memory pass the valid samples immediately overwrite
    audio = np.empty((rows, T), dtype=np.dtype(dtype or cfg.dtype))

    def fill_row(i: int, u: np.ndarray) -> None:
        n = u.shape[0]
        audio[i, :n] = u
        audio[i, n:] = 0

    if copy_pool is None:
        for i, u in enumerate(utts):
            fill_row(i, u)
    else:
        list(copy_pool.map(fill_row, range(B), utts))
    audio[B:] = 0
    out_lengths = np.zeros(rows, dtype=np.int32)
    out_lengths[:B] = lengths
    if ids is not None and len(ids) != B:
        raise ValueError(
            f"{len(ids)} ids for {B} utterances — misaligned ids would key "
            "shard rows to the wrong files"
        )
    out_ids = list(ids) if ids is not None else list(range(B))
    out_ids += [None] * (rows - B)
    return Batch(audio=audio, lengths=out_lengths, ids=out_ids)
