"""Multi-stream (serving) front-end: N concurrent on-line streams batched
onto the card — the port of `mfcc_tpu/pipeline/serving.py`.

A serving box runs many independent audio sessions at once. The pool runs
the state machine of `pipeline/streaming.py` per stream and batches every
round of device work across them (`streaming._Engine.round`): a poll round
is one host-to-device copy, ONE launch of the front-end kernel's block form
for every stream with a block ready, at most two finalize launches (the
feature tail for mfcc; one a window width), and one device-to-host copy,
whatever the number of sessions. Only streams with work take rows; nothing
is launched for idle slots.

Exactness: a stream's rows are computed by their own blocks of each kernel,
so each stream's output is bitwise its own `StreamingExtractor` run on the
card, which in turn matches the offline chain for any chunking
(tests/test_torch_streaming.py, tests/test_torch_serving.py).

Usage:

    pool = MultiStreamExtractor(cfg, n_streams=16, frames_per_block=16)
    sid = pool.open()                 # per new session
    pool.push(sid, chunk)             # buffer audio (host-only, cheap)
    out = pool.poll()                 # {sid: [k, feat_dim]} new frames
    pool.end(sid)                     # the session's audio is complete
    ...poll() until pool.done(sid)    # tail frames arrive, slot frees

A push that would buffer more than max_buffer_s of unpolled audio raises
`BufferFullError` (a RuntimeError): the caller polls and pushes again.
"""

from __future__ import annotations

import numpy as np

from mfcc_tpu_torch.config import FrontendConfig
from mfcc_tpu_torch.pipeline.streaming import (
    _Engine,
    _Stream,
    check_streamable,
    stream_device,
)

__all__ = ["BufferFullError", "MultiStreamExtractor"]


class BufferFullError(RuntimeError):
    """A push would buffer more than the pool's max_buffer_s of audio ahead
    of poll() (backpressure): poll() to drain, then push again."""


class _Slot:
    __slots__ = ("stream", "index")

    def __init__(self, stream: _Stream, index: int):
        self.stream = stream
        self.index = index  # the stream's rows of the device history


class MultiStreamExtractor:
    """Fixed-size pool of independent on-line streams sharing batched
    device rounds (module docstring); per-stream semantics are exactly
    `StreamingExtractor`'s. device="cuda" (the default) runs the kernels
    and raises without a card; "cpu" runs their plain versions."""

    def __init__(
        self,
        cfg: FrontendConfig,
        n_streams: int,
        *,
        frames_per_block: int = 16,
        cmvn_moments=None,
        max_buffer_s: float | None = 600.0,
        device="cuda",
    ):
        """max_buffer_s: per-session cap on audio buffered ahead of poll()
        (a client that pushes but never polls would otherwise grow host
        memory without bound); None disables."""
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        check_streamable(cfg, cmvn_moments)
        self.cfg = cfg
        self.n_streams = int(n_streams)
        self.K = int(frames_per_block)
        if self.K < 1:
            raise ValueError("frames_per_block must be >= 1")
        self.device = stream_device(cfg, device)
        self._engine = _Engine(cfg, self.K, self.n_streams, self.device, cmvn_moments)
        self.span = self._engine.span
        self.lookahead = self._engine.c
        self._slots: dict[int, _Slot] = {}
        self._free = list(range(self.n_streams - 1, -1, -1))  # history rows not in use
        self._next_sid = 0
        self._max_buffer = (
            None if max_buffer_s is None
            else int(max_buffer_s * cfg.sample_rate)
        )
        # observability counters (read by the CLI's serve --metrics and stats)
        self.stats = {
            "sessions_opened": 0, "sessions_finished": 0,
            "poll_rounds": 0, "base_dispatches": 0, "fin_dispatches": 0,
            "frames_emitted": 0,
        }

    # -- session management --------------------------------------------------

    def open(self) -> int:
        """Start a new stream; returns its session id (never reused).
        Raises RuntimeError when n_streams sessions are already active."""
        if not self._free:
            raise RuntimeError(f"all {self.n_streams} stream slots in use")
        sid = self._next_sid
        self._next_sid += 1
        self.stats["sessions_opened"] += 1
        self._slots[sid] = _Slot(_Stream(self.cfg, self.K, self.span, self.lookahead),
                                 self._free.pop())
        return sid

    def close(self, sid: int) -> None:
        """Abandon a stream (no tail extraction) and free its slot."""
        self._free.append(self._slot(sid).index)
        del self._slots[sid]
        self.stats["sessions_finished"] += 1  # opened == finished + active

    def end_all(self) -> None:
        """end() every stream not yet ended (flush semantics for shutdown);
        poll() until all are done() to drain the tails."""
        for sid, slot in list(self._slots.items()):
            if not slot.stream.ended:
                self.end(sid)

    def done(self, sid: int) -> bool:
        """True once a stream is no longer active: its end()ed tail has been
        emitted by poll() (slot freed), or it was close()d."""
        return sid < self._next_sid and sid not in self._slots

    @property
    def n_active(self) -> int:
        return len(self._slots)

    # -- streaming -----------------------------------------------------------

    def push(self, sid: int, samples: np.ndarray) -> None:
        """Buffer a chunk for stream sid (host-only; device work in poll()).
        Raises BufferFullError when the session would exceed max_buffer_s
        of unpolled audio (backpressure: the client must poll())."""
        slot = self._slot(sid)
        if slot.stream.ended:
            raise RuntimeError(f"stream {sid} already ended")
        if self._max_buffer is not None and (
            slot.stream.avail() + np.asarray(samples).size > self._max_buffer
        ):
            raise BufferFullError(
                f"stream {sid} has more than {self._max_buffer} samples "
                "buffered ahead of poll(); call poll() to drain"
            )
        slot.stream.ingest(samples)

    def end(self, sid: int) -> None:
        """Mark stream sid complete; its pad-tail and delta end edges are
        emitted by the following poll() calls, after which the slot frees."""
        slot = self._slot(sid)
        if slot.stream.ended:
            raise RuntimeError(f"stream {sid} already ended")
        slot.stream.end()

    def poll(self) -> dict[int, np.ndarray]:
        """Run rounds until no stream can advance.

        Returns {sid: [k, feat_dim]} for every stream that emitted frames,
        plus an entry (possibly empty) for every stream that finished; a
        finished stream's slot is freed before poll returns."""
        out: dict[int, list[np.ndarray]] = {}
        finished: list[int] = []
        self.stats["poll_rounds"] += 1
        while True:
            entries = [(sid, slot.index, slot.stream) for sid, slot in self._slots.items()]
            res = self._engine.round(entries)
            self.stats["base_dispatches"] += res.base_launches
            self.stats["fin_dispatches"] += res.fin_launches
            for sid, feat in res.frames.items():
                out.setdefault(sid, []).append(feat)
            for sid in res.finished:
                self._free.append(self._slots.pop(sid).index)
                finished.append(sid)
                self.stats["sessions_finished"] += 1
            if not res.progressed:
                break
        empty = np.zeros((0, self.cfg.feat_dim), dtype=np.float32)
        result = {
            sid: np.concatenate(parts, axis=0) if parts else empty
            for sid, parts in out.items()
        }
        self.stats["frames_emitted"] += sum(r.shape[0] for r in result.values())
        for sid in finished:
            result.setdefault(sid, empty)
        return result

    # -- internals -----------------------------------------------------------

    def _slot(self, sid: int) -> _Slot:
        try:
            return self._slots[sid]
        except KeyError:
            raise KeyError(f"stream {sid} is not open") from None
