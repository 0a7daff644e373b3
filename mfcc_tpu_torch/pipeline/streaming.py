"""Streaming (on-line, causal) feature extraction: the port of
`mfcc_tpu/pipeline/streaming.py`.

Audio arrives in chunks of any size and features leave incrementally, with
offline parity: for any chunking of an utterance,

    concat(push(c) for c in chunks) + flush()
        == chain.extract_batch(whole)[0, :F]

within the family's gate (the same fp32 stages on the card's kernels), with
the pad-tail frames and the delta edge replication at the true start and
end of the stream (tests/test_torch_streaming.py).

Design. A stream's state is a host state machine (`_Stream`, the
reference's): a sample FIFO from the pre-context sample of the next block,
the next block's first frame t0, the frames emitted. Its device work comes
in rounds (`_Engine.round`), each taking every stream of a pool (one for
`StreamingExtractor`, N for `pipeline/serving.py`) one step:
  1. base: every stream with K frames' samples on hand (or, once ended,
     its zero-padded tail) writes its (span+1)-sample window, pre-context
     first, into one host buffer (pinned on the card, recycled through
     `RowPool`); one host-to-device copy; ONE launch of the front-end
     kernel's block form (`kernels/frontend.logmel_block`) over those rows
     gives their [K, n_mels+1] prefixes. Non-mfcc families take their base
     features from the prefix in torch, as offline
     (`chain.base_from_prefix`; PLP's `plp_base` is tensor code).
  2. history: the base rows go into a device ring of 2c + K rows a stream
     (c = deltas · delta_window, the lookahead), one index_copy_.
  3. finalize: every stream with frames whose lookahead is now complete
     gathers its window of history, `first` (K + c rows from frame 0) or
     `inner` (c + K + c), zero rows past its end, and the windows of one
     width go through one launch: for mfcc the feature-tail kernel over
     prefix rows (log energy, DCT·lifter·c0, Δ/ΔΔ with replication at
     n_valid, the mask) — so a deltaless mfcc stream takes the tail too,
     for its DCT; for the other families `chain.delta` (or the rows as
     they are). Both widths write one output buffer; one device-to-host
     copy into pinned memory, waited on by an event before numpy reads it.
So the port keeps PREFIX history for mfcc where the reference keeps
cepstra. Global / speaker CMVN with corpus moments is host numpy on the
emitted rows. A round launches the front-end once and the tail at most
twice, whatever the number of streams; a stream's rows are computed by
their own blocks of each kernel, so its output does not depend on the other
streams of the round.

Delta edge exactness: interior windows carry c real context rows on both
sides, so no edge replication reaches an emitted row; the first window
starts at frame 0 (start-edge replication is the offline rule at the true
start); the final window passes n_valid so the tail's replication lands on
the true last frame.

Latency = the lookahead (c frames, 40 ms for Δ+ΔΔ) + one block (K hops).
Resampling configs resample on the host (`ops.resample.StreamingResampler`,
float64, sample-exact against scipy) and launch the block at the feature
rate. Refused, as by the reference: utterance CMVN, centered framing and
drop_last_frame, the Whisper norm, dither, and global or speaker CMVN
without moments. On the card a config the kernels refuse raises
NotImplementedError; there is no CPU fallback (device="cpu" runs the
kernels' plain versions).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from mfcc_tpu_torch.config import FrontendConfig
from mfcc_tpu_torch.ops import chain

__all__ = ["StreamingExtractor", "stream_features"]


def check_streamable(cfg: FrontendConfig, cmvn_moments) -> None:
    """The reference's refusals (ValueError), word for word."""
    if cfg.cmvn == "utterance":
        raise ValueError(
            "per-utterance CMVN needs the whole utterance and cannot "
            "be streamed; use cmvn='global' with cmvn_moments, or the "
            "offline extract()/extract_batch()"
        )
    if cfg.cmvn in ("global", "speaker") and cmvn_moments is None:
        raise ValueError(
            f"cfg.cmvn={cfg.cmvn!r} requires cmvn_moments=(s1, s2, n) "
            "(for 'speaker': this session's speaker's pool)"
        )
    if cfg.frame_tail in ("center", "center_reflect") or cfg.drop_last_frame:
        raise ValueError(
            "centered framing (frame_tail='center'/'center_reflect') "
            "reflects frames around the FINAL stream length, and "
            "drop_last_frame drops a frame known only at flush — "
            "neither is streamable; use frame_tail='drop' or 'pad'"
        )
    if cfg.logmel_norm != "none":
        raise ValueError(
            "logmel_norm='whisper' clamps at the utterance-global max, "
            "which is unknown until the stream ends; normalize offline "
            "or post-hoc"
        )
    if cfg.dither > 0.0:
        raise ValueError(
            "dither is random noise and has no streaming-vs-offline "
            "parity; extract with dither offline, or set dither=0"
        )


def stream_device(cfg: FrontendConfig, device) -> torch.device:
    """The device a stream runs on: on "cuda" a card must exist and cfg must
    compute in float32 (RuntimeError, NotImplementedError); no fallback."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: streaming runs on the card by default; pass "
                "device='cpu' for the kernels' plain versions"
            )
        if cfg.dtype != "float32":
            raise NotImplementedError(f"the kernels compute in float32, not {cfg.dtype}")
    elif device.type != "cpu":
        raise ValueError(f"streaming runs on 'cuda' or 'cpu', got {device}")
    return device


class _SampleBuf:
    """Chunk-deque sample FIFO: O(chunk) append, windowed copy-out, O(1)
    amortized drop (the reference's)."""

    __slots__ = ("_chunks", "_head", "_n")

    def __init__(self):
        self._chunks = collections.deque()
        self._head = 0  # consumed prefix of _chunks[0]
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def append(self, a: np.ndarray) -> None:
        if a.shape[0]:
            self._chunks.append(a)
            self._n += a.shape[0]

    def peek_into(self, out: np.ndarray, n: int) -> int:
        """Copy the first min(n, len) samples into out[:got]; returns got."""
        got = 0
        head = self._head
        for c in self._chunks:
            if got >= n:
                break
            seg = c[head : head + (n - got)]
            out[got : got + seg.shape[0]] = seg
            got += seg.shape[0]
            head = 0
        return got

    def drop(self, n: int) -> None:
        """Remove the first min(n, len) samples (pad and flush blocks
        advance past the buffered tail)."""
        n = min(n, self._n)
        self._n -= n
        while n:
            c = self._chunks[0]
            avail = c.shape[0] - self._head
            if avail <= n:
                n -= avail
                self._chunks.popleft()
                self._head = 0
            else:
                self._head += n
                n = 0


class _Stream:
    """One stream's host state (the reference StreamingExtractor's): the
    sample FIFO from the pre-context of frame t0's block, the frames
    base-computed (t0) and emitted, the end of the stream."""

    def __init__(self, cfg: FrontendConfig, K: int, span: int, lookahead: int):
        if cfg.input_sample_rate and cfg.input_sample_rate != cfg.sample_rate:
            from mfcc_tpu_torch.ops.resample import StreamingResampler

            self.resampler = StreamingResampler(cfg.input_sample_rate, cfg.sample_rate)
        else:
            self.resampler = None
        self.cfg, self.K, self.span, self.c = cfg, K, span, lookahead
        self.raw = _SampleBuf()  # samples from t = t0·S - 1 (once have_pre)
        self.have_pre = False  # raw's first sample is the pre-context?
        # samples still to drop as they arrive: a block advances K·S samples,
        # more than its window of span + 1 holds when the hop is longer than
        # a frame, so the next block's pre-context may not have arrived yet
        self.skip = 0
        self.t0 = 0  # first frame not yet base-computed
        self.n_samples = 0  # feature-rate samples pushed
        self.emitted = 0  # frames finalized and returned
        self.ended = False
        self.total = 0  # the stream's frame count, once ended

    def avail(self) -> int:
        """Samples on hand counting from frame t0's start."""
        return max(0, len(self.raw) - (1 if self.have_pre else 0))

    def _append(self, samples: np.ndarray) -> None:
        """Buffer feature-rate samples, less those still to skip."""
        self.n_samples += samples.shape[0]
        k = min(self.skip, samples.shape[0])
        self.skip -= k
        self.raw.append(samples[k:])

    def ingest(self, samples) -> None:
        """Buffer a chunk (resampled to cfg.sample_rate when configured)."""
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        if self.resampler is not None:
            samples = self.resampler.push(samples)
        else:
            samples = samples.copy()  # the caller may reuse its array after push returns
        self._append(samples)

    def end(self) -> None:
        """The audio is complete: drain the resampler's look-ahead tail and
        fix the stream's frame count (the offline count; 0 when empty)."""
        if self.resampler is not None:
            self._append(self.resampler.flush())
        self.ended = True
        self.total = self.cfg.num_frames(self.n_samples) if self.n_samples > 0 else 0

    def base_need(self) -> int | None:
        """The samples of signal in the next block's window when the stream
        has a block to compute now (a full one, or once ended its zero-padded
        tail), else None."""
        if not self.ended:
            return self.span if self.avail() >= self.span else None
        if self.t0 < self.total:
            return max(0, min(self.avail(), self.span))
        return None

    def prepare_base(self, win: np.ndarray) -> None:
        """Write the (span+1,) window for frames [t0, t0+K) into win: the
        pre-context sample (0 at the stream's start), then the samples on
        hand, zeros past them; then advance (drop K·S samples, t0 += K; those
        not on hand yet as they arrive: with a hop over L + 1 samples the
        window holds fewer than K·S)."""
        need = self.span + 1
        if self.have_pre:
            n = self.raw.peek_into(win, need)
        else:
            n = 1 + self.raw.peek_into(win[1:], need - 1)
            win[0] = 0.0  # the synthetic pre-context x[-1] = 0
        win[n:] = 0.0
        adv = self.K * self.cfg.frame_step - (0 if self.have_pre else 1)
        dropped = min(adv, len(self.raw))
        self.raw.drop(dropped)
        self.skip += adv - dropped
        self.have_pre = True
        self.t0 += self.K

    def drain_plan(self, final: bool) -> tuple[int, int, int, int, int, int] | None:
        """(start, ready, w0, width, n_rows, n_valid) of the frames [start,
        ready) that finalize now, from the window of history rows [w0, w0 +
        width), whose rows from n_rows on are zero; None when no frame is
        emittable. final: the stream has ended and every block is computed
        (its frames past `total` are pad-block artifacts)."""
        c, K = self.c, self.K
        n_base = min(self.t0, self.total) if final else self.t0
        ready = self.total if final else n_base - c
        start = self.emitted
        if ready <= start:
            return None
        w0 = max(0, start - c)
        n_rows = n_base - w0
        width = K + c if start == 0 and not final else 2 * c + K
        if n_rows > width:
            raise AssertionError("finalize window overflow")
        return start, ready, w0, width, n_rows, n_rows if final else width


def _cmvn_post(feat: np.ndarray, cfg: FrontendConfig, moments) -> np.ndarray:
    """Global / speaker CMVN with corpus moments (s1, s2, n), on the host."""
    if cfg.cmvn in ("global", "speaker"):
        s1, s2, n = moments
        mu = (s1 / n).astype(np.float32)
        feat = feat - mu
        if cfg.cmvn_var_norm:
            var = (s2 / n - (s1 / n) ** 2).astype(np.float32)
            feat = feat / np.sqrt(var + np.float32(cfg.cmvn_eps))
    return feat


class _RoundResult:
    __slots__ = ("frames", "finished", "progressed", "base_launches", "fin_launches")

    def __init__(self):
        self.frames: dict = {}  # key -> [k, feat_dim] float32
        self.finished: list = []
        self.progressed = False
        self.base_launches = 0
        self.fin_launches = 0


def _even(n: int) -> int:
    return n + (n & 1)


class _Engine:
    """The device side of a pool of n_slots streams: the history ring, the
    round's buffers and its launches (module docstring)."""

    def __init__(self, cfg: FrontendConfig, K: int, n_slots: int, device: torch.device,
                 cmvn_moments=None):
        from mfcc_tpu_torch.pipeline.batch import RowPool

        L, S = cfg.frame_length, cfg.frame_step
        self.cfg, self.K, self.n_slots, self.device = cfg, K, n_slots, device
        self.moments = cmvn_moments
        self.span = (K - 1) * S + L
        self.c = cfg.deltas * cfg.delta_window
        self.cap = 2 * self.c + K  # history rows a slot: the widest window
        self.mfcc = cfg.features == "mfcc"
        self.dim = cfg.n_mels + 1 if self.mfcc else cfg.feat_dim // (1 + cfg.deltas)
        self.zero_row = n_slots * self.cap
        self.hist = torch.zeros((self.zero_row + 1, self.dim), dtype=torch.float32, device=device)
        rows_out = n_slots * self.cap
        self.out_dev = torch.empty((rows_out, cfg.feat_dim), dtype=torch.float32, device=device)
        self.card = device.type == "cuda"
        # the round's host words: rows, valid, scatter indices, two groups'
        # gather indices and n_valid (int64 sections at even offsets)
        self.words = (n_slots * (self.span + 1) + _even(n_slots) + 2 * n_slots * K
                      + 2 * rows_out + 2 * _even(n_slots) + 8)
        if self.card:  # the copies' device and pinned host ends
            self.in_dev = torch.empty(self.words, dtype=torch.float32, device=device)
            self.out_host = torch.empty((rows_out, cfg.feat_dim), dtype=torch.float32,
                                        pin_memory=True)
        else:
            self.out_host = self.out_dev
        self.pool = RowPool(pin=self.card, capacity=2)

    def round(self, entries) -> _RoundResult:
        """One round over entries [(key, slot, _Stream)]: a base block for
        each stream that has one, then every emittable window (module
        docstring). Returns the emitted frames by key (the CMVN applied),
        the keys of streams that finished (their tails emitted), and whether
        anything changed."""
        from mfcc_tpu_torch.kernels import frontend, tail

        res = _RoundResult()
        K, span, cap = self.K, self.span, self.cap
        blocks = [(slot, st, v) for _, slot, st in entries if (v := st.base_need()) is not None]
        plans = []  # (key, slot, stream, plan, final)
        buf = self.pool.take(1, self.words, np.float32)
        words = buf[0]
        R = len(blocks)
        o_rows, o_valid = 0, R * (span + 1)
        o_sidx = _even(o_valid + R)
        rows = words[o_rows:o_valid].reshape(R, span + 1)
        valid = words[o_valid : o_valid + R].view(np.int32)
        sidx = words[o_sidx : o_sidx + 2 * R * K].view(np.int64)
        for r, (slot, st, v) in enumerate(blocks):
            sidx[r * K : (r + 1) * K] = slot * cap + (st.t0 + np.arange(K)) % cap
            valid[r] = v
            st.prepare_base(rows[r])
        for key, slot, st in entries:
            final = st.ended and st.t0 >= st.total
            plan = st.drain_plan(final)
            if plan is None:
                if final:
                    res.finished.append(key)
                continue
            plans.append((key, slot, st, plan, final))
        res.progressed = bool(blocks or plans or res.finished)
        if not (blocks or plans):
            self.pool.give(buf)
            return res
        # the finalize groups, one a window width, and their sections
        groups = {}
        for p in plans:
            groups.setdefault(p[3][3], []).append(p)
        o = o_sidx + 2 * R * K
        sections, out_row = [], 0
        for width, group in groups.items():
            G = len(group)
            gidx = words[o : o + 2 * G * width].view(np.int64).reshape(G, width)
            o_nv = o + 2 * G * width
            nv = words[o_nv : o_nv + G].view(np.int32)
            for g, (_, slot, _, (_, _, w0, _, n_rows, n_valid), _) in enumerate(group):
                j = np.arange(width)
                gidx[g] = np.where(j < n_rows, slot * cap + (w0 + j) % cap, self.zero_row)
                nv[g] = n_valid
            sections.append((width, group, o, o_nv, out_row))
            out_row += G * width
            o = _even(o_nv + G)
        used = o
        # the device work
        if self.card:
            dev = self.in_dev[:used]
            dev.copy_(torch.from_numpy(words[:used]), non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            self.pool.give(buf, [copied])
        else:
            dev = torch.from_numpy(words[:used])
        if R:
            prefix = frontend.logmel_block(dev[o_rows:o_valid].view(R, span + 1),
                                           dev[o_valid : o_valid + R].view(torch.int32), self.cfg)
            base = prefix if self.mfcc else chain.base_from_prefix(prefix, None, self.cfg)
            self.hist.index_copy_(0, dev[o_sidx : o_sidx + 2 * R * K].view(torch.int64),
                                  base.reshape(R * K, self.dim))
            res.base_launches = 1
        for width, group, o_g, o_nv, row0 in sections:
            G = len(group)
            gidx = dev[o_g : o_g + 2 * G * width].view(torch.int64)
            nv = dev[o_nv : o_nv + G].view(torch.int32)
            out = self.out_dev[row0 : row0 + G * width]
            if self.mfcc:
                win = self.hist.index_select(0, gidx).view(G, width, self.dim)
                tail.feature_tail(win, nv, self.cfg, out=out.view(G, width, -1))
            elif self.cfg.deltas:
                win = self.hist.index_select(0, gidx).view(G, width, self.dim)
                d = chain.delta(win, nv, self.cfg)
                parts = [win, d] + ([chain.delta(d, nv, self.cfg)] if self.cfg.deltas >= 2 else [])
                out.view(G, width, -1).copy_(torch.cat(parts, dim=-1))
            else:
                torch.index_select(self.hist, 0, gidx, out=out)
            res.fin_launches += 1
        if not self.card:
            self.pool.give(buf)
        host = self.out_host[:out_row]
        if self.card and out_row:
            host.copy_(self.out_dev[:out_row], non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()  # numpy reads the host rows only once the copy has landed
        out_np = host.numpy()
        for width, group, _, _, row0 in sections:
            for g, (key, _, st, (start, ready, w0, *_), final) in enumerate(group):
                a = row0 + g * width + start - w0
                feat = _cmvn_post(out_np[a : a + ready - start].copy(), self.cfg, self.moments)
                res.frames[key] = feat
                st.emitted = ready
                if final:
                    res.finished.append(key)
        return res


def _cat(parts: list[np.ndarray], feat_dim: int) -> np.ndarray:
    parts = [p for p in parts if p.size]
    if not parts:
        return np.zeros((0, feat_dim), dtype=np.float32)
    return np.concatenate(parts, axis=0)


class StreamingExtractor:
    """Incremental single-stream extractor on the card (module docstring).

    push(samples) -> [k, feat_dim] float32 of newly finalized frames
    flush()       -> the remaining frames; the stream is then closed

    device="cuda" (the default) runs the kernels and raises without a card;
    "cpu" runs their plain versions."""

    def __init__(
        self,
        cfg: FrontendConfig,
        *,
        frames_per_block: int = 128,
        cmvn_moments: tuple[np.ndarray, np.ndarray, float] | None = None,
        device="cuda",
    ):
        check_streamable(cfg, cmvn_moments)
        self.cfg = cfg
        self.K = int(frames_per_block)
        if self.K < 1:
            raise ValueError("frames_per_block must be >= 1")
        self.device = stream_device(cfg, device)
        self._engine = _Engine(cfg, self.K, 1, self.device, cmvn_moments)
        self.span = self._engine.span
        self.lookahead = self._engine.c  # finalize context rows
        self._stream = _Stream(cfg, self.K, self.span, self.lookahead)
        self._closed = False

    def push(self, samples) -> np.ndarray:
        """Feed a chunk of raw samples (at cfg.input_sample_rate when set);
        returns the newly finalized frames."""
        if self._closed:
            raise RuntimeError("stream already flushed")
        self._stream.ingest(samples)
        return self._run()

    def flush(self) -> np.ndarray:
        """Finish the stream: pad-tail frames and the delta end edges; close."""
        if self._closed:
            raise RuntimeError("stream already flushed")
        self._closed = True
        self._stream.end()
        return self._run()

    @property
    def frames_emitted(self) -> int:
        return self._stream.emitted

    @property
    def samples_consumed(self) -> int:
        return self._stream.n_samples

    def _run(self) -> np.ndarray:
        parts = []
        while True:
            res = self._engine.round([(0, 0, self._stream)])
            if 0 in res.frames:
                parts.append(res.frames[0])
            if not res.progressed or res.finished:
                break
        return _cat(parts, self.cfg.feat_dim)


def stream_features(chunks, cfg: FrontendConfig, **kw):
    """Generator convenience: yields [k, feat_dim] arrays per input chunk,
    then the flush remainder. `chunks` is any iterable of sample arrays;
    keywords go to `StreamingExtractor` (device="cuda" by default)."""
    ex = StreamingExtractor(cfg, **kw)
    for chunk in chunks:
        out = ex.push(chunk)
        if out.size:
            yield out
    tail = ex.flush()
    if tail.size:
        yield tail
