"""Long-utterance extraction: hop-aligned segmentation with frame-exact
stitching. The port of `mfcc_tpu/pipeline/longform.py`.

Utterances longer than the largest bucket are split here instead of
truncated. The split is exact, not approximate:

  - Segment boundaries sit on frame starts (multiples of the hop S), so the
    global frame grid is partitioned — frame f of the utterance appears in
    exactly one segment's *kept* range.
  - Every stage up to the frame's [log-mel | energy] prefix (and, for the
    other families, through their frame-local base features) is
    frame-local, so per-frame values computed inside a segment equal the
    monolithic values, with two boundary exceptions handled structurally:
      1. Pre-emphasis y[t] = x[t] − α·x[t−1] reaches one sample left of a
         segment: each non-first segment carries a 1-frame LEFT HALO whose
         frame 0 absorbs the wrong y[0] = x[o] (no x[o−1] available) and is
         discarded after extraction.
      2. The ceil-framing zero-pad tail only ever touches the LAST global
         frame, so only the final segment sees it — and reproduces it
         exactly, because framing is shift-invariant by multiples of S.
  - Δ/ΔΔ and utterance CMVN are NOT frame-local. For mfcc configs the
    segments' prefixes (`frontend.logmel_prefix_counts`) are stitched into
    one [1, F_total, n_mels+1] prefix and the feature tail
    (`tail.feature_tail`: on a card the `csrc/tail.cu` kernel) runs once
    over it, giving the DCT, Δ/ΔΔ, the mask and utterance CMVN. The other
    families stitch their base features and run `chain.delta` /
    `chain.cmvn_utterance` over them (`_post_pass`).

Resampling configs (input_sample_rate ≠ sample_rate) resample the whole
utterance FIRST (`ops/resample.resample_batch`: on a card the polyphase
kernel, `csrc/resample.cu`) — the polyphase filter has ~10·max_rate taps of
context, so segmenting at the input rate would break resample parity at
every seam — then segment at the target rate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mfcc_tpu_torch.config import FrontendConfig
from mfcc_tpu_torch.ops import chain


@dataclasses.dataclass(frozen=True)
class Segment:
    """One extraction window of a long utterance.

    offset:  first sample of the segment row in the global signal
    row_len: valid samples in the row (row audio = x[offset : offset+row_len])
    halo:    leading frames to DISCARD after extraction (0 or 1)
    keep:    frames this segment contributes to the stitched output
    """

    offset: int
    row_len: int
    halo: int
    keep: int


def segment_plan(
    n_samples: int, cfg: FrontendConfig, seg_frames: int
) -> tuple[list[Segment], int]:
    """Partition the frame grid [0, F_total) into runs of ≤ seg_frames.

    Returns (segments, F_total). Segment k keeps global frames
    [k·seg_frames, min((k+1)·seg_frames, F_total)); non-first segments add a
    1-frame left halo for the pre-emphasis boundary (see module docstring).
    """
    if seg_frames < 1:
        raise ValueError("seg_frames must be >= 1")
    S, L = cfg.frame_step, cfg.frame_length
    F_total = cfg.num_frames(n_samples)
    segs: list[Segment] = []
    f0 = 0
    while f0 < F_total:
        end = min(f0 + seg_frames, F_total)
        halo = 1 if f0 > 0 else 0
        offset = (f0 - halo) * S
        rowF = end - f0 + halo
        span = (rowF - 1) * S + L
        if end == F_total:
            row_len = n_samples - offset  # chain zero-pads the ceil tail
        else:
            row_len = span  # middle frames never touch the pad (f·S+L ≤ n)
        segs.append(Segment(offset=offset, row_len=row_len, halo=halo, keep=end - f0))
        f0 = end
    return segs, F_total


def _host_reflect_extend(
    x: np.ndarray, cfg: FrontendConfig
) -> tuple[np.ndarray, FrontendConfig]:
    """Numpy twin of the JAX package's kernels/frontend._reflect_extend
    for the longform path: rewrite centered framing ("center"/"center_reflect") as standard
    PAD framing on a reflected extension so the bounded segmented split
    applies. ext[i] = y[reflect(i + shift)], with ext sized exactly
    (F-1)*S + L so pad-tail framing of ext yields exactly F frames.

    input_scale and signal-mode pre-emphasis fold into ext (they must act
    BEFORE reflection — the twin computes reflect(preemph(scale(x)))); the
    returned config neutralizes all three knobs. Per-frame (Kaldi-mode)
    pre-emphasis is frame-local and stays in the config. All arithmetic in
    cfg's compute dtype so results match the one-shot device chain."""
    L, S = cfg.frame_length, cfg.frame_step
    n = int(x.shape[0])
    F = cfg.num_frames(n)  # includes drop_last_frame
    dt = np.dtype(cfg.dtype)
    y = np.asarray(x, dtype=dt)
    reps: dict = {"frame_tail": "pad", "drop_last_frame": False}
    if cfg.input_scale != 1.0:
        y = y * dt.type(cfg.input_scale)
        reps["input_scale"] = 1.0
    if cfg.preemph_mode == "signal" and cfg.preemph != 0.0:
        y = np.concatenate([y[:1], y[1:] - dt.type(cfg.preemph) * y[:-1]])
        y = y.astype(dt)
        reps["preemph"] = 0.0
    shift = (S // 2 - L // 2) if cfg.frame_tail == "center" else -(L // 2)
    ext_len = (F - 1) * S + L if F > 0 else 0
    idx = np.arange(ext_len, dtype=np.int64) + shift
    nn = max(n, 1)
    if cfg.frame_tail == "center":
        m = np.mod(idx, 2 * nn)
        r = np.where(m < nn, m, 2 * nn - 1 - m)
    else:
        m = np.mod(idx, max(2 * nn - 2, 1))
        r = np.where(m < nn, m, 2 * nn - 2 - m)
    ext = y[r] if n > 0 else np.zeros(0, dt)
    return ext, cfg.replace(**reps)


def _post_pass(base: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Δ/ΔΔ + utterance CMVN over stitched base features [F_total, D_base]
    → final [F_total, feat_dim] (every frame valid)."""
    F_total = base.shape[0]
    if cfg.deltas == 0 and cfg.cmvn != "utterance":
        return base
    x = base[None]
    n_valid = torch.tensor([F_total], dtype=torch.int32, device=base.device)
    parts = [x]
    if cfg.deltas >= 1:
        d = chain.delta(x, n_valid, cfg)
        parts.append(d)
        if cfg.deltas >= 2:
            parts.append(chain.delta(d, n_valid, cfg))
    feat = torch.cat(parts, dim=-1) if len(parts) > 1 else x
    if cfg.cmvn == "utterance":
        mask = chain.frame_mask(n_valid, F_total, feat.dtype)
        feat = chain.cmvn_utterance(feat, mask, cfg)
    return feat[0]


def _as_samples(x, device: torch.device, cfg: FrontendConfig) -> torch.Tensor:
    """One utterance as a tensor on `device`: int16 stays int16 (the
    kernels take it as it is), other types become the compute dtype."""
    x = chain._single(x)
    if x.dtype != torch.int16:
        x = x.to(chain.compute_dtype(cfg))
    return x.to(device)


def extract_long(
    x,
    cfg: FrontendConfig,
    device="cuda",
    seg_len_s: float = 10.0,
    batch_rows: int = 8,
) -> torch.Tensor:
    """Extract features from an utterance of ANY length → [F_total,
    feat_dim] on `device`.

    Utterances that fit in one segment take `chain.extract_single`
    unchanged. Longer ones are cut into segments of seg_len_s, extracted
    batch_rows at a time (the front-end kernel on a card), and stitched
    (see the module docstring).

    x is at cfg.input_sample_rate when that differs from cfg.sample_rate;
    the whole utterance is resampled up front. "cuda" without a card
    raises; there is no fallback to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: extract_long runs on the card by default; pass "
            "device='cpu' for the plain chain"
        )
    x = _as_samples(x, device, cfg)
    if chain.resamples(cfg):
        from mfcc_tpu_torch.ops import resample

        x = resample.resample_batch(
            x.to(chain.compute_dtype(cfg))[None], cfg.input_sample_rate, cfg.sample_rate
        )[0]
        cfg_t = cfg.replace(input_sample_rate=None)
    else:
        cfg_t = cfg

    S, L = cfg_t.frame_step, cfg_t.frame_length
    seg_frames = max(1, int(round(seg_len_s * cfg_t.sample_rate)) // S)
    n = int(x.shape[0])
    if cfg_t.num_frames(n) <= seg_frames:
        return chain.extract_single(x, cfg_t, device=device)
    if cfg_t.logmel_norm != "none":
        # logmel_norm="whisper" clamps at the GLOBAL utterance max — a
        # segment row would clamp at its own max, so the split is not
        # frame-exact. One whole-length extraction is correct at any
        # length; the row is padded to a bucket multiple.
        bucket = max(1, int(round(seg_len_s * cfg_t.sample_rate)))
        T = ((n + bucket - 1) // bucket) * bucket
        audio = x.new_zeros((1, T))
        audio[0, :n] = x
        feat, _ = chain.extract_batch(audio, [n], cfg_t, device=device)
        return feat[0, : cfg_t.num_frames(n)]
    if cfg_t.dither > 0.0:
        raise ValueError(
            "extract_long with dither > 0 would draw different noise per "
            "segment row; extract in one piece or set dither=0"
        )
    if cfg_t.frame_tail in ("center", "center_reflect"):
        # centered framing reflects indices around the GLOBAL signal edges,
        # which a segment row cannot see; the host-side reflect-extension
        # turns it into standard pad framing on ext (input_scale and signal
        # pre-emphasis fold into ext)
        ext, cfg_t = _host_reflect_extend(x.cpu().numpy(), cfg_t)
        x = torch.as_tensor(ext).to(device)
        n = int(x.shape[0])

    segs, F_total = segment_plan(n, cfg_t, seg_frames)
    # base (frame-local) config: no deltas, no CMVN, no per-row last-frame
    # drop (segment_plan's F_total already excludes the dropped frame)
    cfg_base = cfg_t.replace(deltas=0, cmvn="off", drop_last_frame=False)
    # span of a halo-carrying full segment; with drop_last_frame the final
    # segment's row carries up to one extra hop of (unused) valid samples
    T_row = seg_frames * S + L + (S if cfg_t.drop_last_frame else 0)
    prefix_path = cfg_t.features == "mfcc"
    width = cfg_t.n_mels + 1 if prefix_path else cfg_base.feat_dim
    base = None
    f0 = 0
    for i in range(0, len(segs), batch_rows):
        group = segs[i : i + batch_rows]
        rows = x.new_zeros((batch_rows, T_row))
        lengths = torch.zeros(batch_rows, dtype=torch.int32)
        for r, s in enumerate(group):
            rows[r, : s.row_len] = x[s.offset : s.offset + s.row_len]
            lengths[r] = s.row_len
        lengths = lengths.to(device)
        if prefix_path:
            from mfcc_tpu_torch.kernels import frontend

            out = frontend.logmel_prefix_counts(rows, lengths, cfg_base)[0]
        else:
            out, _ = chain.extract_batch(rows, lengths, cfg_base, device=device)
        if base is None:
            base = out.new_empty((F_total, width))
        for r, s in enumerate(group):
            base[f0 : f0 + s.keep] = out[r, s.halo : s.halo + s.keep]
            f0 += s.keep
    if not prefix_path:
        return _post_pass(base, cfg)
    from mfcc_tpu_torch.kernels import tail

    n_valid = torch.tensor([F_total], dtype=torch.int32, device=device)
    return tail.feature_tail(base[None], n_valid, cfg_t)[0]


def long_moments(feat) -> tuple[np.ndarray, np.ndarray, float]:
    """Global-CMVN moment triple of a fully-valid [F, D] feature array or
    tensor, in float64 on the host — the analogue of
    parallel.cmvn.batch_moments for long utterances (every stitched frame
    is valid)."""
    f = feat.detach().cpu().numpy() if isinstance(feat, torch.Tensor) else np.asarray(feat)
    f = f.astype(np.float64)
    return f.sum(axis=0), np.square(f).sum(axis=0), float(f.shape[0])
