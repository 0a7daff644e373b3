"""The float64 NumPy acceptance oracle: the port's own copy of
`mfcc_tpu/ops/reference_numpy.py` (the stage spec of SURVEY.md Appendix B),
over the port's `config` and `ops/constants.py`.

Sequential float64 numpy, no torch op: the port's chain and kernels are held
to it (`cli info --self-test`, the gates of `docs/ACCURACY.md`), and
`compat.py` is composed from its stages. With dither it draws the contract
noise by `ops/dither.signal_noise_np`.
"""

from __future__ import annotations

import math

import numpy as np

from mfcc_tpu_torch.config import FrontendConfig
from mfcc_tpu_torch.ops import constants as C

# ---------------------------------------------------------------------------
# Per-stage functions (Appendix B numbering in comments)
# ---------------------------------------------------------------------------


def preemphasis(x: np.ndarray, coeff: float) -> np.ndarray:
    """(1) y[0] = x[0]; y[t] = x[t] - coeff * x[t-1]."""
    x = np.asarray(x, dtype=np.float64)
    if coeff == 0.0:
        return x.copy()
    return np.concatenate([x[:1], x[1:] - coeff * x[:-1]])


def frame_signal(x: np.ndarray, frame_length: int, frame_step: int, tail: str = "pad") -> np.ndarray:
    """(2) F = 1 + ceil(max(0, N-L)/S) with zero-padded tail ("pad"), the
    drop-tail variant 1 + (N-L)//S ("drop", Kaldi snip_edges=true), or the
    centered variant F = (N + S//2)//S with frame f starting at
    f*S + S//2 - L//2 and out-of-range samples edge-reflected
    (Kaldi snip_edges=false); frames[f, n] = x[start_f + n]."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if tail == "pad":
        num = 1 + math.ceil(max(0, n - frame_length) / frame_step)
        padded_len = (num - 1) * frame_step + frame_length
        x = np.concatenate([x, np.zeros(padded_len - n)])
    elif tail == "center":
        num = (n + frame_step // 2) // frame_step
        start = frame_step * np.arange(num)[:, None] + frame_step // 2 - frame_length // 2
        idx = reflect_index(start + np.arange(frame_length)[None, :], n)
        return x[idx]
    elif tail == "center_reflect":
        # librosa / torch.stft center=True, pad_mode="reflect": pad L//2
        # both sides with numpy-style reflection (edge sample NOT repeated),
        # frames start at f*S in the padded signal (centered at f*S in the
        # original); F = 1 + (N + 2*(L//2) - L) // S
        if n == 0:
            return np.zeros((0, frame_length))
        pad = frame_length // 2
        x = np.pad(x, (pad, pad), mode="reflect")
        num = 1 + (x.shape[0] - frame_length) // frame_step
    else:
        num = max(0, 1 + (n - frame_length) // frame_step) if n >= frame_length else 0
    idx = np.arange(frame_length)[None, :] + frame_step * np.arange(num)[:, None]
    return x[idx]


def reflect_index(idx: np.ndarray, n: int) -> np.ndarray:
    """Edge-reflected sample index: the fixed point of
    `while s out of range: s = -s-1 (left) / 2n-1-s (right)` — Kaldi's
    snip_edges=false reflection — in closed form as the period-2n
    triangular wave m -> m if m < n else 2n-1-m over m = idx mod 2n."""
    m = np.mod(idx, 2 * n)
    return np.where(m < n, m, 2 * n - 1 - m)


def power_spectrum(frames: np.ndarray, n_fft: int, scale_nfft: bool) -> np.ndarray:
    """(4)+(5) rfft with zero-pad to n_fft; P = |X|^2 / NFFT (psf) or |X|^2."""
    spec = np.fft.rfft(frames, n_fft)
    p = np.abs(spec) ** 2
    return p / n_fft if scale_nfft else p


def frame_energy(pspec: np.ndarray, eps: float) -> np.ndarray:
    """(5) E[f] = sum_k P[f, k], zero-clamped to eps."""
    e = pspec.sum(axis=-1)
    return np.where(e <= 0, eps, e)


def apply_log(x: np.ndarray, kind: str, eps: float) -> np.ndarray:
    """(7) log compression variants (Appendix C log row). "ln_floor" is the
    Kaldi ApplyFloor(eps)-then-log convention: tiny POSITIVE energies are
    floored too (vs "ln", which only replaces non-positives)."""
    if kind == "ln":
        return np.log(np.where(x <= 0, eps, x))
    if kind == "ln_stab":
        return np.log(x + 1e-6)
    if kind == "db":
        return 10.0 * np.log10(np.where(x <= 0, eps, x))
    if kind == "ln_floor":
        return np.log(np.maximum(x, eps))
    if kind == "log10_floor":  # librosa/Whisper: log10(max(x, eps))
        return np.log10(np.maximum(x, eps))
    raise ValueError(kind)


def delta(feat: np.ndarray, n: int) -> np.ndarray:
    """(10) regression delta, edge-replicated padding:
    d_t = sum_{i=1..n} i*(c_{t+i} - c_{t-i}) / (2 * sum i^2)."""
    if feat.shape[0] == 0:  # 0-frame utterance (drop-tail shorter than L)
        return np.zeros_like(feat)
    denom = 2.0 * sum(i * i for i in range(1, n + 1))
    padded = np.pad(feat, ((n, n), (0, 0)), mode="edge")
    out = np.zeros_like(feat)
    for i in range(1, n + 1):
        out += i * (padded[n + i : n + i + feat.shape[0]] - padded[n - i : n - i + feat.shape[0]])
    return out / denom


def durbin(r: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Levinson-Durbin over the frame axis: autocorrelations r [F, P+1] →
    (prediction coefficients a [F, P] with x̂[t] = Σ a_k x[t-k], residual
    energy E [F]). Solves the Yule-Walker Toeplitz system exactly
    (certified vs np.linalg.solve in tests/test_plp.py). All-zero frames
    (silence/padding) yield a = 0, E = 0 via the guarded division."""
    f, p1 = r.shape
    p = p1 - 1
    a = np.zeros((f, p), dtype=np.float64)
    e = r[:, 0].astype(np.float64).copy()
    for i in range(p):
        acc = r[:, i + 1].astype(np.float64).copy()
        for j in range(i):
            acc -= a[:, j] * r[:, i - j]
        k = np.where(e != 0, acc / np.where(e == 0, 1.0, e), 0.0)
        new = a.copy()
        new[:, i] = k
        for j in range(i):
            new[:, j] = a[:, j] - k * a[:, i - 1 - j]
        a = new
        e = e * (1.0 - k * k)
    return a, e


def lpc_to_cepstrum(a: np.ndarray) -> np.ndarray:
    """LPC → cepstra of the all-pole model 1/A(z), A(z) = 1 - Σ a_k z^-k:
    c_n = a_n + Σ_{k=1..n-1} (k/n)·c_k·a_{n-k} — the power series of
    -log A(z) (certified vs an FFT log-spectrum in tests/test_plp.py)."""
    f, p = a.shape
    c = np.zeros((f, p), dtype=np.float64)
    for n in range(1, p + 1):
        acc = a[:, n - 1].astype(np.float64).copy()
        for k in range(1, n):
            acc += (k / n) * c[:, k - 1] * a[:, n - k - 1]
        c[:, n - 1] = acc
    return c


def plp_base(
    melspec: np.ndarray, energy: np.ndarray, cfg: FrontendConfig,
    k: dict[str, np.ndarray],
) -> np.ndarray:
    """PLP cepstra from mel energies [F, M] (Kaldi compute-plp-feats
    order): equal-loudness weighting → compress_factor power law →
    first/last-bin duplication → IDFT to autocorrelation → Levinson-
    Durbin → LPC cepstra; c0 = residual log energy; lifter; optional
    c0 ← ln(frame energy)."""
    mel = np.maximum(melspec, 0.0) * k["equal_loudness"][None, :]
    mel = mel ** cfg.compress_factor
    dup = np.concatenate([mel[:, :1], mel, mel[:, -1:]], axis=1)
    r = dup @ k["idft"].T  # [F, lpc_order+1]
    a, e = durbin(r)
    c = lpc_to_cepstrum(a)
    c0 = np.log(np.maximum(e, cfg.log_eps))
    base = np.concatenate([c0[:, None], c[:, : cfg.n_ceps - 1]], axis=1)
    base = base * k["lifter"][None, :]  # lifter[0] == 1: c0 unscaled
    if cfg.append_energy:
        log_e = np.log(energy)
        if cfg.energy_floor > 0.0:
            log_e = np.maximum(log_e, math.log(cfg.energy_floor))
        base = base.copy()
        base[:, 0] = log_e
    return base


def cmvn_utterance(feat: np.ndarray, var_norm: bool, eps: float) -> np.ndarray:
    """(11) per-utterance mean/variance normalization over the frame axis."""
    mu = feat.mean(axis=0, keepdims=True)
    out = feat - mu
    if var_norm:
        var = feat.var(axis=0, keepdims=True)
        out = out / np.sqrt(var + eps)
    return out


def cmvn_from_moments(feat: np.ndarray, s1: np.ndarray, s2: np.ndarray, n: float,
                      var_norm: bool, eps: float) -> np.ndarray:
    """Global CMVN applied from corpus moment triples (Σx, Σx², n) — the
    algebra the distributed psum reduction must reproduce."""
    mu = s1 / n
    out = feat - mu
    if var_norm:
        var = s2 / n - mu * mu
        out = out / np.sqrt(var + eps)
    return out


# ---------------------------------------------------------------------------
# Full chains
# ---------------------------------------------------------------------------


def preemphasis_frames(frames: np.ndarray, coeff: float) -> np.ndarray:
    """Per-frame pre-emphasis (Kaldi ProcessWindow): within each frame,
    w[n] -= coeff * w[n-1] for n >= 1 and w[0] *= (1 - coeff)."""
    if coeff == 0.0:
        return frames.copy()
    return np.concatenate(
        [frames[:, :1] * (1.0 - coeff), frames[:, 1:] - coeff * frames[:, :-1]],
        axis=1,
    )


def logmel_chain(
    x: np.ndarray, cfg: FrontendConfig, dither_noise: np.ndarray | None = None
) -> dict[str, np.ndarray]:
    """Run stages (1)-(7), returning every intermediate for per-stage goldens.

    preemph_mode="signal" is the psf-lineage order (pre-emphasize the whole
    signal, then frame). preemph_mode="frame" (plus dither /
    remove_dc_offset / frame-local energy) is the Kaldi feature-window
    order: frame the RAW signal first, then per frame
    dither -> DC removal -> [raw energy] -> pre-emphasis -> window ->
    [windowed energy] -> spectrum.

    dither_noise: optional pre-drawn [len(x)] SIGNAL noise (unit stddev) so
    a caller can reproduce the torch chain's draw bit-exactly (its stage
    dict's "dither_noise"); when None and cfg.dither > 0, the numpy twin of
    the contract (ops/dither.signal_noise_np) is used — equal to that draw up to
    transcendental ulps (~1e-7 relative), so exact-replay tests pass the
    noise in. Dither is applied to the SIGNAL, before pre-emphasis in both
    modes (the contract's ordering; ops/dither.py docstring).
    """
    k = C.chain_constants(cfg)
    x = np.asarray(x, dtype=np.float64)
    if cfg.input_scale != 1.0:
        x = x * cfg.input_scale
    if cfg.dither > 0.0:
        if dither_noise is None:
            from mfcc_tpu_torch.ops.dither import signal_noise_np

            dither_noise = signal_noise_np(
                cfg.dither_seed, x.shape[0], cfg.frame_step
            )
        x = x + cfg.dither * np.asarray(dither_noise, dtype=np.float64)
    if cfg.preemph_mode == "signal":
        y = preemphasis(x, cfg.preemph)
    else:
        y = x
    frames = frame_signal(y, cfg.frame_length, cfg.frame_step, cfg.frame_tail)
    if cfg.drop_last_frame:  # the Whisper log_spec[:, :-1] quirk
        frames = frames[: max(0, frames.shape[0] - 1)]
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    raw_energy = np.maximum((frames ** 2).sum(axis=1), cfg.log_eps)
    if cfg.preemph_mode == "frame":
        frames = preemphasis_frames(frames, cfg.preemph)
    windowed = frames * k["window"][None, :]
    pspec = power_spectrum(windowed, cfg.n_fft, cfg.power_scale_nfft)
    if cfg.energy_source == "pspec":
        energy = frame_energy(pspec, cfg.log_eps)
    elif cfg.energy_source == "raw_frame":
        energy = raw_energy
    else:  # windowed_frame (Kaldi raw_energy=false): post-preemph+window
        energy = np.maximum((windowed ** 2).sum(axis=1), cfg.log_eps)
    melspec = pspec @ k["mel"]  # [F, n_mels]
    logmel = apply_log(melspec, cfg.log_kind, cfg.log_eps)
    return {
        "preemph": y,
        "frames": frames,
        "windowed": windowed,
        "pspec": pspec,
        "energy": energy,
        "melspec": melspec,
        "logmel": logmel,
    }


def extract(
    x: np.ndarray, cfg: FrontendConfig, dither_noise: np.ndarray | None = None
) -> np.ndarray:
    """Full single-utterance chain -> [F, feat_dim] float64 features."""
    return extract_stages(x, cfg, dither_noise=dither_noise)["features"]


def extract_stages(
    x: np.ndarray, cfg: FrontendConfig, dither_noise: np.ndarray | None = None
) -> dict[str, np.ndarray]:
    """Like `extract` but returns every intermediate stage (for goldens)."""
    k = C.chain_constants(cfg)
    stages = logmel_chain(x, cfg, dither_noise=dither_noise)
    if cfg.features == "logmel":
        base = stages["logmel"]
        if cfg.logmel_norm == "whisper" and base.shape[0] > 0:
            # per-utterance dynamic-range compression (Whisper front-end):
            # clamp at 8 log10-units below the utterance max, shift+scale
            base = np.maximum(base, base.max() - 8.0)
            base = (base + 4.0) / 4.0
    elif cfg.features == "ssc":
        # spectral subband centroids (compat.ssc semantics): clamp the
        # power spectrum, then power-weighted mean frequency per band
        p = np.where(stages["pspec"] <= 0, cfg.log_eps, stages["pspec"])
        base = (p * k["freqs"][None, :]) @ k["mel"] / (p @ k["mel"])
    elif cfg.features == "plp":
        base = plp_base(stages["melspec"], stages["energy"], cfg, k)
    elif cfg.features == "spectrogram":
        # log power spectrum per bin (mel == identity, so logmel IS the
        # log pspec); Kaldi replaces feature[0] with the log frame energy
        base = stages["logmel"].copy()
        if cfg.append_energy:
            log_e = np.log(stages["energy"])
            if cfg.energy_floor > 0.0:
                log_e = np.maximum(log_e, math.log(cfg.energy_floor))
            base[:, 0] = log_e
    else:
        ceps = stages["logmel"] @ k["dct"]  # (8) DCT-II slice to n_ceps
        ceps = ceps * k["lifter"][None, :]  # (9) lifter...
        if cfg.append_energy:  # ...then c0 <- ln(E)
            ceps = ceps.copy()
            log_e = np.log(stages["energy"])
            if cfg.energy_floor > 0.0:  # Kaldi --energy-floor on ln(E)
                log_e = np.maximum(log_e, math.log(cfg.energy_floor))
            ceps[:, 0] = log_e
        base = ceps
    stages["base"] = base

    parts = [base]
    if cfg.deltas >= 1:
        d = delta(base, cfg.delta_window)
        parts.append(d)
        stages["delta"] = d
        if cfg.deltas >= 2:
            dd = delta(d, cfg.delta_window)
            parts.append(dd)
            stages["delta2"] = dd
    feat = np.concatenate(parts, axis=1)

    if cfg.cmvn == "utterance":
        feat = cmvn_utterance(feat, cfg.cmvn_var_norm, cfg.cmvn_eps)
    # cfg.cmvn == "global" is corpus-level; the oracle for it is
    # cmvn_from_moments with numpy-reduced corpus moments (test_distributed).
    stages["features"] = feat
    return stages
