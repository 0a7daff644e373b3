"""Host-side constant builders for the torch chain and the CUDA kernels.

The port's own copy of `mfcc_tpu/ops/constants.py` (numpy only), plus
`to_torch`, which carries a dict of these float64 host constants onto a
device in the compute dtype — this system's "weights".

All constants are computed in float64 on host (SURVEY.md §7.2 hard-part #1:
"keep filterbank/DCT/window constants computed in float64 on host, cast once
to fp32") and returned as numpy arrays; callers cast to the device dtype.

Conventions implemented per SURVEY.md Appendix B/C, certified against the
on-disk oracles in tests/test_oracle_certification.py:
  - window:    scipy.signal.windows (symmetric) / TF window_ops (periodic)
  - mel psf:   bin-quantized triangles, floor((NFFT+1)*hz/sr)
  - mel tf:    continuous mel-domain slopes, DC bin excluded
               (tf/signal/mel_ops.py:181-212 semantics)
  - DCT:       scipy ortho; HTK = ortho with bin-0 scaled by sqrt(2)
               (tf/signal/mfcc_ops.py:89-107 semantics)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mfcc_tpu_torch.config import FrontendConfig

# ---------------------------------------------------------------------------
# Mel scales:
#   HTK:    m = 2595 log10(1 + f/700)  ≈  Kaldi's 1127 ln(1 + f/700)
#           (2595/ln10 = 1127.0105 — ~9e-6 relative, inside feature gates)
#   Slaney: linear 3f/200 below 1 kHz, log above (librosa/Auditory-Toolbox;
#           matches transformers.audio_utils.hertz_to_mel(mel_scale="slaney"))
# ---------------------------------------------------------------------------

_SLANEY_MIN_LOG_HZ = 1000.0
_SLANEY_MIN_LOG_MEL = 15.0  # == 3 * 1000 / 200
_SLANEY_LOGSTEP = 27.0 / np.log(6.4)  # 27 mels span [1 kHz, 6.4 kHz]


def hz_to_mel(hz, scale: str = "htk"):
    hz = np.asarray(hz, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + hz / 700.0)
    lin = 3.0 * hz / 200.0
    with np.errstate(divide="ignore", invalid="ignore"):
        log = _SLANEY_MIN_LOG_MEL + np.log(hz / _SLANEY_MIN_LOG_HZ) * _SLANEY_LOGSTEP
    return np.where(hz >= _SLANEY_MIN_LOG_HZ, log, lin)


def mel_to_hz(mel, scale: str = "htk"):
    mel = np.asarray(mel, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    lin = 200.0 * mel / 3.0
    log = _SLANEY_MIN_LOG_HZ * np.exp((mel - _SLANEY_MIN_LOG_MEL) / _SLANEY_LOGSTEP)
    return np.where(mel >= _SLANEY_MIN_LOG_MEL, log, lin)


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------


def window_vector(kind: str, length: int) -> np.ndarray:
    """Analysis window, float64.

    "sym" variants follow the numpy/scipy convention w[n] over n/(M-1)
    (np.hamming); "periodic" variants use n/M (the TF/STFT convention,
    tf/signal/window_ops.py periodic default).
    """
    n = np.arange(length, dtype=np.float64)
    if kind == "rect":
        return np.ones(length, dtype=np.float64)
    if kind == "povey":
        # Kaldi's default analysis window (src/feat/feature-window.cc):
        # a Hann raised to 0.85, symmetric — between Hamming and Hann in
        # sidelobe behaviour, without Hamming's nonzero endpoints
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))) ** 0.85
    denom = (length - 1) if kind.endswith("_sym") else length
    if kind.startswith("hamming"):
        a, b = 0.54, 0.46
    elif kind.startswith("hann"):
        a, b = 0.5, 0.5
    elif kind.startswith("blackman"):
        # classic 3-term Blackman (np.blackman / scipy sym convention)
        x = 2.0 * np.pi * n / denom
        return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2.0 * x)
    else:
        raise ValueError(f"unknown window {kind!r}")
    return a - b * np.cos(2.0 * np.pi * n / denom)


# ---------------------------------------------------------------------------
# Mel filterbanks — both convention variants, shape [n_bins, n_mels]
# ---------------------------------------------------------------------------


def _slaney_norm(fb: np.ndarray, edge_hz: np.ndarray) -> np.ndarray:
    """Scale each triangle by 2 / bandwidth (librosa norm="slaney" /
    transformers enorm): approximately constant energy per channel.
    edge_hz: the [n_mels + 2] Hz edge points the triangles were built on."""
    n_mels = fb.shape[1]
    enorm = 2.0 / (edge_hz[2 : n_mels + 2] - edge_hz[:n_mels])
    return fb * enorm[None, :]


def mel_filterbank_psf(
    n_mels: int, n_fft: int, sample_rate: int, low_hz: float, high_hz: float,
    scale: str = "htk", norm: str = "none",
) -> np.ndarray:
    """Bin-quantized triangular filterbank (psf/tutorial lineage).

    Edges are FFT-bin indices floor((NFFT+1) * hz / sr); triangle j rises on
    [b_j, b_{j+1}) and falls on [b_{j+1}, b_{j+2}) (SURVEY.md Appendix B #6).
    norm="slaney" uses the un-quantized edge frequencies for the bandwidth.
    """
    n_bins = n_fft // 2 + 1
    mel_pts = np.linspace(
        hz_to_mel(low_hz, scale), hz_to_mel(high_hz, scale), n_mels + 2
    )
    edge_hz = mel_to_hz(mel_pts, scale)
    bins = np.floor((n_fft + 1) * edge_hz / sample_rate).astype(np.int64)
    fb = np.zeros((n_mels, n_bins), dtype=np.float64)
    for j in range(n_mels):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    fb = fb.T  # [n_bins, n_mels]
    return _slaney_norm(fb, edge_hz) if norm == "slaney" else fb


def vtln_warp_freq(
    freq, vtln_low: float, vtln_high: float, low_hz: float, high_hz: float,
    warp: float,
):
    """Kaldi-style piecewise-linear VTLN frequency warp (the standard
    compute-mfcc-feats --vtln-warp function; mel-computations lineage —
    no Kaldi source on disk, re-derived and property-tested).

    Identity outside [low_hz, high_hz]; y = freq/warp on the central band
    [l, h] with l = vtln_low*max(1, warp), h = vtln_high*min(1, warp);
    linear interpolation pins the endpoints low_hz -> low_hz and
    high_hz -> high_hz so the warped axis stays inside the filter range.
    """
    freq = np.asarray(freq, dtype=np.float64)
    if warp == 1.0:
        return freq.copy()
    if not (0 < low_hz < vtln_low < vtln_high < high_hz):
        raise ValueError(
            f"vtln requires 0 < low ({low_hz}) < vtln_low ({vtln_low}) < "
            f"vtln_high ({vtln_high}) < high ({high_hz})"
        )
    l = vtln_low * max(1.0, warp)
    h = vtln_high * min(1.0, warp)
    scale = 1.0 / warp
    fl, fh = scale * l, scale * h
    out = np.where(
        freq < l,
        low_hz + (fl - low_hz) / (l - low_hz) * (freq - low_hz),
        np.where(
            freq < h,
            scale * freq,
            high_hz + (high_hz - fh) / (high_hz - h) * (freq - high_hz),
        ),
    )
    return np.where((freq < low_hz) | (freq > high_hz), freq, out)


def mel_filterbank_tf(
    n_mels: int, n_fft: int, sample_rate: int, low_hz: float, high_hz: float,
    vtln: tuple[float, float, float] | None = None,
    scale: str = "htk", norm: str = "none",
) -> np.ndarray:
    """Continuous mel-domain triangles, DC bin excluded.

    Same semantics as tf.signal.linear_to_mel_weight_matrix
    (tf/signal/mel_ops.py:181-212): linear bin centers linspace(0, sr/2,
    n_bins)[1:] mapped to mel, band edge triples from linspace(mel_lo,
    mel_hi, n_mels+2), weight = max(0, min(up_slope, down_slope)); the DC
    row is zero. This is also the Kaldi mel-bank algebra: Kaldi evaluates
    the same triangles on the identical k*sr/n_fft grid (its bin loop stops
    before nyquist, where the top triangle is zero anyway), and Kaldi's
    rounded 1127*ln(1+f/700) matches 2595*log10(1+f/700) to ~9e-6 relative.

    vtln = (warp, vtln_low_hz, vtln_high_hz) warps the triangle EDGES
    through vtln_warp_freq in the Hz domain (Kaldi VtlnWarpMelFreq); the
    spectral bin grid is untouched.
    """
    n_bins = n_fft // 2 + 1
    spec_mel = hz_to_mel(
        np.linspace(0.0, sample_rate / 2.0, n_bins)[1:], scale
    )  # [n_bins-1]
    edges_mel = np.linspace(
        hz_to_mel(low_hz, scale), hz_to_mel(high_hz, scale), n_mels + 2
    )
    if vtln is not None and vtln[0] != 1.0:
        warp, vlow, vhigh = vtln
        if vhigh <= 0:  # Kaldi: non-positive vtln_high is nyquist-relative
            vhigh += sample_rate / 2.0
        edges_mel = hz_to_mel(
            vtln_warp_freq(
                mel_to_hz(edges_mel, scale), vlow, vhigh, low_hz, high_hz, warp
            ),
            scale,
        )
    lower, center, upper = edges_mel[:-2], edges_mel[1:-1], edges_mel[2:]
    up = (spec_mel[:, None] - lower[None, :]) / (center - lower)[None, :]
    down = (upper[None, :] - spec_mel[:, None]) / (upper - center)[None, :]
    w = np.maximum(0.0, np.minimum(up, down))  # [n_bins-1, n_mels]
    fb = np.concatenate([np.zeros((1, n_mels)), w], axis=0)  # [n_bins, n_mels]
    return _slaney_norm(fb, mel_to_hz(edges_mel, scale)) if norm == "slaney" else fb


def mel_filterbank_hz(
    n_mels: int, n_fft: int, sample_rate: int, low_hz: float, high_hz: float,
    scale: str = "htk", norm: str = "none",
) -> np.ndarray:
    """Hz-domain continuous triangles on the linspace bin grid — the
    librosa / transformers.audio_utils.mel_filter_bank (triangularize_in_
    mel_space=False) / torchaudio lineage. Mel spacing places the EDGES;
    the slopes are linear in Hz (unlike mel_filterbank_tf's mel-domain
    slopes — the two differ above ~1 kHz even for identical edges).
    scale="slaney" + norm="slaney" is the librosa default and the Whisper
    front-end filterbank."""
    n_bins = n_fft // 2 + 1
    fft_hz = np.linspace(0.0, sample_rate / 2.0, n_bins)  # == k * sr / n_fft
    edge_hz = mel_to_hz(
        np.linspace(
            hz_to_mel(low_hz, scale), hz_to_mel(high_hz, scale), n_mels + 2
        ),
        scale,
    )
    lower, center, upper = edge_hz[:-2], edge_hz[1:-1], edge_hz[2:]
    up = (fft_hz[:, None] - lower[None, :]) / (center - lower)[None, :]
    down = (upper[None, :] - fft_hz[:, None]) / (upper - center)[None, :]
    fb = np.maximum(0.0, np.minimum(up, down))  # [n_bins, n_mels]
    return _slaney_norm(fb, edge_hz) if norm == "slaney" else fb


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    if cfg.features == "spectrogram":
        # one output lane per FFT bin (Kaldi compute-spectrogram-feats):
        # the "filterbank" is the identity, so the whole kernel/twin
        # machinery (duplicated/scrambled-bin projection, energy column,
        # log epilogue) applies unchanged with melspec == pspec
        return np.eye(cfg.n_bins, dtype=np.float64)
    if cfg.mel_variant == "psf_quantized":
        return mel_filterbank_psf(
            cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.mel_low_hz, cfg.mel_high,
            scale=cfg.mel_scale, norm=cfg.mel_norm,
        )
    if cfg.mel_variant == "librosa_hz":
        return mel_filterbank_hz(
            cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.mel_low_hz, cfg.mel_high,
            scale=cfg.mel_scale, norm=cfg.mel_norm,
        )
    return mel_filterbank_tf(
        cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.mel_low_hz, cfg.mel_high,
        vtln=(cfg.vtln_warp, cfg.vtln_low_hz, cfg.vtln_high_hz),
        scale=cfg.mel_scale, norm=cfg.mel_norm,
    )


# ---------------------------------------------------------------------------
# PLP constants (Kaldi compute-plp-feats lineage; re-derived — no Kaldi on
# disk — and property-certified in tests/test_plp.py)
# ---------------------------------------------------------------------------


def mel_center_freqs(cfg: FrontendConfig) -> np.ndarray:
    """[n_mels] triangle center frequencies in Hz (VTLN-warped when the
    config warps the bank) — the grid the equal-loudness curve is sampled
    on, mirroring the edge algebra of the matching filterbank builder."""
    edges_mel = np.linspace(
        hz_to_mel(cfg.mel_low_hz, cfg.mel_scale),
        hz_to_mel(cfg.mel_high, cfg.mel_scale),
        cfg.n_mels + 2,
    )
    if cfg.mel_variant == "tf_continuous" and cfg.vtln_warp != 1.0:
        vhigh = cfg.vtln_high_hz
        if vhigh <= 0:
            vhigh += cfg.sample_rate / 2.0
        return vtln_warp_freq(
            mel_to_hz(edges_mel[1:-1], cfg.mel_scale),
            cfg.vtln_low_hz, vhigh, cfg.mel_low_hz, cfg.mel_high,
            cfg.vtln_warp,
        )
    return mel_to_hz(edges_mel[1:-1], cfg.mel_scale)


def equal_loudness(center_hz: np.ndarray) -> np.ndarray:
    """Hermansky's equal-loudness approximation (the HTK/Kaldi form):
    E(f) = (f²/(f²+1.6e5))² · (f²+1.44e6)/(f²+9.61e6) — ~40 dB attenuation
    at low frequencies, peak sensitivity around 3–4 kHz."""
    fsq = np.asarray(center_hz, dtype=np.float64) ** 2
    fsub = fsq / (fsq + 1.6e5)
    return fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))


def idft_bases(lpc_order: int, n_mels: int) -> np.ndarray:
    """[lpc_order+1, n_mels+2] inverse-DFT bases mapping the (first/last-
    duplicated) compressed mel spectrum to autocorrelation coefficients.

    The duplicated M+2 points sample half a period of an even spectrum on
    the grid ω_j = πj/(M+1), j = 0..M+1; the autocorrelation is its
    inverse cosine transform with endpoint weights ½ (trapezoid closure of
    the even symmetric extension):
      r[i] = 1/(2(M+1)) · [x₀ + 2·Σ_{j=1..M} x_j cos(πij/(M+1))
                           + x_{M+1}·cos(πi)]
    Certified against a length-2(M+1) numpy irfft in tests/test_plp.py."""
    d = n_mels + 2
    angle = np.pi / (d - 1)
    scale = 1.0 / (2.0 * (d - 1))
    i = np.arange(lpc_order + 1, dtype=np.float64)[:, None]
    j = np.arange(d, dtype=np.float64)[None, :]
    mat = 2.0 * scale * np.cos(angle * i * j)
    mat[:, 0] = scale
    mat[:, d - 1] = scale * np.cos(angle * i[:, 0] * (d - 1))
    return mat


# ---------------------------------------------------------------------------
# DCT-II matrix, shape [n_mels, n_ceps]
# ---------------------------------------------------------------------------


def dct_matrix(n_mels: int, n_ceps: int, norm: str) -> np.ndarray:
    """DCT-II basis D with cepstra = logmel @ D.

    D[j, n] = s_n * cos(pi * n * (2j+1) / (2M)); ortho: s_0 = sqrt(1/M),
    s_{n>0} = sqrt(2/M). HTK/TF variant scales bin 0 by an extra sqrt(2)
    (verified equivalence, SURVEY.md Appendix A).
    """
    j = np.arange(n_mels, dtype=np.float64)[:, None]
    n = np.arange(n_ceps, dtype=np.float64)[None, :]
    d = np.cos(np.pi * n * (2.0 * j + 1.0) / (2.0 * n_mels))
    scale = np.full(n_ceps, np.sqrt(2.0 / n_mels))
    scale[0] = np.sqrt(1.0 / n_mels)
    d = d * scale[None, :]
    if norm == "htk":
        d[:, 0] *= np.sqrt(2.0)
    return d


def lifter_vector(n_ceps: int, lifter: int) -> np.ndarray:
    """Sinusoidal lifter: 1 + (L/2) sin(pi n / L); ones when lifter == 0."""
    if lifter <= 0:
        return np.ones(n_ceps, dtype=np.float64)
    n = np.arange(n_ceps, dtype=np.float64)
    return 1.0 + (lifter / 2.0) * np.sin(np.pi * n / lifter)


# ---------------------------------------------------------------------------
# DFT matrices for the GEMM-native path (Pallas kernel K1): real/imag parts
# of exp(-2πi n k / K) for n < frame_length, k < n_bins. Zero-padding the
# frame to n_fft is implicit (rows n >= L would multiply zeros).
# ---------------------------------------------------------------------------


def dft_matrices(frame_length: int, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    n = np.arange(frame_length, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang), np.sin(ang)  # each [frame_length, n_bins]


def dct_augmented(cfg: FrontendConfig) -> np.ndarray:
    """[n_mels+1, n_ceps] matrix computing the finished base cepstra from
    the fused kernel's contiguous [log-mel | log-energy] lane prefix in ONE
    matmul: rows [0:n_mels) = dct * lifter (col 0 zeroed when the energy
    replaces c0), row n_mels passes the log-energy straight into c0.
    Avoids any single-lane slicing of the kernel output (~0.45 ms/step on
    v5e at batch-64 x 10 s)."""
    d = dct_matrix(cfg.n_mels, cfg.n_ceps, cfg.dct_norm) * lifter_vector(
        cfg.n_ceps, cfg.lifter
    )[None, :]
    aug = np.zeros((cfg.n_mels + 1, cfg.n_ceps), dtype=np.float64)
    aug[: cfg.n_mels] = d
    if cfg.append_energy:
        aug[: cfg.n_mels, 0] = 0.0
        aug[cfg.n_mels, 0] = 1.0
    return aug


def bf16_split(a32: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """bf16 hi/lo split of a float32 array, each part returned as the
    float32 array of its bf16 values: hi = bf16(a) and lo = bf16(a - hi),
    both rounded to nearest even (the port of
    `mfcc_tpu/kernels/frontend.py::_bf16_split_np`)."""
    a = torch.from_numpy(np.ascontiguousarray(a32, dtype=np.float32))
    hi = a.to(torch.bfloat16).float()
    lo = (a - hi).to(torch.bfloat16).float()
    return hi.numpy(), lo.numpy()


@functools.lru_cache(maxsize=32)
def folded_dft(cfg: FrontendConfig) -> dict[str, np.ndarray]:
    """The window-folded, scaled real DFT of the bf16x3 route (the DFT part
    of `mfcc_tpu/kernels/frontend.py::kernel_constants`): "dft" [Le, 2·n_bins]
    float32 with Le = min(frame_length, n_fft) (rfft truncates longer
    frames), columns [0, n_bins) w[n]·cos(2πnk/N)·s and [n_bins, 2·n_bins)
    w[n]·sin(-2πnk/N)·s, s = 1/√N when the power is scaled by 1/N, folded in
    float64 and rounded once; "dft_hi" / "dft_lo" its `bf16_split`."""
    Le = min(cfg.frame_length, cfg.n_fft)
    w = window_vector(cfg.window, cfg.frame_length)[:Le]
    n = np.arange(Le, dtype=np.float64)[:, None]
    k = np.arange(cfg.n_bins, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / cfg.n_fft
    scale = (1.0 / np.sqrt(cfg.n_fft)) if cfg.power_scale_nfft else 1.0
    dft = np.concatenate(
        [w[:, None] * np.cos(ang) * scale, w[:, None] * np.sin(ang) * scale], axis=1
    ).astype(np.float32)
    hi, lo = bf16_split(dft)
    return {"dft": dft, "dft_hi": hi, "dft_lo": lo}


@functools.lru_cache(maxsize=32)
def chain_constants(cfg: FrontendConfig) -> dict[str, np.ndarray]:
    """All per-config constants, float64, cached by config hash."""
    return {
        "window": window_vector(cfg.window, cfg.frame_length),
        "mel": mel_filterbank(cfg),
        "dct": dct_matrix(cfg.n_mels, cfg.n_ceps, cfg.dct_norm),
        "lifter": lifter_vector(cfg.n_ceps, cfg.lifter),
        "dct_aug": dct_augmented(cfg),
        # SSC frequency grid — the psf lineage's linspace(1, sr/2, bins)
        # (compat.ssc); only features="ssc" consumes it
        "freqs": np.linspace(1.0, cfg.sample_rate / 2.0, cfg.n_bins),
        **(
            {
                "equal_loudness": equal_loudness(mel_center_freqs(cfg)),
                "idft": idft_bases(cfg.lpc_order, cfg.n_mels),
            }
            if cfg.features == "plp"
            else {}
        ),
    }


def to_torch(
    host: dict[str, np.ndarray], device, dtype: torch.dtype
) -> dict[str, torch.Tensor]:
    """Carry float64 host constants (this module's `chain_constants`, or the
    JAX package's — the same numpy arrays) onto `device`, cast once to
    `dtype`."""
    return {
        k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
        for k, v in host.items()
    }
