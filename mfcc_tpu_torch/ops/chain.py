"""The torch feature chain — the port of `mfcc_tpu/ops/chain.py` for every
named config: the classic13 family (standard "pad" framing, signal
pre-emphasis, power-spectrum energy), logmel80 (the `ln_stab` log), the
Kaldi feature-window family (kaldi_mfcc, kaldi_fbank, kaldi_plp,
kaldi_spectrogram: "drop" framing, frame-first conditioning, `ln_floor`),
spectral subband centroids (ssc26) and whisper80 (centered framing with edge
reflection, a 400-point FFT, `log10_floor`, `drop_last_frame` and the
Whisper norm), with or without dither, at 16 kHz or resampled from another
input rate (mfcc39_48k, mfcc39_44k). PLP (`plp_base`: equal loudness,
cube-root compression, autocorrelation, Levinson-Durbin, LPC cepstra) is
tensor code on both devices, after the front-end's raw mel lanes.

Batch layout is `audio[B, T]` + `lengths[B]`, as in the JAX package: frames
are derived with a static frame count `F = cfg.num_frames(T)` and a
per-utterance valid frame count, so padding never changes the numbers on
valid frames. Signal-level steps (dither, then pre-emphasis in "signal"
mode) run on the raw signal, which is then zeroed beyond each utterance's
length; centered framing reflects that signal at each utterance's own
length; frame-level conditioning (DC removal, raw-frame energy, frame
pre-emphasis, windowed-frame energy) follows framing, in Kaldi's order.

`extract_batch` runs on the card by default, through
`kernels/frontend.py::fused_logmel_stages`. There the front-end (dither
and framing through log-mel and energy) is one hand-written CUDA kernel
(`mfcc_tpu_torch/kernels/frontend.py`); for resampling configs the same
kernel resamples the input rows as it stages them, or, for centered
framing and for fused layouts over the block (`frontend.resample_route`),
the polyphase kernel resamples them first and the front-end frames its
rows. For mfcc configs a second
kernel (`kernels/tail.py`) turns its [log-mel | energy] prefix into the
finished features (DCT, Δ/ΔΔ, mask, utterance CMVN); the other families feed
the prefix to `features_from_logmel`'s prefix path (lanes [0, M) are the
log-mel, the raw mel energies for PLP, the log power spectrum for a
spectrogram or the centroids for SSC). With `device="cpu"` it runs the
plain chain of this module (`resample_input`, then `logmel_stages`: the
kernels' plain versions). A config outside the port raises on both devices,
naming what it still needs. Torch matmuls on the card run in full fp32
(`matmul_fp32`), which leaves the caller's TF32 setting as it was.

`extract_batch_diff` is the training path: `extract_batch`'s forward (the
kernels on the card) with the plain chain's VJP as its backward.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from mfcc_tpu_torch.config import FrontendConfig
from mfcc_tpu_torch.ops import constants as C
from mfcc_tpu_torch.ops import dither, resample

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def compute_dtype(cfg: FrontendConfig) -> torch.dtype:
    try:
        return _DTYPES[cfg.dtype]
    except KeyError:
        raise NotImplementedError(
            f"dtype={cfg.dtype!r}: the torch chain computes in {sorted(_DTYPES)}"
        ) from None


@functools.lru_cache(maxsize=64)
def device_constants(
    cfg: FrontendConfig, device: torch.device, dtype: torch.dtype
) -> dict[str, torch.Tensor]:
    """Chain constants cast once from host float64 to `dtype` on `device`."""
    return C.to_torch(C.chain_constants(cfg), device, dtype)


def resamples(cfg: FrontendConfig) -> bool:
    """True when cfg's input rate differs from its feature rate."""
    return bool(cfg.input_sample_rate and cfg.input_sample_rate != cfg.sample_rate)


LOG_KINDS = ("ln", "ln_stab", "db", "ln_floor", "log10_floor")  # the kernel's epilogue branches
DFT_PASSES = ("radix4", "bf16x3", "fp32")  # the reference's dft_passes routes
CENTER_KINDS = ("center", "center_reflect")  # frame_tail modes with edge reflection


def needs_conditioning(cfg: FrontendConfig) -> bool:
    """True when cfg asks for frame-first conditioning (Kaldi's
    feature-window order): per-frame DC removal, per-frame pre-emphasis,
    or a time-domain frame energy."""
    return (
        cfg.remove_dc_offset
        or cfg.preemph_mode == "frame"
        or cfg.energy_source != "pspec"
    )


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for the chain's products. A float32 product, on any device, is
    computed in float64 and rounded back:
    - on the card, whatever the caller's TF32 setting: neither TF32 nor the
      process-wide float32 matmul precision applies and no global state is
      read or written (a training thread beside an extracting one keeps its
      setting). TF32 keeps ~3 decimal digits, too few for the 5e-4 cepstra
      gate;
    - on the CPU, a row's result does not depend on where it sits in the
      batch: multi-threaded float32 sgemm splits its work by the batch's
      shape and gives a row ulps apart from the same row alone, while the
      float64 sums (exact products of float32 inputs) round back to the
      same float32.
    Other products are plain matmuls."""
    if a.dtype == torch.float32:
        return torch.matmul(a.double(), b.double()).float()
    return torch.matmul(a, b)


def centered(cfg: FrontendConfig) -> bool:
    """True when cfg frames centered windows with edge reflection."""
    return cfg.frame_tail in CENTER_KINDS


def unsupported_reason(cfg: FrontendConfig) -> str | None:
    """None when the port implements `cfg` on its default DFT route;
    otherwise what it still needs, with its ROADMAP queue-2 item (item 4): a
    front-end layout over the block's shared memory in every plan
    (`frontend.layout_reason`). No config the reference takes gives one: the
    front-end's last plan ("gather_sums") keeps the frames, the FFT tables,
    the packed mel bands, the FFT rows and the projection's sums in device
    memory, staging only the thread partials, whatever the n_fft, hop, frame
    length and filter count; the feature tail takes every cepstra count and
    delta window (`tail.plan`). The bf16x3 opt-in's last plan stages the
    matrix ring and one pass's rows alone (`frontend.bf16_layout`); its card
    wrapper refuses only a matrix over the card's memory
    (`frontend.bf16_matrix_reason`). A resampling config is held to the
    plain form's layout at its feature rate: centered framing of resampled
    rows and fused layouts over the block take the split route
    (`frontend.resample_route`), resample.cu and then the plain form."""
    from mfcc_tpu_torch.kernels import frontend  # the kernel's layout mirror

    reason = frontend.layout_reason(cfg)
    if reason:
        return f"{reason} (ROADMAP queue 2 item 4)"
    return None


def check_supported(cfg: FrontendConfig) -> None:
    reason = unsupported_reason(cfg)
    if reason:
        raise NotImplementedError(
            f"config {cfg.config_hash()} needs the {reason}, which the "
            "port does not have yet"
        )


# ---------------------------------------------------------------------------
# Stages — all operate on [B, T] / [B, F, X]
# ---------------------------------------------------------------------------


def num_valid_frames(lengths: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Per-utterance valid frame count: 1 + ceil(max(0, n - L) / S) under
    "pad" framing, 1 + (n - L) // S for n >= L (else 0) under "drop",
    (n + S//2) // S under "center", 1 + (n + 2(L//2) - L) // S under
    "center_reflect"; one fewer with drop_last_frame; length 0 counts 0
    frames (a zero-length row is batch padding)."""
    L, S = cfg.frame_length, cfg.frame_step
    if cfg.frame_tail == "pad":
        a = torch.clamp(lengths - L, min=0)
        n = 1 + (a + S - 1) // S
    elif cfg.frame_tail == "center":
        n = (lengths + S // 2) // S
    elif cfg.frame_tail == "center_reflect":
        n = 1 + (lengths + 2 * (L // 2) - L) // S
    else:
        n = torch.where(lengths >= L, 1 + (lengths - L) // S, 0)
    if cfg.drop_last_frame:
        n = torch.clamp(n - 1, min=0)
    return torch.where(lengths > 0, n, torch.zeros_like(n))


def frame_mask(n_valid: torch.Tensor, num_frames: int, dtype) -> torch.Tensor:
    t = torch.arange(num_frames, device=n_valid.device)
    return (t[None, :] < n_valid[:, None]).to(dtype)


def preemphasis(x: torch.Tensor, coeff: float) -> torch.Tensor:
    """y[0] = x[0]; y[t] = x[t] - coeff * x[t-1], along the last axis."""
    if coeff == 0.0:
        return x
    return torch.cat([x[..., :1], x[..., 1:] - coeff * x[..., :-1]], dim=-1)


def zero_beyond(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero samples at t >= length."""
    t = torch.arange(x.shape[-1], device=x.device)
    return x * (t[None, :] < lengths[:, None]).to(x.dtype)


def frame_signal(x: torch.Tensor, num_frames: int, cfg: FrontendConfig) -> torch.Tensor:
    """frames[..., f, n] = x[..., f*S + n] as a strided view; x must hold
    (num_frames-1)*S + L samples."""
    return x.unfold(-1, cfg.frame_length, cfg.frame_step)[..., :num_frames, :]


def frame_offset(cfg: FrontendConfig) -> int:
    """Start of frame 0 relative to sample 0: S//2 - L//2 ("center", Kaldi
    snip_edges=false), -(L//2) ("center_reflect", torch.stft center=True),
    0 otherwise."""
    L, S = cfg.frame_length, cfg.frame_step
    if cfg.frame_tail == "center":
        return S // 2 - L // 2
    if cfg.frame_tail == "center_reflect":
        return -(L // 2)
    return 0


def reflect_index(idx: torch.Tensor, n: torch.Tensor, kind: str) -> torch.Tensor:
    """Edge-reflection index map into [0, n); n broadcasts against idx and
    is >= 1. "center" (Kaldi snip_edges=false) repeats the edge sample
    (index -1 -> 0): period 2n. "center_reflect" (torch.stft center=True,
    pad_mode="reflect") does not (index -1 -> 1): period 2(n-1), clamped to
    1 when n = 1."""
    if kind == "center":
        m = torch.remainder(idx, 2 * n)
        return torch.where(m < n, m, 2 * n - 1 - m)
    m = torch.remainder(idx, torch.clamp(2 * n - 2, min=1))
    return torch.where(m < n, m, 2 * n - 2 - m)


def frame_signal_centered(
    x: torch.Tensor, num_frames: int, lengths: torch.Tensor, cfg: FrontendConfig
) -> torch.Tensor:
    """Centered frames [B, F, L] with per-utterance edge reflection: frame f
    covers f*S + frame_offset(cfg) + [0, L), each index mapped by
    reflect_index at the row's own length (at least 1)."""
    L, S = cfg.frame_length, cfg.frame_step
    t = torch.arange(L, device=x.device)[None, :] + S * torch.arange(
        num_frames, device=x.device)[:, None] + frame_offset(cfg)  # [F, L]
    n = torch.clamp(lengths.to(torch.int64), min=1)[:, None, None]
    r = reflect_index(t[None], n, cfg.frame_tail)  # [B, F, L]
    B = x.shape[0]
    return torch.gather(x, 1, r.reshape(B, -1)).reshape(B, num_frames, L)


def smooth_fft_size(n: int) -> bool:
    """True when n has no prime factor above 7 (the sizes cuFFT computes
    by its own radix kernels)."""
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


@functools.lru_cache(maxsize=16)
def dft_basis(frame_length: int, n_fft: int, device: torch.device) -> torch.Tensor:
    """[min(L, n_fft), 2 * n_bins] float64: cos and -sin of 2πkn/n_fft, the
    real DFT of a frame zero-padded (or truncated) to n_fft as one product."""
    n = torch.arange(min(frame_length, n_fft), dtype=torch.float64)
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float64)
    ang = (2.0 * math.pi / n_fft) * torch.remainder(n[:, None] * k[None, :], n_fft)
    return torch.cat([torch.cos(ang), -torch.sin(ang)], dim=1).to(device)


def power_spectrum(windowed: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """rfft with n=n_fft (pads/truncates), |X|^2 (optionally / NFFT).

    On a card, an n_fft with a prime factor above 7 takes the DFT as one
    float64 product with `dft_basis` instead of `torch.fft.rfft`: cuFFT's
    rfft (float32 and float64, with the implicit zero-pad or an explicit
    one) gave whole frames wrong by up to 1.7e-2 of their largest bin at
    n_fft 551 = 19·29 on a b16 x 10 s batch (tests/test_torch_gpu.py::
    test_plain_chain_at_n_fft_551_matches_the_cpu_chain)."""
    if windowed.numel() == 0:  # no frames ("drop" framing of a short batch)
        return windowed.new_zeros(windowed.shape[:-1] + (cfg.n_bins,))
    if windowed.device.type == "cuda" and not smooth_fft_size(cfg.n_fft):
        w = dft_basis(windowed.shape[-1], cfg.n_fft, windowed.device)
        reim = torch.matmul(windowed[..., : w.shape[0]].double(), w)
        re, im = reim[..., : cfg.n_bins], reim[..., cfg.n_bins :]
        p = (re * re + im * im).to(windowed.dtype)
    else:
        spec = torch.fft.rfft(windowed, n=cfg.n_fft, dim=-1)
        p = spec.real**2 + spec.imag**2
    if cfg.power_scale_nfft:
        p = p / cfg.n_fft
    return p


def apply_log(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The log kinds of the kernel's epilogue: "ln" ln(where(x <= 0, eps,
    x)), "ln_stab" ln(x + 1e-6), "db" 10·log10 of the "ln" clamp, and
    "ln_floor" ln(max(x, eps)) (Kaldi's ApplyFloor then log, which floors
    tiny positives too) and "log10_floor" log10(max(x, eps)) (librosa,
    Whisper)."""
    eps = cfg.log_eps
    if cfg.log_kind == "ln":
        return torch.log(torch.where(x <= 0, eps, x))
    if cfg.log_kind == "ln_stab":
        return torch.log(x + 1e-6)
    if cfg.log_kind == "db":
        return 10.0 * torch.log10(torch.where(x <= 0, eps, x))
    if cfg.log_kind == "ln_floor":
        return torch.log(torch.clamp(x, min=eps))
    if cfg.log_kind == "log10_floor":
        return torch.log10(torch.clamp(x, min=eps))
    raise NotImplementedError(f"log_kind={cfg.log_kind!r}")


def preemphasis_frames(frames: torch.Tensor, coeff: float) -> torch.Tensor:
    """Per-frame pre-emphasis (Kaldi ProcessWindow): along each frame,
    w[n] -= coeff * w[n-1] for n >= 1 and w[0] *= (1 - coeff)."""
    if coeff == 0.0:
        return frames
    return torch.cat(
        [frames[..., :1] * (1.0 - coeff), frames[..., 1:] - coeff * frames[..., :-1]],
        dim=-1,
    )


def _tail_replicated(feat: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Copy row n_valid-1 into every row t >= n_valid."""
    idx = torch.clamp(n_valid - 1, min=0).long()
    idx = idx[:, None, None].expand(feat.shape[0], 1, feat.shape[-1])
    last = torch.gather(feat, -2, idx)  # [B, 1, D]
    t = torch.arange(feat.shape[-2], device=feat.device)
    keep = t[None, :, None] < n_valid[:, None, None]
    return torch.where(keep, feat, last)


def delta(feat: torch.Tensor, n_valid: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Regression delta with edge replication at the *valid* boundary:
    once the tail beyond n_valid holds the last valid row, the clipped
    indices c[min(t+i, n_valid-1)] / c[max(t-i, 0)] are static shifts with
    edge replication at the array bounds."""
    N = cfg.delta_window
    F = feat.shape[-2]
    denom = 2.0 * sum(i * i for i in range(1, N + 1))
    x = _tail_replicated(feat, n_valid) if F else feat  # F = 0: "drop" framing of a short batch
    out = torch.zeros_like(x)
    for i in range(1, N + 1):
        k = min(i, F)  # utterances shorter than the window replicate fully
        plus = torch.cat([x[..., k:, :]] + [x[..., -1:, :]] * k, dim=-2)
        minus = torch.cat([x[..., :1, :]] * k + [x[..., : F - k, :]], dim=-2)
        out = out + i * (plus - minus)
    return out / denom


def cmvn_utterance(
    feat: torch.Tensor, mask: torch.Tensor, cfg: FrontendConfig
) -> torch.Tensor:
    """Masked per-utterance mean/variance norm over valid frames."""
    m = mask[..., None].to(feat.dtype)
    n = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
    mu = (feat * m).sum(dim=-2, keepdim=True) / n
    out = feat - mu
    if cfg.cmvn_var_norm:
        var = ((feat - mu) ** 2 * m).sum(dim=-2, keepdim=True) / n
        out = out / torch.sqrt(var + cfg.cmvn_eps)
    return out * m  # keep pad frames exactly zero


# ---------------------------------------------------------------------------
# PLP and SSC (frame-local, any leading batch dims)
# ---------------------------------------------------------------------------


def durbin(r: torch.Tensor, lpc_order: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Levinson-Durbin: autocorrelations r [..., P+1] → (a [..., P],
    residual energy E [...]). One tensor op per order step: the inner sums
    are a dot with the flipped slice of r, the update a flip of a. Guarded
    division makes all-zero rows (padding frames) give a = 0, E = 0."""
    a = r[..., :0]
    e = r[..., 0]
    for i in range(lpc_order):
        acc = r[..., i + 1] - (a * r[..., 1 : i + 1].flip(-1)).sum(-1)
        k = torch.where(e != 0, acc / torch.where(e == 0, 1.0, e), 0.0)
        a = torch.cat([a - k[..., None] * a.flip(-1), k[..., None]], dim=-1)
        e = e * (1.0 - k * k)
    return a, e


def lpc_to_cepstrum(a: torch.Tensor) -> torch.Tensor:
    """c_n = a_n + Σ_{k<n} (k/n)·c_k·a_{n-k} (cepstra of 1/A(z)), one dot
    per n."""
    c = a[..., :0]
    for n in range(1, a.shape[-1] + 1):
        w = torch.arange(1, n, dtype=a.dtype, device=a.device) / n
        acc = a[..., n - 1] + (w * c * a[..., : n - 1].flip(-1)).sum(-1)
        c = torch.cat([c, acc[..., None]], dim=-1)
    return c


def plp_base(
    melspec: torch.Tensor,
    energy: torch.Tensor,
    cfg: FrontendConfig,
    consts: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """PLP cepstra from raw mel energies [..., M] and the clamped frame
    energy [...] (Kaldi compute-plp-feats order): equal loudness, the
    compress_factor power law, first/last-bin duplication, IDFT to
    autocorrelation, Levinson-Durbin, LPC cepstra; c0 = ln of the residual
    energy, lifter, then c0 ← ln(frame energy) when cfg appends it."""
    k = consts if consts is not None else device_constants(cfg, melspec.device, melspec.dtype)
    mel = torch.clamp(melspec, min=0.0) * k["equal_loudness"]
    if mel.requires_grad:
        # x**c at x = 0 is 0, but its derivative is infinite there, and a
        # pad frame's zero upstream gradient times it is NaN: under autograd
        # the power takes 1 in place of 0 and the 0 is put back (the same
        # values; extraction keeps the one power op)
        live = mel > 0
        mel = torch.where(live, torch.where(live, mel, 1.0) ** cfg.compress_factor, 0.0)
    else:
        mel = mel**cfg.compress_factor
    dup = torch.cat([mel[..., :1], mel, mel[..., -1:]], dim=-1)
    r = matmul_fp32(dup, k["idft"].T)
    a, e = durbin(r, cfg.lpc_order)
    c = lpc_to_cepstrum(a)
    c0 = torch.log(torch.clamp(e, min=cfg.log_eps))
    base = torch.cat([c0[..., None], c[..., : cfg.n_ceps - 1]], dim=-1) * k["lifter"]
    if cfg.append_energy:
        log_e = torch.log(energy)
        if cfg.energy_floor > 0.0:
            log_e = torch.clamp(log_e, min=math.log(cfg.energy_floor))
        base = torch.cat([log_e[..., None], base[..., 1:]], dim=-1)
    return base


def ssc_centroids(
    pspec: torch.Tensor, cfg: FrontendConfig, consts: dict[str, torch.Tensor] | None = None
) -> torch.Tensor:
    """Spectral subband centroids [..., M]: the power clamped per bin,
    where(p <= 0, eps, p), then Σ p·f·mel / Σ p·mel per filter."""
    k = consts if consts is not None else device_constants(cfg, pspec.device, pspec.dtype)
    p = torch.where(pspec <= 0, cfg.log_eps, pspec)
    return matmul_fp32(p * k["freqs"], k["mel"]) / matmul_fp32(p, k["mel"])


def resample_input(
    audio: torch.Tensor, lengths: torch.Tensor, cfg: FrontendConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows [B, T_in] at cfg.input_sample_rate + lengths in input samples →
    (rows [B, output_length(T_in)] at cfg.sample_rate in the compute dtype,
    lengths in output samples), by the plain resample. Input past each
    length is zeroed first, so the result never depends on the padding."""
    sr_in, sr = cfg.input_sample_rate, cfg.sample_rate
    x = zero_beyond(audio.to(compute_dtype(cfg)), lengths)
    return (
        resample.resample_reference(x, sr_in, sr),
        resample.output_lengths(lengths, sr_in, sr),
    )


# ---------------------------------------------------------------------------
# Full batched chain
# ---------------------------------------------------------------------------


def bf16x3_power(frames: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The power spectrum [..., n_bins] of the conditioned, unwindowed
    frames [..., L] by the bf16x3 route (port of `mfcc_tpu/kernels/
    frontend.py` :857-867): the frames' first min(L, n_fft) samples split
    into bf16 hi and lo, then hi·Wh + lo·Wh + hi·Wl against the hi/lo split
    of the window-folded, scaled DFT (`constants.folded_dft`), in fp32 (the
    products of bf16 values are exact; only the order of the sums differs
    from the kernel's tensor cores), and re² + im²."""
    k = C.folded_dft(cfg)
    x = frames[..., : k["dft"].shape[0]].to(torch.float32)
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    wh = torch.as_tensor(k["dft_hi"], device=x.device)
    wl = torch.as_tensor(k["dft_lo"], device=x.device)
    reim = matmul_fp32(hi, wh) + matmul_fp32(lo, wh) + matmul_fp32(hi, wl)
    re, im = reim[..., : cfg.n_bins], reim[..., cfg.n_bins :]
    return re * re + im * im


def logmel_stages(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    cfg: FrontendConfig,
    consts: dict[str, torch.Tensor] | None = None,
    dft_passes: str = "radix4",
) -> dict[str, torch.Tensor]:
    """Dither and pre-emphasis through log-mel on a padded batch, audio
    [B, T] (int16 or float) and lengths [B]; every intermediate plus the
    frame mask, and "dither_noise" (the [B, T] unit noise) when cfg dithers.
    The plain version of the CUDA front-end kernel. `dft_passes="bf16x3"`
    takes the power spectrum by `bf16x3_power` (float32 only); the other
    routes compute the same DFT, by torch.fft.rfft."""
    check_supported(cfg)
    if dft_passes not in DFT_PASSES:
        raise ValueError(f"dft_passes={dft_passes!r} not in {DFT_PASSES}")
    dtype = compute_dtype(cfg)
    k = consts if consts is not None else device_constants(cfg, audio.device, dtype)
    audio = audio.to(dtype)
    if cfg.input_scale != 1.0:
        audio = audio * cfg.input_scale
    F = cfg.num_frames(audio.shape[-1])
    dither_noise = None
    if cfg.dither > 0.0:
        # the signal-level contract noise, before pre-emphasis in both modes
        audio, dither_noise = dither.add_signal_dither(audio, cfg)
    if cfg.preemph_mode == "signal":
        y = zero_beyond(preemphasis(audio, cfg.preemph), lengths)
    else:  # frame-first conditioning (Kaldi order): frame the raw signal
        y = zero_beyond(audio, lengths)
    if centered(cfg):
        frames = frame_signal_centered(y, F, lengths, cfg)  # [B, F, L]
    else:
        span = max(F - 1, 0) * cfg.frame_step + cfg.frame_length
        if span > y.shape[-1]:
            y = torch.nn.functional.pad(y, (0, span - y.shape[-1]))
        frames = frame_signal(y, F, cfg)  # [B, F, L]
    out = frame_stages(frames, cfg, k, dft_passes)
    n_valid = num_valid_frames(lengths, cfg)
    out["n_valid"] = n_valid
    out["frame_mask"] = frame_mask(n_valid, F, dtype)
    if dither_noise is not None:
        out["dither_noise"] = dither_noise  # for replay through the oracle
    return out


def frame_stages(
    frames: torch.Tensor,
    cfg: FrontendConfig,
    k: dict[str, torch.Tensor],
    dft_passes: str = "radix4",
) -> dict[str, torch.Tensor]:
    """The frame-level stages of `logmel_stages` on frames [..., F, L] (cut
    from the pre-emphasized, zeroed signal): the conditioning (DC removal,
    raw-frame energy, frame pre-emphasis), window, power spectrum, energy,
    mel and log; k holds the chain constants."""
    eps = cfg.log_eps
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.energy_source == "raw_frame":  # before pre-emphasis and window (Kaldi)
        energy = torch.clamp((frames * frames).sum(dim=-1), min=eps)
    if cfg.preemph_mode == "frame":
        frames = preemphasis_frames(frames, cfg.preemph)
    windowed = frames * k["window"]
    if dft_passes == "bf16x3":
        if frames.dtype != torch.float32:
            raise NotImplementedError(f"the bf16x3 route computes in float32, not {cfg.dtype}")
        pspec = bf16x3_power(frames, cfg)  # the window rides the matrix
    else:
        pspec = power_spectrum(windowed, cfg)  # [B, F, n_bins]
    if cfg.energy_source == "pspec":
        energy = pspec.sum(dim=-1)
        energy = torch.where(energy <= 0, eps, energy)
    elif cfg.energy_source == "windowed_frame":
        energy = torch.clamp((windowed * windowed).sum(dim=-1), min=eps)
    melspec = matmul_fp32(pspec, k["mel"])
    return {
        "frames": frames,
        "windowed": windowed,
        "pspec": pspec,
        "energy": energy,
        "melspec": melspec,
        "logmel": apply_log(melspec, cfg),
    }


def logmel_norm(base: torch.Tensor, mask: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """cfg.logmel_norm on log-mel features [B, F, M]: "whisper" clamps each
    utterance at its max over VALID frames (mask [B, F]) less 8 log10
    units, then (x + 4) / 4; an all-pad row's max is -1e30, harmless under
    the clamp. "none" returns base, as does a batch with no frames."""
    if cfg.logmel_norm != "whisper" or base.shape[-2] == 0:
        return base
    valid = mask[..., None] > 0
    mx = torch.where(valid, base, -1e30).amax(dim=(-2, -1), keepdim=True)
    return (torch.maximum(base, mx - 8.0) + 4.0) / 4.0


def base_from_prefix(
    x: torch.Tensor,
    mask: torch.Tensor,
    cfg: FrontendConfig,
    consts: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """The base features (before deltas and the mask) from the kernel's
    [..., F, n_mels+1] prefix: the log-mel (its Whisper norm over the valid
    frames of mask), the centroids, PLP cepstra (`plp_base`), the log
    spectrogram with the log energy in lane 0, or for mfcc the augmented
    DCT·lifter·c0 product on [log-mel | log energy]."""
    M = cfg.n_mels
    if cfg.features == "logmel":
        return logmel_norm(x[..., :M], mask, cfg)
    if cfg.features == "ssc":
        return x[..., :M]
    if cfg.features == "plp":
        return plp_base(x[..., :M], x[..., M], cfg, consts)
    if cfg.features == "spectrogram":
        base = x[..., :M]
        if cfg.append_energy:
            e = x[..., M:]
            log_e = torch.log(torch.where(e <= 0, cfg.log_eps, e))
            if cfg.energy_floor > 0.0:
                log_e = torch.clamp(log_e, min=math.log(cfg.energy_floor))
            base = torch.cat([log_e, base[..., 1:]], dim=-1)
        return base
    k = consts if consts is not None else device_constants(cfg, x.device, x.dtype)
    if cfg.append_energy:
        e = x[..., M:]
        log_e = torch.log(torch.where(e <= 0, cfg.log_eps, e))
        if cfg.energy_floor > 0.0:
            log_e = torch.clamp(log_e, min=math.log(cfg.energy_floor))
        x = torch.cat([x[..., :M], log_e], dim=-1)
    return matmul_fp32(x, k["dct_aug"])


def features_from_logmel(
    stages: dict[str, torch.Tensor],
    cfg: FrontendConfig,
    consts: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Cepstra, lifter, energy, the Whisper norm of log-mel features,
    deltas and per-utterance CMVN (global CMVN is corpus-level and not
    applied here). Returns [B, F, feat_dim] with pad frames zeroed.

    When the stage dict carries "features_fused" (the feature-tail
    kernel's finished features, `kernels/tail.py`) it returns them as they
    are. When it carries "prefix" (the kernel's [B, F, n_mels+1]
    output: [log-mel | clamped energy]; [raw mel | energy] for PLP, [log
    pspec | energy] for a spectrogram, [centroids | 0] for SSC) the mfcc
    epilogue is ONE augmented DCT·lifter·c0 matmul on it; otherwise it
    starts from the plain chain's stages."""
    if "features_fused" in stages:
        return stages["features_fused"]
    n_valid = stages["n_valid"]
    mask = stages["frame_mask"]
    if "prefix" in stages:
        base = base_from_prefix(stages["prefix"], mask, cfg, consts)
    elif cfg.features == "logmel":
        base = logmel_norm(stages["logmel"], mask, cfg)
    elif cfg.features == "spectrogram":  # logmel is the log pspec (mel == identity)
        base = stages["logmel"]
        if cfg.append_energy:
            log_e = torch.log(stages["energy"])
            if cfg.energy_floor > 0.0:
                log_e = torch.clamp(log_e, min=math.log(cfg.energy_floor))
            base = torch.cat([log_e[..., None], base[..., 1:]], dim=-1)
    elif cfg.features == "plp":
        base = plp_base(stages["melspec"], stages["energy"], cfg, consts)
    elif cfg.features == "ssc":
        base = ssc_centroids(stages["pspec"], cfg, consts)
    else:
        logmel, energy = stages["logmel"], stages["energy"]
        k = consts if consts is not None else device_constants(cfg, logmel.device, logmel.dtype)
        base = matmul_fp32(logmel, k["dct"]) * k["lifter"]
        if cfg.append_energy:
            log_e = torch.log(energy)
            if cfg.energy_floor > 0.0:
                log_e = torch.clamp(log_e, min=math.log(cfg.energy_floor))
            base = torch.cat([log_e[..., None], base[..., 1:]], dim=-1)

    parts = [base]
    if cfg.deltas >= 1:
        d = delta(base, n_valid, cfg)
        parts.append(d)
        if cfg.deltas >= 2:
            parts.append(delta(d, n_valid, cfg))
    feat = torch.cat(parts, dim=-1) if len(parts) > 1 else base

    if cfg.cmvn == "utterance":
        return cmvn_utterance(feat, mask, cfg)
    return feat * mask[..., None]


def extract_batch(
    audio,
    lengths,
    cfg: FrontendConfig,
    device="cuda",
    consts: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded audio [B, T] (int16 or float; numpy or torch) + lengths [B] →
    (features [B, F, feat_dim], frame_mask [B, F]) on `device`, with
    F = cfg.num_frames(T). For resampling configs audio and lengths are at
    cfg.input_sample_rate and F = cfg.num_frames(output_length(T)).

    On "cuda" the front-end is the CUDA kernel, and for mfcc configs the
    cepstral tail (DCT, Δ/ΔΔ, mask, utterance CMVN) is the feature-tail
    kernel (`kernels/tail.py`); the other families finish in torch. "cpu"
    runs the plain chain. Global CMVN (cfg.cmvn == "global") is a corpus-level operation: features
    come back un-normalized in that mode. `consts` overrides the chain
    constants (a `constants.to_torch` dict on `device`)."""
    check_supported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: extract_batch runs on the card by default; pass "
            "device='cpu' for the plain chain"
        )
    audio = torch.as_tensor(audio, device=device)
    lengths = torch.as_tensor(lengths, device=device).to(torch.int32)
    if audio.dim() == 3:
        raise ValueError(
            f"3-D audio {tuple(audio.shape)}: the port takes flat rows [B, T] "
            "(the JAX package's slab and blocked feeds are TPU layouts)"
        )
    if audio.dim() != 2 or lengths.shape != audio.shape[:1]:
        raise ValueError(
            f"expected audio [B, T] and lengths [B], got {tuple(audio.shape)} "
            f"and {tuple(lengths.shape)}"
        )
    if device.type != "cuda":
        return plain_chain(audio, lengths, cfg, consts)

    from mfcc_tpu_torch.kernels import frontend

    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype={cfg.dtype!r}: the CUDA front-end computes in float32; "
            "pass device='cpu' for the plain chain"
        )
    # consts=None lets the wrappers use their per-(cfg, device) cached tables
    stages = frontend.fused_logmel_stages(audio, lengths, cfg, feature_tail=True, consts=consts)
    k = consts if consts is not None else device_constants(cfg, device, torch.float32)
    return features_from_logmel(stages, cfg, k), stages["frame_mask"]


def plain_chain(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    cfg: FrontendConfig,
    consts: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain chain on audio's own device: `resample_input` for a
    resampling config, then `logmel_stages` and `features_from_logmel` →
    (features, frame_mask). What `extract_batch` runs off the card, and the
    function whose gradient `extract_batch_diff` takes on every device: it
    is torch code throughout (the plain resample, never the polyphase
    kernel), so autograd differentiates it."""
    if resamples(cfg):
        audio, lengths = resample_input(audio, lengths, cfg)
    stages = logmel_stages(audio, lengths, cfg, consts)
    return features_from_logmel(stages, cfg, consts), stages["frame_mask"]


class _ExtractBatchDiff(torch.autograd.Function):
    """Forward: `extract_batch` on audio's device (the kernels on the card).
    Backward: the VJP of `plain_chain`, recomputed at the saved inputs —
    the reference's `_ebd_fwd` / `_ebd_bwd` (`mfcc_tpu/ops/chain.py:825-842`):
    the kernels have no backward, so the gradient is the plain chain's,
    which agrees with the kernels' forward within the features' gates."""

    @staticmethod
    def forward(ctx, audio, lengths, cfg):
        feat, mask = extract_batch(audio, lengths, cfg, device=audio.device)
        ctx.save_for_backward(audio, lengths)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(mask)
        return feat, mask

    @staticmethod
    def backward(ctx, d_feat, _d_mask):
        audio, lengths = ctx.saved_tensors
        with torch.enable_grad():
            a = audio.detach().requires_grad_(True)
            feat, _ = plain_chain(a, lengths, ctx.cfg)
            (d_audio,) = torch.autograd.grad(feat, a, d_feat)
        return d_audio, None, None


def extract_batch_diff(audio, lengths, cfg: FrontendConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """`extract_batch` that autograd differentiates (the trainable-front-end
    case): flat float audio [B, T] + lengths [B] → (features, frame_mask)
    on audio's device. A tensor stays where it is (on the card the kernels,
    on the CPU the plain chain); other input (numpy, lists) goes to the
    card, as `extract_batch`'s default, and raises RuntimeError without
    one. The forward is `extract_batch`'s, bit for bit; the backward is
    the VJP of the plain chain (`plain_chain`) at the same inputs, run on
    the same device (on the card its products in float64, `matmul_fp32`).
    The mask depends only on lengths and carries no gradient; lengths get
    none. int16 PCM and 3-D input raise ValueError."""
    host_array = not isinstance(audio, torch.Tensor)
    audio = torch.as_tensor(audio)
    if not audio.dtype.is_floating_point or audio.dim() != 2:
        raise ValueError(
            "extract_batch_diff takes flat float audio [B, T]; decode/convert "
            "first (gradients of int PCM or slab layouts are not meaningful), "
            f"got {audio.dtype} {tuple(audio.shape)}"
        )
    if host_array:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: extract_batch_diff takes host arrays to the "
                "card; pass a CPU tensor for the plain chain"
            )
        audio = audio.to("cuda")
    lengths = torch.as_tensor(lengths, device=audio.device).to(torch.int32)
    return _ExtractBatchDiff.apply(audio, lengths, cfg)


# ---------------------------------------------------------------------------
# Single-utterance convenience (golden tests, one-shot extraction)
# ---------------------------------------------------------------------------


def _single(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def valid_length(n: int, cfg: FrontendConfig) -> int:
    """Samples at cfg.sample_rate that n input samples give."""
    if resamples(cfg):
        return resample.output_length(n, cfg.input_sample_rate, cfg.sample_rate)
    return n


def extract_single(x, cfg: FrontendConfig, device="cuda") -> torch.Tensor:
    """One utterance (int16 or float, at cfg.input_sample_rate when it is
    set) → [F_valid, feat_dim] features on `device` (the oracle layout).
    int16 samples reach the kernel as int16; other types are cast to the
    compute dtype."""
    x = _single(x)
    if x.dtype != torch.int16:
        x = x.to(compute_dtype(cfg))
    n = int(x.shape[0])
    feat, _ = extract_batch(x[None, :], [n], cfg, device=device)
    return feat[0, : cfg.num_frames(valid_length(n, cfg))]


def logmel_single(x, cfg: FrontendConfig, device="cuda") -> dict[str, torch.Tensor]:
    """One utterance → every stage of the plain chain, trimmed to its valid
    frames. x is at cfg.input_sample_rate when it is set, and is resampled
    first by `resample.resample_batch` (the polyphase kernel on the card)."""
    x = _single(x).to(device=device, dtype=compute_dtype(cfg))
    if resamples(cfg):
        x = resample.resample_batch(x, cfg.input_sample_rate, cfg.sample_rate)
    n = int(x.shape[0])
    lengths = torch.tensor([n], dtype=torch.int32, device=x.device)
    stages = logmel_stages(x[None, :], lengths, cfg)
    f_valid = cfg.num_frames(n)
    return {
        k: v[0, :f_valid] if v.dim() >= 2 else v[0] for k, v in stages.items()
    }
