"""The dither noise contract — the port of `mfcc_tpu/ops/dither.py`:
counter-based gaussian noise shared by the float64 oracle, the plain chain
and the front-end kernel's dither branch (`kernels/csrc/frontend.cu`):

    noise[t] = BoxMuller16(fmix32(fmix32((t // S) * GOLDEN ^ fmix32(seed)) + t % S))

with S = cfg.frame_step. The SIGNAL is dithered, once per absolute sample
position t, before pre-emphasis, DC removal and framing, in both
pre-emphasis modes (Kaldi's ProcessWindow order: dither, DC removal,
pre-emphasis). The noise has no batch term, so an utterance gets the same
noise at any row of any batch; vary cfg.dither_seed for another draw.

  * fmix32 is the murmur3 finalizer. torch on the CPU has no uint32 `>>`
    or `+`, so the torch version hashes in int64 masked to 32 bits, with
    each 32 × 32-bit product split in 16-bit halves so that no int64
    product overflows: bit-identical to uint32 arithmetic on any device.
    `_fmix32_int` premixes the seed on the host (the kernel takes it as
    an unsigned int).
  * BoxMuller16 splits the 32 hash bits into two midpoint-offset 16-bit
    uniforms u = (k + 0.5) / 65536 in (0, 1) — exact in float32 — and
    returns sqrt(-2 ln u1) · cos(2π u2), with cos(2π u) the
    exact-arithmetic polynomial `_cos2pi` (every op rounds once, in the
    reference's Horner order). Only sqrt(-2 ln u1) may differ between
    implementations (torch, numpy, XLA, the kernel's logf and sqrtf), by
    ulps.

`_fmix32_np`, `_cos2pi_np` and `signal_noise_np` are the numpy twins,
copied because the port imports nothing of `mfcc_tpu`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_GOLDEN = 0x9E3779B9  # 2^32 / phi, the Weyl increment
_M1 = 0x85EBCA6B  # murmur3 fmix32 constants
_M2 = 0xC2B2AE35
_MASK = 0xFFFFFFFF

# cos(2 pi b) Taylor coefficients in t = b^2, b in [0, 1/4], rounded once to
# float32 (the k = 7 tail is <= (pi/2)^14 / 14! ~ 6.3e-9, below f32 rounding)
_C2PI = [
    float((-1) ** k * (2.0 * np.pi) ** (2 * k) / math.factorial(2 * k))
    for k in range(7)
]
_C2PI_F32 = [float(np.float32(c)) for c in _C2PI]


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32): the high half of m
    contributes only its low 16 product bits, so no product passes 2^48."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _fmix32_int(x: int) -> int:
    """Host-side fmix32 of a Python int: premixes the seed, so it enters
    the row key nonlinearly (seeds GOLDEN apart do not give the same field
    shifted by a row)."""
    x &= _MASK
    x ^= x >> 16
    x = (x * _M1) & _MASK
    x ^= x >> 13
    x = (x * _M2) & _MASK
    x ^= x >> 16
    return x


def _cos2pi(u: torch.Tensor) -> torch.Tensor:
    """cos(2π u) for float32 u in [0, 1) from exact float ops only (floor,
    abs, select, one rounding per multiply and add): a = u - round(u) in
    [-1/2, 1/2); for |a| > 1/4, cos(2π a) = -cos(2π (1/2 - |a|)); then the
    degree-6 polynomial in b² for b in [0, 1/4]."""
    a = u - torch.floor(u + 0.5)
    aa = torch.abs(a)
    flip = aa > 0.25
    b = torch.where(flip, 0.5 - aa, aa)
    t = b * b
    acc = torch.full_like(t, _C2PI_F32[6])
    for c in _C2PI_F32[5::-1]:
        acc = acc * t + c
    return torch.where(flip, -acc, acc)


def _u16_to_unit(k: torch.Tensor) -> torch.Tensor:
    """Midpoint-offset uniform (k + 0.5) / 65536 for k < 2^16, exact in f32."""
    return (k.to(torch.float32) + 0.5) * (1.0 / 65536.0)


def dither_field(seed: int, row_idx: torch.Tensor, lane_idx: torch.Tensor) -> torch.Tensor:
    """noise ~ N(0, 1) at sample positions t = row_idx * S + lane_idx
    (integer tensors, broadcastable; lane_idx < S). float32 of the
    broadcast shape, on the inputs' device."""
    row = row_idx.to(torch.int64) & _MASK
    kr = _fmix32(_mul32(row, _GOLDEN) ^ _fmix32_int(seed))
    h = _fmix32((kr + lane_idx.to(torch.int64)) & _MASK)
    r = torch.sqrt(-2.0 * torch.log(_u16_to_unit(h >> 16)))
    return r * _cos2pi(_u16_to_unit(h & 0xFFFF))


def signal_noise(seed: int, t_samples: int, frame_step: int, device="cpu") -> torch.Tensor:
    """The contract noise at signal positions [0, t_samples): float32
    [t_samples], computed on a [ceil(T/S), S] grid and flattened."""
    s = max(1, int(frame_step))
    rows = -(-t_samples // s)
    field = dither_field(
        seed,
        torch.arange(rows, device=device)[:, None],
        torch.arange(s, device=device)[None, :],
    )
    return field.reshape(rows * s)[:t_samples]


def add_signal_dither(audio: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """audio [..., T] + cfg.dither · noise (the contract noise, the same on
    every row). Returns (dithered audio, the [..., T] noise in audio's
    dtype); callers expose the noise for replay through the oracle."""
    field = signal_noise(cfg.dither_seed, audio.shape[-1], cfg.frame_step, audio.device)
    noise = field.to(audio.dtype).expand(audio.shape)
    return audio + cfg.dither * noise, noise


# ---------------------------------------------------------------------------
# numpy twins (the float64 oracle's default draw)
# ---------------------------------------------------------------------------


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(_M1)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(_M2)
    x = x ^ (x >> np.uint32(16))
    return x


def _cos2pi_np(u: np.ndarray) -> np.ndarray:
    """numpy twin of _cos2pi, bit-identical."""
    u = u.astype(np.float32)
    a = u - np.floor(u + np.float32(0.5))
    aa = np.abs(a)
    flip = aa > np.float32(0.25)
    b = np.where(flip, np.float32(0.5) - aa, aa).astype(np.float32)
    t = b * b
    acc = np.full_like(t, np.float32(_C2PI[6]))
    for c in _C2PI[5::-1]:
        acc = acc * t + np.float32(c)
    return np.where(flip, -acc, acc).astype(np.float32)


def signal_noise_np(seed: int, t_samples: int, frame_step: int) -> np.ndarray:
    """numpy twin of signal_noise (float32 [t_samples]): the hash and the
    uniforms are bit-identical, ln and sqrt ulp-close."""
    s = max(1, int(frame_step))
    rows = -(-t_samples // s)
    row_idx = np.arange(rows, dtype=np.uint32)[:, None]
    lane_idx = np.arange(s, dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        kr = _fmix32_np((row_idx * np.uint32(_GOLDEN)) ^ np.uint32(_fmix32_int(seed)))
        h = _fmix32_np(kr + lane_idx)
    u1 = ((h >> np.uint32(16)).astype(np.float32) + np.float32(0.5)) * np.float32(1.0 / 65536.0)
    u2 = ((h & np.uint32(0xFFFF)).astype(np.float32) + np.float32(0.5)) * np.float32(1.0 / 65536.0)
    r = np.sqrt(np.float32(-2.0) * np.log(u1, dtype=np.float32))
    z = r * _cos2pi_np(u2)
    return z.reshape(rows * s)[:t_samples].astype(np.float32)
