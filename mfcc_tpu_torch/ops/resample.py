"""Polyphase resampler — the port of `mfcc_tpu/ops/resample.py`, the twin of
scipy.signal.resample_poly (padtype='constant', the default):

    g = gcd(up, down); up, down //= g
    h = firwin(2*half_len+1, 1/max_rate, window=('kaiser', 5.0)) * up,
        half_len = 10*max_rate
    h <- [zeros(n_pre_pad), h], n_pre_pad = down - half_len % down
    y = upfirdn(h, x, up, down)[n_pre_remove : n_pre_remove + n_out],
        n_pre_remove = (half_len + n_pre_pad) // down,
        n_out = ceil(n_in * up / down)

Taps are designed on the host in float64 by the same scipy call as the JAX
package and the oracle, so they are bit-identical. `resample_batch` is the
entry point: on a CUDA float32 tensor it launches the polyphase kernel
(`mfcc_tpu_torch/kernels/resample.py`), on a CPU tensor it runs
`resample_reference`, the reference's two-dot banded-matmul form in torch.

The kernels read the taps phase by phase (`polyphase_design`): with the
n_pre_pad leading zeros dropped, output j is

    y[j] = sum_{i<K} table[p, i] * x[q - i],  a = j*down + half_len,
                                              p = a % up, q = a // up

since (j + n_pre_remove)*down - n_pre_pad = j*down + half_len exactly.

`StreamingResampler` is the streaming twin (port of the reference's
:424-515): host float64 numpy, one banded [J, W] matrix product a block of
J outputs, sample-exact against scipy for any chunking; the streaming
extractor (`pipeline/streaming.py`) feeds resampling configs through it.

Not ported: the TPU's blocked host layouts (`BlockedLayout`,
`resample_blocked`, `slab_design`), which exist for VMEM (the port takes
flat rows).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def ratio(sr_in: int, sr_out: int) -> tuple[int, int]:
    """(up, down) reduced by their gcd: up from sr_out, down from sr_in."""
    g = math.gcd(sr_out, sr_in)
    return sr_out // g, sr_in // g


@functools.lru_cache(maxsize=32)
def _design(up: int, down: int) -> dict:
    """Host-side tap design + index algebra, cached per reduced ratio."""
    import scipy.signal

    g = math.gcd(up, down)
    up, down = up // g, down // g
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = scipy.signal.firwin(
        2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0)
    ).astype(np.float64) * up
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    return {
        "up": up,
        "down": down,
        "taps": h,  # float64; cast at use
        "n_pre_remove": n_pre_remove,
        "half_len": half_len,
    }


@functools.lru_cache(maxsize=32)
def polyphase_design(up: int, down: int) -> dict:
    """The kernels' tap table (`csrc/polyphase.cuh`): float64 [up, K],
    table[p, i] = h[p + up*i] for the filter without its leading zeros,
    zero past its end; K = ceil((2*half_len + 1) / up). Read-only."""
    d = _design(up, down)
    up, half_len = d["up"], d["half_len"]
    h = d["taps"][d["taps"].shape[0] - (2 * half_len + 1):]
    K = -(-h.shape[0] // up)
    flat = np.zeros(up * K, dtype=np.float64)
    flat[: h.shape[0]] = h
    table = np.ascontiguousarray(flat.reshape(K, up).T)
    table.setflags(write=False)
    return {"up": up, "down": d["down"], "half_len": half_len, "K": K,
            "table": table}


def output_length(n_in: int, sr_in: int, sr_out: int) -> int:
    """ceil(n_in * up / down) after gcd reduction — scipy's n_out."""
    up, down = ratio(sr_in, sr_out)
    n = n_in * up
    return n // down + bool(n % down)


def output_lengths(lengths: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """Per-utterance output_length on a tensor, in its dtype.

    Computed as q*up + ceil(r*up/down) with q, r = divmod(n, down): exact
    and overflow-safe in int32 — `lengths * up` directly would wrap for high
    ratios (44.1 kHz → 16 kHz reduces to up=160: utterances over ~13.4 M
    samples)."""
    up, down = ratio(sr_in, sr_out)
    q = torch.div(lengths, down, rounding_mode="floor")
    ru = (lengths - q * down) * up  # < down*up: no overflow
    ceil_ru = torch.div(ru + (down - 1), down, rounding_mode="floor")
    return (q * up + ceil_ru).to(lengths.dtype)


def _block_J(up: int) -> int:
    """Outputs per block of the two-dot form: the smallest multiple of `up`
    >= 128, so every block shares one polyphase alignment (J % up == 0)."""
    return -(-128 // up) * up


@functools.lru_cache(maxsize=16)
def _stream_design(up: int, down: int, J: int):
    """Block-invariant polyphase apply for J outputs (J % up == 0): the
    read-only float64 [J, W] matrix plus the window algebra."""
    d = _design(up, down)  # gcd-reduced already; reuses the tap cache
    npr = d["n_pre_remove"]
    h = d["taps"]
    lh = h.shape[0]
    # output j is upfirdn index (j + npr): it reads zero-stuffed input at
    # m = (j+npr)*down - k for k in [0, lh), i.e. x[m/up] where up | m.
    # Window origin = lowest x index output 0 can touch (may be negative
    # at stream start -> zero-filled).
    origin = math.ceil((npr * down - (lh - 1)) / up)
    hi = ((J - 1 + npr) * down) // up
    W = hi - origin + 1
    M = np.zeros((J, W), dtype=np.float64)
    for j in range(J):
        mh = (j + npr) * down
        k0 = mh % up  # smallest k with up | (mh - k)
        for k in range(k0, min(lh, mh - origin * up + 1), up):
            M[j, (mh - k) // up - origin] += h[k]
    M.setflags(write=False)
    step = J * down // up  # input samples per block
    return M, origin, W, step


@functools.lru_cache(maxsize=16)
def _block_matrix(up: int, down: int, dtype: torch.dtype, device: torch.device):
    M, _, _, _ = _stream_design(up, down, _block_J(up))
    return torch.tensor(M.T, dtype=dtype, device=device)


def _resample_flat(x: torch.Tensor, up: int, down: int, n_out: int) -> torch.Tensor:
    """Banded-matmul apply: [B, n_in] float -> [B, >= n_out] (whole
    J-blocks; callers trim). gcd-reduced up/down.

    Two dots + one shifted add, as in the reference:

        slab = x_padded.reshape(B, n_blk+1, step)
        y    = slab[:, :n_blk] @ M1  +  (slab[:, :, :E] @ M2)[:, 1:]

    with M1 = M.T[:step] (main taps) and M2 = M.T[step:W] (the E-sample
    halo each block reads from the next row). A design whose halo is wider
    than a block (extreme upsampling) gathers its windows instead."""
    J = _block_J(up)
    _, origin, W, step = _stream_design(up, down, J)
    Mt = _block_matrix(up, down, x.dtype, x.device)
    B, n_in = x.shape
    n_blk = -(-n_out // J)
    # block b reads input [origin + b*step, origin + b*step + W); shift by
    # pad_lo so all indices are >= 0, zero-fill outside (= scipy constant)
    pad_lo = max(0, -origin)
    o = origin + pad_lo
    E = W - step
    need = o + (n_blk - 1) * step + max(2 * step, W)
    pad_hi = max(0, need - (n_in + pad_lo))
    x = torch.nn.functional.pad(x, (pad_lo, pad_hi))
    if 0 < E <= step:
        slab = x[:, o : o + (n_blk + 1) * step].reshape(B, n_blk + 1, step)
        y = slab[:, :n_blk] @ Mt[:step] + (slab[:, :, :E] @ Mt[step:W])[:, 1:]
    else:
        idx = o + step * torch.arange(n_blk, device=x.device)[:, None]
        win = x[:, idx + torch.arange(W, device=x.device)]  # [B, n_blk, W]
        y = win @ Mt
    return y.reshape(B, n_blk * J)


DENSE_BLOCK_MAX = 1 << 22  # entries of the two-dot form's [J, W] block matrix it builds at most
GATHER_CHUNK = 1 << 22  # outputs x taps a gather step of `_resample_gather` takes


def _resample_gather(x: torch.Tensor, up: int, down: int, n_out: int) -> torch.Tensor:
    """The polyphase sum as a gather, float64: y[j] = sum_i table[p, i] *
    x[q - i] (a = j*down + half_len, p = a % up, q = a // up, x = 0 outside
    the row), outputs a chunk at a time — for designs whose banded block
    matrix is too large to build (16,000 -> 15,999: J = 15,999 outputs a
    block, a [15,999, ~16,022] float64 matrix of 2 GB)."""
    d = polyphase_design(up, down)
    tab = torch.tensor(d["table"], device=x.device)
    B, n_in = x.shape
    i = torch.arange(d["K"], device=x.device)
    y = x.new_empty((B, n_out))
    step = max(1, GATHER_CHUNK // d["K"])
    for j0 in range(0, n_out, step):
        a = torch.arange(j0, min(n_out, j0 + step), device=x.device) * down + d["half_len"]
        idx = (a // up)[:, None] - i[None, :]  # [n, K]
        live = ((idx >= 0) & (idx < n_in)).to(x.dtype)
        xs = x[:, idx.clamp(0, max(n_in - 1, 0))] * live
        y[:, j0 : j0 + idx.shape[0]] = (xs * tab[a % up]).sum(-1)
    return y


def resample_reference(audio: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """The plain version: [..., T] float -> [..., output_length(T)] by the
    two-dot form, on any device, returned in the input's dtype; a design
    whose [J, W] block matrix would be over DENSE_BLOCK_MAX entries takes
    the same sum as a gather (`_resample_gather`).

    The dots accumulate in float64 and round once. In float32 the two-dot
    sums leave mfcc39_44k features up to 1.2e-3 from the float64 goldens
    on the pathological golden signals (dc, tone_offbin), over the
    family's 8e-4 gate (the JAX package measures its own CPU floor there at
    1.32e-3, docs/ACCURACY.md); rounded once they stay within it. It also
    makes each row's result independent of the batch around it, which a
    float32 BLAS reduction is not."""
    if not audio.dtype.is_floating_point:
        raise ValueError(f"resampling takes float audio, got {audio.dtype}")
    if sr_in == sr_out:
        return audio
    up, down = ratio(sr_in, sr_out)
    n_in = audio.shape[-1]
    n_out = output_length(n_in, sr_in, sr_out)
    lead = audio.shape[:-1]
    if n_in == 0:
        return audio.new_zeros(lead + (0,))
    x = audio.reshape(-1, n_in).double()
    J = _block_J(up)
    if J * (J * down // up + polyphase_design(up, down)["K"]) > DENSE_BLOCK_MAX:
        y = _resample_gather(x, up, down, n_out)
    else:
        y = _resample_flat(x, up, down, n_out)
    return y[:, :n_out].reshape(lead + (n_out,)).to(audio.dtype)


def resample_batch(audio: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """Resample [..., T] along the last axis, sr_in -> sr_out.

    A CUDA float32 tensor goes through the polyphase kernel (other CUDA
    dtypes raise); a CPU tensor through `resample_reference`. Zero padding
    beyond each utterance's length behaves exactly like scipy's 'constant'
    edge mode, so a padded batch resamples to the same values as each
    utterance alone (valid output range per row: output_lengths(lengths))."""
    from mfcc_tpu_torch.kernels import resample as K

    return K.polyphase_resample(audio, sr_in, sr_out)


class StreamingResampler:
    """Streaming twin of `resample_batch` / scipy `resample_poly`
    (padtype='constant'): push arbitrary-sized chunks at sr_in, get back
    resampled samples at sr_out, with

        concat(push(c) for c in chunks) + flush() == resample_numpy(x)

    for any chunking (the zero edges at stream start and end are scipy's
    constant padding, so the parity is sample-exact in float64).

    Fixed block structure: J output samples a block with J % up == 0, so
    every block reads a window of the same width W at the same polyphase
    alignment, and a block is one precomputed float64 [J, W] banded-matrix
    product on the host (`_stream_design`; ~1 MFLOP a second of audio, so
    push() launches nothing on a device). The algorithmic latency is the
    filter's look-ahead, ~(half_len + n_pre_pad) / sr_in seconds (0.7 ms
    at 48 kHz -> 16 kHz)."""

    def __init__(self, sr_in: int, sr_out: int, block_out: int = 512, dtype=np.float32):
        if sr_in == sr_out:
            raise ValueError("sr_in == sr_out; nothing to resample")
        self.up, self.down = ratio(sr_in, sr_out)
        J = -(-int(block_out) // self.up) * self.up
        self.M, self.origin, self.W, self.step = _stream_design(self.up, self.down, J)
        self.J = J
        self.dtype = dtype
        self._buf = np.zeros(0, dtype=np.float64)
        self._pos = 0  # absolute input index of _buf[0]
        self._n_in = 0
        self._emitted = 0
        self._closed = False

    def push(self, x: np.ndarray) -> np.ndarray:
        """Feed input samples; returns every output sample whose whole
        filter window is now available."""
        if self._closed:
            raise RuntimeError("resampler already flushed")
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        self._buf = np.concatenate([self._buf, x])
        self._n_in += x.shape[0]
        out = []
        while self.origin + (self._emitted // self.J) * self.step + self.W <= self._n_in:
            out.append(self._run_block(self._emitted // self.J))
        if not out:
            return np.zeros(0, dtype=self.dtype)
        return np.concatenate(out).astype(self.dtype)

    def flush(self) -> np.ndarray:
        """Emit the remaining ceil(n_in * up / down) - emitted samples (their
        windows zero-filled past the end: scipy's constant padding); close."""
        if self._closed:
            raise RuntimeError("resampler already flushed")
        self._closed = True
        nu = self._n_in * self.up
        n_out = nu // self.down + bool(nu % self.down)
        out = []
        before = self._emitted
        while self._emitted < n_out:
            out.append(self._run_block(self._emitted // self.J))
        self._emitted = n_out  # the final block is cut to n_out
        if not out:
            return np.zeros(0, dtype=self.dtype)
        return np.concatenate(out)[: n_out - before].astype(self.dtype)

    @property
    def samples_out(self) -> int:
        return self._emitted

    def _run_block(self, b: int) -> np.ndarray:
        start = self.origin + b * self.step
        w = np.zeros(self.W, dtype=np.float64)
        lo = max(start, self._pos)
        hi = min(start + self.W, self._pos + self._buf.shape[0])
        if hi > lo:
            w[lo - start : hi - start] = self._buf[lo - self._pos : hi - self._pos]
        y = self.M @ w
        self._emitted += self.J
        keep_from = self.origin + (b + 1) * self.step
        if keep_from > self._pos:
            drop = min(keep_from - self._pos, self._buf.shape[0])
            self._buf = self._buf[drop:]
            self._pos += drop
        return y


def resample_numpy(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Float64 oracle — delegates to scipy (the ground truth)."""
    import scipy.signal

    up, down = ratio(sr_in, sr_out)
    return scipy.signal.resample_poly(x, up, down)
