"""numpy mirrors of the register-blocked polyphase FIR (`csrc/polyphase.cuh`
pp_block) as `csrc/resample.cu` and the fused resample of `csrc/frontend.cu`
run it, held to the plain version (`resample_reference`, the chain's
resample + pre-emphasis), to scipy.signal.resample_poly and to the JAX
package's resampler; and the fused form's shared-memory layout.

The CUDA kernels cannot run here, so the mirrors walk the kernels' own loop
order: the outputs each thread takes (kPpR1 = 7 consecutive ones at up = 1,
the k-step's register slot (r - k) mod 7 of the sliding window, class by
class; kPpRU = 4 outputs up apart at up > 1, with the safe index for those
past the tile), the padded stride of the staged table, the window each
block stages (resample.cu's from the 16-byte boundary below its flat index;
the fused form's in the rows' own int16 over the warps' rows), every window
read inside the staged window, each thread's first output whose x[t-1] is
the row's previous entry (read by the chunked in-place pre-emphasis).
FMA is emulated (the product and sum in float64, rounded once to
float32). Tolerances (`mfcc_tpu_torch.testing`): float64 mirrors
vs scipy 1e-12; float32 mirrors vs the plain version and JAX 1e-5 of each
row's max |x| (the kernels' own gate on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from mfcc_tpu.ops import resample as jresample
from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.kernels import resample as K
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.ops import resample as R

RATES = [(48000, 16000), (44100, 16000), (32000, 16000), (22050, 16000), (8000, 16000)]
RATE_IDS = ["48k", "44k", "32k", "22k", "8k"]
STAGE_BATCH = 8  # csrc/frontend.cu kStageBatch
SM_BYTES = 233472  # an H100 SM's shared memory; each block also reserves 1 KB


def _a4(n: int) -> int:
    return (n + 3) & ~3


def _design(sr_in, sr_out):
    return R.polyphase_design(*R.ratio(sr_in, sr_out))


def _table(d, scale, dtype):
    """The staged table [up, table_stride]: float32 as `K.table` lays it out
    for the card, float64 (the same padding) for the exact mirror."""
    if dtype == np.float32:
        return K.table(d["up"], d["down"], scale)
    t = np.zeros((d["up"], K.table_stride(d)))
    t[:, : d["K"]] = d["table"] * scale
    return t


def _sample(v, dtype):
    """pp_sample: int16 through the exponent trick, float as is."""
    if v.dtype == np.int16:
        bits = (np.int32(0x4B400000) + v.astype(np.int32)).astype(np.int32)
        return (bits.view(np.float32) - np.float32(12582912.0)).astype(dtype)
    return v.astype(dtype)


def _fma(a, b, c, dtype):
    if dtype == np.float32:
        return (np.float64(a) * b.astype(np.float64) + c).astype(np.float32)
    return a * b + c


def _fir_block(j0, n, live_lo, live_hi, lo, win, tab, d, dtype):
    """pp_block over the staged window `win` (win[0] is input index lo):
    y[0:n] (0 outside [live_lo, live_hi)), every output put exactly once,
    every window read asserted inside the window."""
    up, down = d["up"], d["down"]
    y = np.full(n, np.nan, dtype)
    count = np.zeros(n, int)

    def read(idx):
        assert idx.size == 0 or (idx.min() >= 0 and idx.max() < win.shape[0])
        return _sample(win[idx], dtype)

    if up == 1:
        R1 = K.FIR_R1
        i0 = np.arange(-(-n // R1)) * R1
        run = (i0 < live_hi) & (i0 + R1 > live_lo)
        acc = np.zeros((i0.size, R1), dtype)
        base = (j0 + i0[run]) * down + d["half_len"] - lo  # q = a at up = 1
        Kc = K.table_stride(d) // down
        sub = np.zeros((base.size, R1), dtype)
        for c in range(down):
            z = base - c
            w = np.zeros((base.size, R1), dtype)  # the thread's registers
            for m in range(1, R1):
                w[:, m] = read(z + down * m)
            for k in range(Kc):
                w[:, (-k) % R1] = read(z - down * k)
                h = tab[0, c + down * k]
                for r in range(R1):
                    sub[:, r] = _fma(h, w[:, (r - k) % R1], sub[:, r], dtype)
        acc[run] = sub
        for r in range(R1):
            i = i0 + r
            ok = i < n
            live = (i >= live_lo) & (i < live_hi)
            y[i[ok]] = np.where(live, acc[:, r], 0)[ok]
            np.add.at(count, i[ok], 1)
    else:
        RU = K.FIR_RU
        rows = -(-n // up)
        g = np.arange(up * -(-rows // RU))
        i0 = g % up + up * RU * (g // up)
        nr = np.where(i0 < n, np.minimum(RU, (n - 1 - np.minimum(i0, n - 1)) // up + 1), 0)
        run = (nr > 0) & (i0 < live_hi)
        a = (j0 + i0[run]) * down + d["half_len"]
        p, base = a % up, a // up - lo
        idx = np.stack([np.where(r < nr[run], base + r * down, d["K"] - 1) for r in range(RU)], 1)
        sub = np.zeros((a.size, RU), dtype)
        for i in range(d["K"]):
            h = tab[p, i]
            for r in range(RU):
                sub[:, r] = _fma(h, read(idx[:, r] - i), sub[:, r], dtype)
        acc = np.zeros((g.size, RU), dtype)
        acc[run] = sub
        for r in range(RU):
            i = i0 + r * up
            ok = r < nr
            live = (i >= live_lo) & (i < live_hi)
            y[i[ok]] = np.where(live, acc[:, r], 0)[ok]
            np.add.at(count, i[ok], 1)
    assert (count == 1).all()
    return y


def _stage(flat, base, lo, n, length, cap):
    """pp_stage: 16-byte vectors of the flat array from the boundary at or
    below its index base + lo (zero outside the array and outside the row's
    [0, length)), within `cap` floats; returns the window from its shift."""
    v = 16 // flat.itemsize
    f = base + lo
    shift = f % v
    nv = (n + shift + v - 1) // v
    assert nv * 16 <= 4 * cap
    k = np.arange(v * nv)
    fi, ri = f - shift + k, lo - shift + k
    ok = (fi >= 0) & (fi < flat.size) & (ri >= 0) & (ri < length)
    win = np.where(ok, flat[np.clip(fi, 0, max(flat.size - 1, 0))], 0).astype(flat.dtype)
    return win[shift:]


def _mirror_resample(x, sr_in, sr_out, dtype):
    """csrc/resample.cu: per (row, TILE_OUT tile) the window staged in float4
    steps from the 16-byte boundary at or below its flat index in [B, T]
    (zero outside the array and outside the row), then pp_block."""
    d = _design(sr_in, sr_out)
    tab = _table(d, 1.0, dtype)
    B, T = x.shape
    n_out = R.output_length(T, sr_in, sr_out)
    flat = x.astype(np.float32 if dtype == np.float32 else np.float64).ravel()
    cap = K.stage_floats(K.fir_window(K.TILE_OUT, d), flat.itemsize)  # the layout's window floats
    y = np.empty((B, n_out), dtype)
    for b in range(B):
        for j0 in range(0, n_out, K.TILE_OUT):
            n = min(K.TILE_OUT, n_out - j0)
            lo = K.first_input(j0, d)
            n_in = K.fir_window(n, d)
            win = _stage(flat, b * T, lo, n_in, T, cap)
            y[b, j0 : j0 + n] = _fir_block(j0, n, 0, n, lo, win, tab, d, dtype)
    return y


def _lengths(sr_in, sr_out):
    """T = 1, K - 1, a tile edge - 1, + 0, + 1 (the T whose output ends a
    TILE_OUT tile) and a few more."""
    d = _design(sr_in, sr_out)
    edge = K.TILE_OUT * d["down"] // d["up"]
    return [1, d["K"] - 1, edge - 1, edge, edge + 1, 3 * edge + 7]


@pytest.mark.parametrize("sr_in,sr_out", RATES, ids=RATE_IDS)
def test_resample_mirror_float64_vs_scipy(sr_in, sr_out):
    """In float64 the blocked loop order, padded table, anchors and windows
    reproduce scipy to roundoff at every length, tile edges included."""
    g = np.random.default_rng(11)
    for T in _lengths(sr_in, sr_out):
        x = g.standard_normal((2, T))
        got = _mirror_resample(x, sr_in, sr_out, np.float64)
        want = scipy.signal.resample_poly(x, *R.ratio(sr_in, sr_out), axis=-1)
        assert got.shape == want.shape, T
        np.testing.assert_allclose(got, want, rtol=0, atol=testing.RESAMPLE_F64_ATOL, err_msg=str(T))


@pytest.mark.parametrize("sr_in,sr_out", RATES, ids=RATE_IDS)
def test_resample_mirror_float32_vs_plain_and_jax(sr_in, sr_out):
    x = (np.random.default_rng(12).standard_normal((3, 20011)) * 3000).astype(np.float32)
    got = _mirror_resample(x, sr_in, sr_out, np.float32)
    plain = R.resample_reference(torch.as_tensor(x), sr_in, sr_out).numpy()
    err = testing.resample_error(got, plain, x)
    assert err < testing.RESAMPLE_KERNEL_REL_ROWMAX, err
    jx = np.asarray(jresample.resample_batch(jnp.asarray(x), sr_in, sr_out))
    err = testing.resample_error(got, jx, x)
    assert err < testing.RESAMPLE_KERNEL_REL_ROWMAX, err


@pytest.mark.parametrize("sr_in", [48000, 44100])
def test_resample_mirror_full_rows(sr_in):
    """The main path's row length, 480,080 samples, float32 at a base that
    is not 16-byte aligned in the flat array (row 1 starts at 480,080 + 3):
    within the kernel's gate of the plain version and of scipy."""
    g = np.random.default_rng(13)
    T = 480080 + 3
    x = (g.standard_normal((2, T)) * 3000).astype(np.float32)
    got = _mirror_resample(x, sr_in, 16000, np.float32)
    plain = R.resample_reference(torch.as_tensor(x), sr_in, 16000).numpy()
    assert testing.resample_error(got, plain, x) < testing.RESAMPLE_KERNEL_REL_ROWMAX
    want = scipy.signal.resample_poly(x.astype(np.float64), *R.ratio(sr_in, 16000), axis=-1)
    assert testing.resample_error(got, want, x) < testing.RESAMPLE_KERNEL_REL_ROWMAX


def test_empty_rows_take_no_tile():
    x = torch.zeros((2, 0))
    assert K.polyphase_resample(x, 48000, 16000).shape == (2, 0)
    assert _mirror_resample(np.zeros((2, 0)), 48000, 16000, np.float64).shape == (2, 0)


@pytest.mark.parametrize("sr_in,sr_out", RATES, ids=RATE_IDS)
def test_table_stride_and_banks(sr_in, sr_out):
    """The staged table's stride: equal residue classes of whole FIR_R1
    steps at up = 1, odd at
    up > 1, zeros past K, the taps themselves bitwise float32 of the
    design. A warp's 32 threads read distinct banks for distinct words: at
    up > 1 the rows of 32 consecutive outputs' phases, at up = 1 (odd down) the first
    samples of 32 consecutive groups (7*down apart)."""
    d = _design(sr_in, sr_out)
    up, down, stride = d["up"], d["down"], K.table_stride(d)
    t = K.table(up, down)
    assert t.shape == (up, stride) and t.dtype == np.float32
    np.testing.assert_array_equal(t[:, : d["K"]], d["table"].astype(np.float32))
    assert not t[:, d["K"] :].any()
    if up == 1:
        assert stride % (down * K.FIR_R1) == 0 and stride - d["K"] < down * K.FIR_R1
        if down % 2:
            assert len({(g * K.FIR_R1 * down) % 32 for g in range(32)}) == 32
    else:
        assert stride % 2 == 1 and stride - d["K"] <= 1
        for j in range(0, 4 * up, 37):
            p = (np.arange(j, j + 32) * down + d["half_len"]) % up
            assert len(set((p * stride) % 32)) == len(set(p))  # else a broadcast
    if (sr_in, sr_out) == (44100, 16000):
        p = (np.arange(32) * down + d["half_len"]) % up
        assert len(set((p * d["K"]) % 32)) <= 4  # the unpadded stride's conflicts
        assert stride == 57


def test_int16_sample_trick_is_exact():
    v = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    np.testing.assert_array_equal(_sample(v, np.float32), v.astype(np.float32))


# ---------------------------------------------------------------------------
# the fused resample of csrc/frontend.cu
# ---------------------------------------------------------------------------


def _layout(cfg, int16: bool) -> dict:
    """csrc/frontend.cu layout() of the fused form, field by field (floats):
    the signal row of span + 1, the analysis window, packed weights,
    offsets, bin-filter words, twiddles, stage bases, the warps' rows and
    scratch (buf), which the input window overlays, then the tap table."""
    form = frontend.kernel_form(cfg)
    tables, nnz, M = frontend.mel_matrices(cfg), frontend.packed_count(cfg), cfg.n_mels
    span = (frontend.TILE - 1) * cfg.frame_step + cfg.frame_length
    d = _design(cfg.input_sample_rate, cfg.sample_rate)
    lay = {"span": span, "win": _a4(span + 1)}
    lay["melw"] = lay["win"] + _a4(max(cfg.frame_length, cfg.n_fft))
    lay["moff"] = lay["melw"] + tables * _a4(nnz)
    lay["meta"] = lay["moff"] + (_a4(M + 1) if tables else 0)
    lay["tw"] = lay["meta"] + (_a4(nnz) if tables else 0)
    lay["bases"] = lay["tw"] + _a4(2 * frontend.twiddle_count(cfg.n_fft, form))
    lay["buf"] = lay["bases"] + _a4(len(frontend.stage_bases(cfg.n_fft, form)))
    pstride = 2 * frontend.row_floats(cfg.n_fft, form) + _a4(tables * (32 + M))
    lay["rows"] = frontend.WARPS * pstride
    lay["fir"] = K.stage_floats(frontend.resample_window(cfg), 2 if int16 else 4)
    lay["tab"] = lay["buf"] + max(lay["rows"], lay["fir"])
    lay["total"] = lay["tab"] + _a4(d["up"] * K.table_stride(d))
    return lay


@pytest.mark.parametrize("config_name,int16,blocks", [
    ("mfcc39_48k", True, 3), ("mfcc39_44k", True, 2),
    ("mfcc39_48k", False, 2), ("mfcc39_44k", False, 1)])
def test_fused_layout_budget(config_name, int16, blocks):
    """smem_bytes is the sum of the documented fields; int16 rows fit three
    blocks an SM at 48 kHz (<= 76,800 B) and two at 44.1 kHz (<= 115,712
    B), as the plain form (71,200 B) does at three; the input window lies
    inside the warps' rows at int16 and starts 16-byte aligned."""
    cfg = T_CONFIGS[config_name]
    lay = _layout(cfg, int16)
    n = frontend.smem_bytes(cfg, int16=int16)
    assert n == 4 * lay["total"]
    assert blocks * (n + 1024) <= SM_BYTES < (blocks + 1) * (n + 1024)
    if int16:  # the window takes no memory of its own
        assert n <= {3: 76800, 2: 115712}[blocks]
        assert lay["fir"] <= lay["rows"] == lay["tab"] - lay["buf"]
    assert (4 * lay["buf"]) % 16 == 0 and lay["win"] >= lay["span"] + 1
    assert frontend.layout_reason(cfg) is None
    assert frontend.smem_bytes(T_CONFIGS["classic13"]) == 71200


def _mirror_fused(audio, lengths, cfg, dtype):
    """The fused staging, tile by tile: the window in the rows' own type
    (masked at t_in >= length), pp_block into the signal row (x[-1] = 0,
    zero past the output length), then pre-emphasis and zeroing in place in
    chunks of kThreads * kStageBatch, each chunk read whole before it is written.
    Returns the staged rows [B, tiles * 32 * S + ...] (tiles that stage
    nothing hold zeros: all their frames take no DFT) and checks that
    overlapping tiles stage the same samples bitwise."""
    sr_in = cfg.input_sample_rate
    up, down = R.ratio(sr_in, cfg.sample_rate)
    d = R.polyphase_design(up, down)
    tab = _table(d, cfg.input_scale, dtype)
    B, T = audio.shape
    T_out = R.output_length(T, sr_in, cfg.sample_rate)
    F, S = cfg.num_frames(T_out), cfg.frame_step
    span = (frontend.TILE - 1) * S + cfg.frame_length
    n, n_in = span + 1, frontend.resample_window(cfg)
    flat = np.ascontiguousarray(audio).ravel()
    cap = K.stage_floats(n_in, flat.itemsize)  # _layout's "fir" for int16 and float32 rows
    c = dtype(cfg.preemph)
    chunk = frontend.WARPS * 32 * STAGE_BATCH
    sig = np.full((B, (-(-F // frontend.TILE) - 1) * frontend.TILE * S + span), np.nan, dtype)
    for b in range(B):
        len_in = max(0, min(int(lengths[b]), T))
        n_valid = -(-len_in * up // down)
        for f0 in range(0, F, frontend.TILE):
            t0 = f0 * S
            y = np.zeros(n, dtype)
            if t0 < n_valid:
                lo = K.first_input(t0 - 1, d)
                win = _stage(flat, b * T, lo, n_in, len_in, cap)
                live_hi = min(n, n_valid - t0 + 1)
                y = _fir_block(t0 - 1, n, 1 if t0 == 0 else 0, live_hi, lo, win, tab, d, dtype)
                for c0 in range(0, span, chunk):
                    i = np.arange(c0, min(c0 + chunk, span))
                    y[i] = np.where(t0 + i < n_valid, y[i + 1] - c * y[i], 0)
            seen = sig[b, t0 : t0 + span]
            done = ~np.isnan(seen)
            np.testing.assert_array_equal(seen[done], y[:span][done])
            sig[b, t0 : t0 + span] = y[:span]
    return sig


def _plain_staged(audio, lengths, cfg):
    x16, l16 = tchain.resample_input(torch.as_tensor(audio), torch.as_tensor(lengths), cfg)
    return tchain.zero_beyond(tchain.preemphasis(x16, cfg.preemph), l16).numpy()


@pytest.mark.parametrize("config_name", ["mfcc39_48k", "mfcc39_44k"])
def test_fused_mirror_int16_vs_plain(config_name):
    """int16 rows through the fused mirror in float32 at lengths 0, 1, K - 1,
    the first tile's edge - 1, + 0, + 1 (in input samples) and the whole
    row: within 1e-5 of each row's max |x| of the plain version; garbage
    past each length never reaches the staged signal; float32 rows stage
    the same signal bitwise (chip_smoke.py's int16 == float32 check)."""
    cfg = T_CONFIGS[config_name]
    sr_in = cfg.input_sample_rate
    d = _design(sr_in, 16000)
    edge = frontend.TILE * cfg.frame_step * sr_in // 16000  # the first tile's 16 kHz start of tile 1
    T = 36000
    lens = [0, 1, d["K"] - 1, edge - 1, edge, edge + 1, T]
    g = np.random.default_rng(14)
    dirty = (g.standard_normal((len(lens), T)) * 3000).astype(np.int16)
    clean = dirty.copy()
    for i, n in enumerate(lens):
        clean[i, n:] = 0
    lengths = np.array(lens, np.int32)
    got = _mirror_fused(dirty, lengths, cfg, np.float32)
    np.testing.assert_array_equal(got, _mirror_fused(clean, lengths, cfg, np.float32))
    np.testing.assert_array_equal(got, _mirror_fused(clean.astype(np.float32), lengths, cfg, np.float32))
    want = _plain_staged(clean.astype(np.float32), lengths, cfg)
    n = want.shape[1]
    err = np.abs(got[:, :n] - want).max(axis=1) / (np.abs(clean).max(axis=1) + 1e-300)
    assert err.max() < testing.RESAMPLE_KERNEL_REL_ROWMAX, err
    assert not got[:, n:].any()
    assert not got[0].any()  # length 0: nothing but zeros


def test_fused_mirror_float64_full_row_vs_plain():
    """One 480,080-sample row at 48 kHz (the main path's), float64: the
    staged signal equals the plain version's to roundoff, over 32 tiles."""
    cfg = T_CONFIGS["mfcc39_48k"].replace(dtype="float64")
    x = np.random.default_rng(15).standard_normal((1, 480080)) * 3000
    lengths = np.array([480000 - 1713], np.int32)
    x[0, lengths[0]:] = 0
    got = _mirror_fused(x, lengths, cfg, np.float64)
    want = _plain_staged(x, lengths, cfg)
    np.testing.assert_allclose(got[:, : want.shape[1]], want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
