"""The port's resampler and resampling path (`mfcc_tpu_torch/ops/resample.py`,
`kernels/resample.py`, the fused resample of `kernels/frontend.py`) ≡ the
JAX package's ≡ scipy.

The same seeded numpy inputs go through both packages. Tolerances
(`mfcc_tpu_torch.testing`):
  - resample, float64 vs scipy and vs JAX under x64: 1e-12;
  - resample, float32 vs scipy at unit-normal scale: 1e-5
    (tests/test_resample.py's gate);
  - mfcc39_48k / mfcc39_44k features vs the goldens and vs JAX jnp/pallas:
    atol 8e-4, rtol 2e-5 (the JAX package's re-scoped gate for this family,
    tests/test_resample.py::test_mfcc39_48k_end_to_end, docs/ACCURACY.md);
  - float64 features vs JAX x64: 1e-10.

The CUDA kernels cannot run here. `_emulate_polyphase` and
`_emulate_fused_staging` mirror csrc/polyphase.cuh and the fused staging of
csrc/frontend.cu in numpy — tiles, staged windows, phase table, int64
anchors, masking — so their index algebra is tested on the CPU;
tests/test_torch_gpu.py holds the kernels themselves to their plain
versions on a card. Nothing here decodes wav.
"""

import numpy as np
import pytest
import scipy.signal
import torch

import jax
import jax.numpy as jnp

import mfcc_tpu_torch
from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu.ops import resample as jresample
from mfcc_tpu.pipeline import device_layout
from mfcc_tpu.pipeline import pad_batch as j_pad_batch
from mfcc_tpu.testing.golden import golden_signals, load_golden
from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.kernels import resample as K
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.ops import resample as R
from mfcc_tpu_torch.pipeline import pad_batch

RATES = [
    (48000, 16000, 48123),  # BASELINE config #5 ratio (up=1, down=3)
    (44100, 16000, 44100),  # fractional (160/441)
    (8000, 16000, 8001),  # upsampling
    (22050, 16000, 10007),
]
RATE_IDS = ["48k", "44k", "8k", "22k"]
RS_CONFIGS = ["mfcc39_48k", "mfcc39_44k"]
GOLDEN_SIGNALS = sorted(golden_signals())
BATCH_SIGNALS = ("speechish", "short", "noise", "tone_offbin")


def _inputs(config_name, names=BATCH_SIGNALS, scale=1.0):
    return [load_golden(config_name, n)["signal_input"] * scale for n in names]


# ---------------------------------------------------------------------------
# design and lengths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sr_in,sr_out,n", RATES, ids=RATE_IDS)
def test_design_taps_bitwise(sr_in, sr_out, n):
    got, want = R._design(sr_out, sr_in), jresample._design(sr_out, sr_in)
    for key in ("up", "down", "n_pre_remove"):
        assert got[key] == want[key]
    assert got["taps"].dtype == np.float64
    np.testing.assert_array_equal(got["taps"], want["taps"])


@pytest.mark.parametrize("sr_in,sr_out,n", RATES, ids=RATE_IDS)
def test_stream_design_bitwise(sr_in, sr_out, n):
    up, down = R.ratio(sr_in, sr_out)
    J = R._block_J(up)
    assert J == jresample._block_J(up)
    M, origin, W, step = R._stream_design(up, down, J)
    Mj, origin_j, W_j, step_j = jresample._stream_design(up, down, J)
    assert (origin, W, step) == (origin_j, W_j, step_j)
    np.testing.assert_array_equal(M, Mj)


@pytest.mark.parametrize("sr_in,sr_out,n", RATES, ids=RATE_IDS)
def test_polyphase_table_holds_every_tap(sr_in, sr_out, n):
    """table[p, i] = h[p + up*i] for the filter without its n_pre_pad
    leading zeros: every tap once, zeros elsewhere."""
    up, down = R.ratio(sr_in, sr_out)
    d, pd = R._design(up, down), R.polyphase_design(up, down)
    h = d["taps"]
    assert pd["half_len"] == 10 * max(up, down)
    lead = h.shape[0] - (2 * pd["half_len"] + 1)
    np.testing.assert_array_equal(h[:lead], 0.0)
    assert pd["table"].shape == (up, pd["K"]) and pd["K"] == -(-(h.shape[0] - lead) // up)
    flat = pd["table"].T.ravel()
    np.testing.assert_array_equal(flat[: h.shape[0] - lead], h[lead:])
    np.testing.assert_array_equal(flat[h.shape[0] - lead :], 0.0)
    # the kernels' anchor: (j + n_pre_remove)*down - n_pre_pad = j*down + half_len
    assert d["n_pre_remove"] * down - lead == pd["half_len"]


@pytest.mark.parametrize("sr_in,sr_out,n", RATES, ids=RATE_IDS)
def test_output_lengths_match_jax(sr_in, sr_out, n):
    """Including 44.1 kHz lengths above 13.4 M samples, where lengths*up
    would wrap int32 (every length whose output fits int32)."""
    lens = [0, 1, 2, 3, 440, 441, 442, 1199, 1200, 1201, 47999, 48000, 48001,
            n, 13_400_000, 13_500_000, 2**30 - 1, 2**31 - 1]
    lens = [v for v in lens if R.output_length(v, sr_in, sr_out) < 2**31]
    host = [R.output_length(v, sr_in, sr_out) for v in lens]
    assert host == [jresample.output_length(v, sr_in, sr_out) for v in lens]
    got = R.output_lengths(torch.tensor(lens, dtype=torch.int32), sr_in, sr_out)
    want = jresample.output_lengths(jnp.asarray(lens, jnp.int32), sr_in, sr_out)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), host)


# ---------------------------------------------------------------------------
# resample_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sr_in,sr_out,n", RATES, ids=RATE_IDS)
def test_resample_float64_matches_scipy_and_jax(sr_in, sr_out, n):
    x = np.random.default_rng(3).standard_normal(n)
    want = R.resample_numpy(x, sr_in, sr_out)
    got = R.resample_batch(torch.as_tensor(x), sr_in, sr_out).numpy()
    assert got.shape == want.shape == (R.output_length(n, sr_in, sr_out),)
    np.testing.assert_allclose(got, want, rtol=0, atol=testing.RESAMPLE_F64_ATOL)
    with jax.enable_x64(True):
        jx = np.asarray(jresample.resample_batch(jnp.asarray(x), sr_in, sr_out))
    np.testing.assert_allclose(got, jx, rtol=0, atol=testing.RESAMPLE_F64_ATOL)


def test_wide_halo_matches_scipy():
    """100 Hz -> 16 kHz (up=160, down=1) has a halo wider than a block and
    takes the gather form. (The JAX package's gather, jnp.take in fill mode,
    reads past its padding there and returns NaN for the last outputs, so
    only scipy is the reference here.)"""
    x = np.random.default_rng(3).standard_normal(301)
    want = R.resample_numpy(x, 100, 16000)
    got = R.resample_batch(torch.as_tensor(x), 100, 16000).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=testing.RESAMPLE_F64_ATOL)
    with jax.enable_x64(True):
        jx = np.asarray(jresample.resample_batch(jnp.asarray(x), 100, 16000))
    assert np.isnan(jx).any()
    ok = ~np.isnan(jx)
    np.testing.assert_allclose(got[ok], jx[ok], rtol=0, atol=testing.RESAMPLE_F64_ATOL)


@pytest.mark.parametrize("sr_in,sr_out,n", RATES, ids=RATE_IDS)
def test_resample_float32_matches_scipy(sr_in, sr_out, n):
    x = np.random.default_rng(4).standard_normal((2, n))
    got = R.resample_batch(torch.as_tensor(x, dtype=torch.float32), sr_in, sr_out)
    assert got.dtype == torch.float32
    want = scipy.signal.resample_poly(x, *R.ratio(sr_in, sr_out), axis=-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=testing.RESAMPLE_F32_ATOL)


@pytest.mark.parametrize("sr_in", [48000, 44100])
def test_padded_batch_invariance(sr_in):
    """Rows of a zero-padded batch resample to the same values as alone."""
    g = np.random.default_rng(5)
    a, b = g.standard_normal(30011), g.standard_normal(48000)
    batch = np.zeros((2, 48000), np.float32)
    batch[0, : a.shape[0]] = a
    batch[1] = b
    out = R.resample_batch(torch.as_tensor(batch), sr_in, 16000).numpy()
    alone = R.resample_batch(torch.as_tensor(batch[:1]), sr_in, 16000).numpy()
    np.testing.assert_array_equal(out[0], alone[0])
    n_a = R.output_length(a.shape[0], sr_in, 16000)
    want = R.resample_numpy(a, sr_in, 16000)
    np.testing.assert_allclose(out[0, :n_a], want, rtol=0, atol=testing.RESAMPLE_F32_ATOL)


def test_resample_batch_shapes_and_refusals():
    x = torch.zeros((2, 3, 4800))
    assert R.resample_batch(x, 48000, 16000).shape == (2, 3, 1600)
    assert R.resample_batch(x, 16000, 16000) is x
    assert R.resample_batch(torch.zeros((2, 0)), 48000, 16000).shape == (2, 0)
    with pytest.raises(ValueError, match="float"):
        R.resample_batch(torch.zeros((1, 480), dtype=torch.int16), 48000, 16000)


# ---------------------------------------------------------------------------
# numpy mirrors of csrc/polyphase.cuh and the fused staging of csrc/frontend.cu
# ---------------------------------------------------------------------------


def _first_input(j, d):
    return (j * d["down"] + d["half_len"]) // d["up"] - (d["K"] - 1)


def _outputs(j, lo, win, tab, d):
    """pp_output for an array of outputs j over the staged window `win`
    (win[0] is input index lo): the same taps in the same order."""
    a = j.astype(np.int64) * d["down"] + d["half_len"]
    p, q = a % d["up"], a // d["up"]
    local = q - lo
    assert local.min() - (d["K"] - 1) >= 0 and local.max() < win.shape[0]
    acc = np.zeros(j.shape, win.dtype)
    for i in range(d["K"]):
        acc = acc + tab[p, i] * win[local - i]
    return acc


def _stage(row, lo, n_win, n_valid):
    u = lo + np.arange(n_win)
    ok = (u >= 0) & (u < n_valid)
    return np.where(ok, row[np.clip(u, 0, max(row.shape[0] - 1, 0))], 0).astype(row.dtype)


def _emulate_polyphase(x, sr_in, sr_out, dtype):
    """csrc/resample.cu in numpy: per (row, TILE_OUT tile) the staged input
    window (zero outside the row), then pp_output per output."""
    d = R.polyphase_design(*R.ratio(sr_in, sr_out))
    tab = d["table"].astype(dtype)
    B, T = x.shape
    n_out = R.output_length(T, sr_in, sr_out)
    y = np.empty((B, n_out), dtype)
    for b in range(B):
        for j0 in range(0, n_out, K.TILE_OUT):
            n = min(K.TILE_OUT, n_out - j0)
            lo = _first_input(j0, d)
            win = _stage(x[b].astype(dtype), lo, K.input_span(n, d), T)
            y[b, j0 : j0 + n] = _outputs(np.arange(j0, j0 + n), lo, win, tab, d)
    return y


@pytest.mark.parametrize("sr_in,sr_out,n", RATES, ids=RATE_IDS)
def test_polyphase_mirror_exact_vs_scipy(sr_in, sr_out, n):
    """In float64 the kernel's phase table, window staging and anchors
    reproduce scipy to roundoff; the window bounds hold for every tile."""
    x = np.random.default_rng(6).standard_normal((2, n))
    got = _emulate_polyphase(x, sr_in, sr_out, np.float64)
    want = scipy.signal.resample_poly(x, *R.ratio(sr_in, sr_out), axis=-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=testing.RESAMPLE_F64_ATOL)


def test_polyphase_mirror_float32_vs_plain():
    x = (np.random.default_rng(7).standard_normal((2, 20000)) * 3000).astype(np.float32)
    got = _emulate_polyphase(x, 44100, 16000, np.float32)
    plain = R.resample_reference(torch.as_tensor(x), 44100, 16000).numpy()
    err = testing.resample_error(got, plain, x)
    assert err < testing.RESAMPLE_KERNEL_REL_ROWMAX, err


def _emulate_fused_staging(audio, lengths, cfg, dtype, tile=frontend.TILE):
    """The fused resample's staging in csrc/frontend.cu, tile by tile of
    `tile` frames (the FFT forms' 32; the bf16x3 form's `bf16_plan`): the
    input window masked at t_in >= length, x[t0-1 .. t0+span) by the FIR
    (x[-1] = 0, zero past the output length), pre-emphasis and zeroing.
    Returns the staged signal rows [B, T_out + a tile] and checks that
    overlapping tiles stage the same samples bitwise."""
    up, down = R.ratio(cfg.input_sample_rate, cfg.sample_rate)
    d = R.polyphase_design(up, down)
    tab = (d["table"] * cfg.input_scale).astype(dtype)
    B, T = audio.shape
    T_out = R.output_length(T, cfg.input_sample_rate, cfg.sample_rate)
    F, S = cfg.num_frames(T_out), cfg.frame_step
    span = (tile - 1) * S + cfg.frame_length
    n_win = K.input_span(span + 1, d)
    c = dtype(cfg.preemph)
    n_tiles = -(-F // tile)
    sig = np.full((B, (n_tiles - 1) * tile * S + span), np.nan, dtype)
    for b in range(B):
        len_in = max(0, min(int(lengths[b]), T))
        n_valid = -(-len_in * up // down)
        for f0 in range(0, F, tile):
            t0 = f0 * S
            lo = _first_input(t0 - 1, d)
            win = _stage(audio[b].astype(dtype), lo, n_win, len_in)
            t = t0 - 1 + np.arange(span + 1)
            xs = np.zeros(span + 1, dtype)
            keep = (t >= 0) & (t < n_valid)
            if keep.any():
                xs[keep] = _outputs(t[keep], lo, win, tab, d)
            y = np.where(t[1:] < n_valid, xs[1:] - c * xs[:-1], 0).astype(dtype)
            seen = sig[b, t0 : t0 + span]
            done = ~np.isnan(seen)
            np.testing.assert_array_equal(seen[done], y[done])
            sig[b, t0 : t0 + span] = y
    return sig


@pytest.mark.parametrize("config_name", RS_CONFIGS)
def test_fused_staging_mirror_matches_plain(config_name):
    """Dirty tails and lengths at the 16 kHz frame and first-tile edges: the
    mirror's staged signal equals the plain version's pre-emphasized,
    zeroed resampled signal (float64, roundoff only), and garbage past each
    input length never reaches it."""
    cfg = T_CONFIGS[config_name].replace(dtype="float64")
    sr_in = cfg.input_sample_rate
    per_frame = sr_in // 100  # input samples per 10 ms hop
    lens = [0, 1, 2, 3, 4 * per_frame - 1, 4 * per_frame, 4 * per_frame + 1,
            16080 * sr_in // 48000, 23001]
    g = np.random.default_rng(8)
    T = 24000
    dirty = g.standard_normal((len(lens), T)) * 3000
    clean = dirty.copy()
    for i, n in enumerate(lens):
        clean[i, n:] = 0.0
    lengths = np.array(lens, np.int32)
    got = _emulate_fused_staging(dirty, lengths, cfg, np.float64)
    np.testing.assert_array_equal(got, _emulate_fused_staging(clean, lengths, cfg, np.float64))
    x16, l16 = tchain.resample_input(torch.as_tensor(clean), torch.as_tensor(lengths), cfg)
    want = tchain.zero_beyond(tchain.preemphasis(x16, cfg.preemph), l16).numpy()
    n = want.shape[1]
    np.testing.assert_allclose(got[:, :n], want, rtol=0, atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(got[:, n:], 0.0)


def test_smem_budget():
    """Both kernels fit the 48, 44.1, 22.05 and 8 kHz tables at their whole
    tile; resample.cu's plan fits every ratio: 16000/15999's table (16,000
    phases of 21 taps, 1.34 MB) is read from device memory at the whole
    tile, 192 kHz -> 8 kHz takes 1,120 outputs a tile, and a decimation by
    over 118 reads its windows from device memory too."""
    for sr_in, sr_out, _ in RATES:
        assert K.plan(*R.ratio(sr_in, sr_out)) == (K.TILE_OUT, "staged")
        assert K.smem_bytes(*R.ratio(sr_in, sr_out)) <= K.SMEM_BUDGET_BYTES
        cfg = T_CONFIGS["mfcc39_48k"].replace(input_sample_rate=sr_in)
        assert frontend.smem_bytes(cfg) <= K.SMEM_BUDGET_BYTES
    assert frontend.smem_bytes(T_CONFIGS["mfcc39_44k"]) == 107696  # two blocks an SM
    assert frontend.smem_bytes(T_CONFIGS["classic13"]) == 71200  # the plain form
    d = R.polyphase_design(*R.ratio(16000, 15999))
    assert 4 * d["up"] * K.table_stride(d) > K.SMEM_BUDGET_BYTES  # the table alone is over
    assert K.plan(*R.ratio(16000, 15999)) == (K.TILE_OUT, "global_taps")
    assert K.plan(*R.ratio(192000, 8000)) == (1120, "staged")
    assert K.plan(1, 119) == (K.TILE_OUT, "global_all") and K.plan(1, 114) == (224, "global_taps")
    for up, down in [(16000, 15999), (1, 24), (1, 119), (1, 480), (15999, 16000), (1, 12)]:
        for int16 in (False, True):
            assert K.smem_bytes(up, down, int16) <= K.SMEM_BUDGET_BYTES
        tile, mode = K.plan(up, down)
        assert tile % K.TILE_STEP == 0 and K.TILE_STEP <= tile <= K.TILE_OUT


# ---------------------------------------------------------------------------
# ratios over a block's 227 KB: resample.cu's plan, its mirror, the plain
# version
# ---------------------------------------------------------------------------

PLAN_RATES = [(192000, 8000, 24011), (16000, 15999, 8011)]
PLAN_IDS = ["192k_to_8k", "16000_to_15999"]


def _plan_bytes(d, tile, staged_taps):
    """csrc/resample.cu's layout by hand, float32 rows: the table [up,
    table_stride] when staged, two windows of fir_window(tile) samples in
    16-byte vectors plus one for the shift, the output row."""
    table = (d["up"] * K.table_stride(d) + 3) // 4 * 4 if staged_taps else 0
    window = -(-K.fir_window(tile, d) // 4) * 4 + 4
    return 4 * (table + 2 * window + tile)


def _mirror_plan(x, lengths, sr_in, sr_out, dtype):
    """csrc/resample.cu at its plan (`K.plan`) in numpy: per (row, tile of
    the plan's outputs) the window of fir_window(n) samples from the tile's
    first input, zero outside [0, the row's length) (the staged window that
    pp_mask zeroes in modes 0 and 1, PpGlobalWindow's masked reads in mode
    2: the same values), each output by `_outputs` over the table (staged,
    or read from device memory: the same taps); the row's first tile gives
    its output length, ceil(length · up / down)."""
    up, down = R.ratio(sr_in, sr_out)
    d = R.polyphase_design(up, down)
    tile, _ = K.plan(up, down)
    tab = d["table"].astype(dtype)
    B, T = x.shape
    n_out = R.output_length(T, sr_in, sr_out)
    y = np.empty((B, n_out), dtype)
    out_len = np.empty(B, np.int64)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), T)
        for j0 in range(0, n_out, tile):
            m = min(tile, n_out - j0)
            lo = K.first_input(j0, d)
            win = _stage(x[b].astype(dtype), lo, K.fir_window(m, d), n)
            y[b, j0 : j0 + m] = _outputs(np.arange(j0, j0 + m), lo, win, tab, d)
        out_len[b] = -(-int(lengths[b]) * up // down)
    return y, out_len


@pytest.mark.parametrize("sr_in,sr_out,T", PLAN_RATES, ids=PLAN_IDS)
def test_ratios_over_the_block_plan_mirror_and_plain(sr_in, sr_out, T):
    """192 kHz -> 8 kHz (down 24) takes 1,120 outputs a tile, the largest
    multiple of 224 whose two windows fit beside the staged table; 16,000
    -> 15,999 (up 15,999, 21 taps a phase) reads its table, alone over the
    block, from device memory at the whole tile. The mirror of the kernel at
    that plan, on ragged rows with garbage past each length, equals scipy on
    the zeroed rows in float64 (1e-12) and `resample_rows`' plain version in
    float32 (1e-5 of each row's max |x|), with its output lengths; the plain
    version (`resample_batch` on a CPU tensor) is within 1e-5 of scipy and of
    the JAX package's `resample_batch`."""
    up, down = R.ratio(sr_in, sr_out)
    d = R.polyphase_design(up, down)
    tile, mode = K.plan(up, down)
    if up == 1:
        assert (tile, mode) == (1120, "staged")
        assert _plan_bytes(d, tile, True) == K.smem_bytes(up, down) <= K.SMEM_BUDGET_BYTES
        assert _plan_bytes(d, tile + K.TILE_STEP, True) > K.SMEM_BUDGET_BYTES
    else:
        assert (tile, mode) == (K.TILE_OUT, "global_taps")
        assert _plan_bytes(d, K.TILE_STEP, True) > K.SMEM_BUDGET_BYTES  # no tile fits the table
        assert _plan_bytes(d, tile, False) == K.smem_bytes(up, down) <= K.SMEM_BUDGET_BYTES
    g = np.random.default_rng(up + down)
    x = (g.standard_normal((4, T)) * 3000).astype(np.float32)
    lengths = np.array([T, T - 1, T // 3 + 5, 0], np.int32)
    clean = np.where(np.arange(T)[None, :] < lengths[:, None], x, 0.0).astype(np.float32)
    got64, n_out = _mirror_plan(x.astype(np.float64), lengths, sr_in, sr_out, np.float64)
    want64 = scipy.signal.resample_poly(clean.astype(np.float64), up, down, axis=-1)
    np.testing.assert_allclose(got64, want64, rtol=0, atol=1e-12 * np.abs(want64).max())
    np.testing.assert_array_equal(n_out, R.output_lengths(torch.as_tensor(lengths), sr_in, sr_out).numpy())
    got32, _ = _mirror_plan(x, lengths, sr_in, sr_out, np.float32)
    plain, plain_n = K.resample_rows(torch.as_tensor(x), torch.as_tensor(lengths), sr_in, sr_out)
    assert plain_n.dtype == torch.int32 and np.array_equal(plain_n.numpy(), n_out)
    assert testing.resample_error(got32, plain.numpy(), x) < testing.RESAMPLE_KERNEL_REL_ROWMAX
    ours = R.resample_batch(torch.as_tensor(clean), sr_in, sr_out).numpy()
    assert testing.resample_error(ours, want64, clean) < testing.RESAMPLE_KERNEL_REL_ROWMAX
    try:
        theirs = np.asarray(jresample.resample_batch(jnp.asarray(clean), sr_in, sr_out))
    finally:  # 16,000 -> 15,999: the reference's 2 GB float64 block matrix is cached
        jresample._stream_design.cache_clear()
    assert theirs.shape == ours.shape
    assert testing.resample_error(ours, theirs, clean) < testing.RESAMPLE_KERNEL_REL_ROWMAX


# ---------------------------------------------------------------------------
# wrappers on the CPU
# ---------------------------------------------------------------------------


def test_wrappers_on_cpu_are_the_plain_versions():
    cfg = T_CONFIGS["mfcc39_48k"]
    b = pad_batch([np.round(s * 3000) for s in _inputs("mfcc39_48k")], cfg, dtype="int16")
    audio, lengths = torch.as_tensor(b.audio), torch.as_tensor(b.lengths)
    before = (K.launches, frontend.launches, frontend.resample_launches)
    x = audio.float()
    np.testing.assert_array_equal(
        K.polyphase_resample(x, 48000, 16000).numpy(),
        K.resample_reference(x, 48000, 16000).numpy(),
    )
    got = frontend.logmel_prefix(audio, lengths, cfg)
    assert (K.launches, frontend.launches, frontend.resample_launches) == before
    np.testing.assert_array_equal(
        got.numpy(), frontend.logmel_prefix_reference(audio, lengths, cfg).numpy()
    )
    assert got.shape == (4, cfg.num_frames(R.output_length(b.audio.shape[1], 48000, 16000)), 27)
    # int16 rows ≡ the same rows in float32, bitwise
    np.testing.assert_array_equal(got.numpy(), frontend.logmel_prefix(x, lengths, cfg).numpy())


def test_wrappers_raise_off_cpu_and_cuda():
    audio = torch.empty((2, 4800), dtype=torch.float32, device="meta")
    lengths = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.polyphase_resample(audio, 48000, 16000)
    with pytest.raises(ValueError, match="CUDA"):
        frontend.logmel_prefix(audio, lengths, T_CONFIGS["mfcc39_48k"])


def test_three_d_feed_raises():
    with pytest.raises(ValueError, match="flat rows"):
        tchain.extract_batch(np.zeros((1, 12, 480), np.int16), [4800],
                             T_CONFIGS["mfcc39_48k"], device="cpu")


# ---------------------------------------------------------------------------
# the resampling chain vs the goldens and the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("signal_name", GOLDEN_SIGNALS)
@pytest.mark.parametrize("config_name", RS_CONFIGS)
def test_extract_single_matches_golden(config_name, signal_name):
    g = load_golden(config_name, signal_name)
    feat = tchain.extract_single(g["signal_input"], T_CONFIGS[config_name], device="cpu")
    assert feat.shape == g["features"].shape and feat.dtype == torch.float32
    testing.assert_resampled_features_close(feat, g["features"])


@pytest.mark.parametrize("config_name", RS_CONFIGS)
def test_extract_batch_matches_jnp(config_name):
    jcfg, tcfg = J_CONFIGS[config_name], T_CONFIGS[config_name]
    sigs = _inputs(config_name)
    jb = j_pad_batch(sigs, jcfg)
    jfeat, jmask = jchain.extract_batch(jnp.asarray(jb.audio), jnp.asarray(jb.lengths), jcfg)
    tb = pad_batch(sigs, tcfg)
    feat, mask = tchain.extract_batch(tb.audio, tb.lengths, tcfg, device="cpu")
    F = tcfg.num_frames(R.output_length(tb.audio.shape[1], tcfg.input_sample_rate, 16000))
    assert feat.shape == (len(sigs), F, 39) == np.asarray(jfeat).shape
    testing.assert_resampled_features_close(feat, np.asarray(jfeat))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    for i, s in enumerate(sigs):  # the mask counts 16 kHz frames
        n16 = R.output_length(s.shape[0], tcfg.input_sample_rate, 16000)
        assert int(mask[i].sum()) == tcfg.num_frames(n16)


@pytest.mark.parametrize("config_name", RS_CONFIGS)
def test_extract_batch_matches_pallas_on_rs_slab_feed(config_name):
    """int16 rows through the port's CPU chain vs the JAX package's fused
    in-kernel resample on its int16 rs-slab feed (interpret mode), as
    tests/test_resample.py drives it: the port's F frames agree, the JAX
    capacity frames past F are zero. (tone_offbin is left out: at int16
    scale its quiet bins put the JAX package's own jnp and pallas backends
    4.8e-3 apart, the fp32 floor of a pure tone; the goldens hold it.)"""
    jcfg, tcfg = J_CONFIGS[config_name], T_CONFIGS[config_name]
    names = ("speechish", "short", "noise", "chirp")
    utts = [np.round(s * 3000) for s in _inputs(config_name, names)]
    blen = max(u.shape[0] for u in utts)
    lay = device_layout(jcfg, blen)
    assert type(lay).__name__ == "ResampleSlabLayout"
    slab = j_pad_batch(utts, jcfg, bucket_len=blen, layout=lay)
    jfeat, jmask = jchain.extract_batch(
        jnp.asarray(slab.audio.astype(np.int16)), jnp.asarray(slab.lengths), jcfg,
        backend="pallas", input_layout=slab.layout_kind,
    )
    jfeat, jmask = np.asarray(jfeat), np.asarray(jmask)
    tb = pad_batch(utts, tcfg, bucket_len=blen, dtype="int16")
    feat, mask = tchain.extract_batch(tb.audio, tb.lengths, tcfg, device="cpu")
    F = feat.shape[1]
    assert jfeat.shape[1] > F
    testing.assert_resampled_features_close(feat, jfeat[:, :F])
    np.testing.assert_array_equal(jfeat[:, F:], 0.0)
    np.testing.assert_array_equal(mask.numpy(), jmask[:, :F])


@pytest.mark.parametrize("config_name", RS_CONFIGS)
def test_float64_matches_jax_x64(config_name):
    jcfg = J_CONFIGS[config_name].replace(dtype="float64")
    tcfg = T_CONFIGS[config_name].replace(dtype="float64")
    sigs = _inputs(config_name, ("speechish", "noise", "short"))
    b = pad_batch(sigs, tcfg)
    feat, mask = tchain.extract_batch(b.audio, b.lengths, tcfg, device="cpu")
    assert feat.dtype == torch.float64
    with jax.enable_x64(True):
        jfeat, jmask = jchain.extract_batch(jnp.asarray(b.audio), jnp.asarray(b.lengths), jcfg)
        jfeat, jmask = np.asarray(jfeat), np.asarray(jmask)
    np.testing.assert_allclose(feat.numpy(), jfeat, rtol=0, atol=testing.FEATURE_F64_ATOL)
    np.testing.assert_array_equal(mask.numpy(), jmask)


@pytest.mark.parametrize("config_name", RS_CONFIGS)
def test_masking_invariance_and_dirty_tails(config_name):
    """An utterance in a padded batch gives the same bytes on its valid
    frames as alone at the same T, with garbage or zeros past its length,
    and exact zeros on pad frames."""
    cfg = T_CONFIGS[config_name]
    g = np.random.default_rng(9)
    utts = [(g.standard_normal(n) * 3000).astype(np.int16) for n in (30011, 48000, 0, 1201)]
    b = pad_batch(utts, cfg, dtype="int16")
    feat, mask = tchain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    dirty = np.where(np.arange(b.audio.shape[1]) < b.lengths[:, None], b.audio,
                     g.integers(-32768, 32767, b.audio.shape)).astype(np.int16)
    feat_d, _ = tchain.extract_batch(dirty, b.lengths, cfg, device="cpu")
    assert torch.equal(feat, feat_d)
    for i, u in enumerate(utts):
        fv = cfg.num_frames(tchain.valid_length(u.shape[0], cfg)) if u.shape[0] else 0
        alone = np.zeros((1, b.audio.shape[1]), np.int16)
        alone[0, : u.shape[0]] = u
        feat_s, _ = tchain.extract_batch(alone, [u.shape[0]], cfg, device="cpu")
        np.testing.assert_array_equal(feat[i, :fv].numpy(), feat_s[0, :fv].numpy())
        assert int(mask[i].sum()) == fv
        np.testing.assert_array_equal(feat[i, fv:].numpy(), 0.0)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_pad_batch_matches_jax_flat_feed(dtype):
    """mfcc39_48k batches are byte-equal to the reference flat feed
    (required_samples on the input-rate bucket, as the reference's)."""
    utts = [np.round(s * 3000) for s in _inputs("mfcc39_48k")]
    want = j_pad_batch(utts, J_CONFIGS["mfcc39_48k"], bucket_len=144000, pad_batch_to=6)
    got = pad_batch(utts, T_CONFIGS["mfcc39_48k"], bucket_len=144000, pad_batch_to=6,
                    dtype=dtype)
    assert got.audio.shape == want.audio.shape == (6, 144080)
    np.testing.assert_array_equal(got.audio, want.audio.astype(dtype))
    np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.mark.parametrize("config_name", RS_CONFIGS)
def test_logmel_single_matches_jax(config_name):
    sig = _inputs(config_name, ("speechish",))[0]
    got = tchain.logmel_single(sig, T_CONFIGS[config_name], device="cpu")
    want = jchain.logmel_single(sig, J_CONFIGS[config_name])
    assert set(got) == set(want)
    for key in ("frames", "pspec"):
        assert got[key].shape == want[key].shape
    prefix = torch.cat([got["logmel"], got["energy"][:, None]], dim=-1)
    testing.assert_prefix_close(
        prefix, np.concatenate([want["logmel"], want["energy"][:, None]], -1), 26
    )


def test_extract_entry_point_resamples():
    sig = _inputs("mfcc39_44k", ("noise",))[0]
    got = mfcc_tpu_torch.extract(sig, "mfcc39_44k", device="cpu")
    assert torch.equal(got, tchain.extract_single(sig, T_CONFIGS["mfcc39_44k"], device="cpu"))
    assert got.shape == load_golden("mfcc39_44k", "noise")["features"].shape
    pcm = np.round(sig * 3000)
    assert torch.equal(
        mfcc_tpu_torch.extract(pcm.astype(np.int16), "mfcc39_44k", device="cpu"),
        mfcc_tpu_torch.extract(pcm, "mfcc39_44k", device="cpu"),
    )
