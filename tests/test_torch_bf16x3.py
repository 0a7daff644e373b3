"""The port's bf16x3 DFT route ≡ the JAX package's `dft_passes="bf16x3"`.

The route computes the DFT as three bf16 products, hi·Wh + lo·Wh + hi·Wl,
against the hi/lo split of the window-folded, scaled DFT matrix. On the CPU
the front-end wrapper takes its plain version (`chain.bf16x3_power` inside
`logmel_stages`), so these tests hold:
  - the port's matrix and split (`constants.folded_dft`, `bf16_split`)
    against `kernel_constants` / `_bf16_split_np`, bitwise, and the kernel's
    ring-ordered layout (`frontend.bf16_matrix`: K-major core matrices of
    wgmma, cosine and sine of a bin in adjacent columns), un-permuted,
    against them;
  - a numpy mirror of the kernel's tile product (frames split to bf16 with
    round to nearest even, the un-permuted matrices, the sums step after
    step over k16 slices as ah·Wh, al·Wh, ah·Wl, |X|² from each cosine/sine
    column pair) against `chain.bf16x3_power`: 1e-6 of the row's max power
    (the products are exact; only the order of the fp32 sums differs);
  - the plain bf16x3 prefix against the JAX package's
    `fused_logmel_stages(dft_passes="bf16x3", interpret=True)` on loud bins
    (within 40 dB of the row max): 2e-4 in natural-log units. Measured on
    the golden signals: 4.4e-5 to 7.0e-5 over these configs; the reference
    splits its frames by round-half-up, the port by round to nearest even,
    and its mel projection is itself a bf16x3 product, so the two routes
    differ at their own error class;
  - both within 1e-3 of the jnp twin on loud bins, the reference's class
    (tests/test_pallas_kernels.py::test_bf16x3_path_runs_and_is_close;
    measured 1.8e-4 to 3.9e-4), and the port's within 1e-3 of the float64
    chain;
  - `dft_passes` validation and routing; in the fused-resample form the
    plan and layout with the input window and taps, a numpy mirror of its
    staging and product, and its plain prefix against the JAX package's
    bf16x3 on the same resampled rows.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.kernels import frontend as jfrontend
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu.testing.golden import golden_signals
from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.ops import constants as tconstants
from mfcc_tpu_torch.pipeline import pad_batch

PORT_VS_REFERENCE_LOUD = 2e-4
CLASS_LOUD = 1e-3  # the reference's bf16x3 gate

MATRIX_CASES = {
    "classic13": ("classic13", {}),
    "kaldi_mfcc": ("kaldi_mfcc", {}),
    "logmel80": ("logmel80", {}),
    "whisper80": ("whisper80", {}),
    "n_fft_404": ("classic13", {"n_fft": 404}),
    "frames_over_n_fft": ("kaldi_mfcc", {"win_len_s": 0.040, "n_fft": 512}),
    "unscaled_power": ("classic13", {"power_scale_nfft": False}),
}
PREFIX_CASES = {
    "classic13": ("classic13", {}),
    "kaldi_mfcc": ("kaldi_mfcc", {}),
    "kaldi_mfcc_dither": ("kaldi_mfcc", {"dither": 1.0}),
    "logmel80": ("logmel80", {}),
    "kaldi_fbank": ("kaldi_fbank", {}),
    "n_fft_404": ("classic13", {"n_fft": 404}),
}


def _configs(table, case):
    name, over = table[case]
    return T_CONFIGS[name].replace(**over), J_CONFIGS[name].replace(**over)


def _loud_max_abs(got, want, log_kind):
    g, w = testing.natural_log(got, log_kind), testing.natural_log(want, log_kind)
    lin = np.exp(w)
    loud = lin > lin.max(axis=-1, keepdims=True) * 10 ** (-testing.LOUD_DB / 10)
    return float((np.abs(g - w) * loud).max())


@pytest.mark.parametrize("case", sorted(MATRIX_CASES))
def test_matrix_and_split_match_kernel_constants_bitwise(case):
    tcfg, jcfg = _configs(MATRIX_CASES, case)
    ours = tconstants.folded_dft(tcfg)
    theirs = jfrontend.kernel_constants(jcfg)
    le, nb = min(tcfg.frame_length, tcfg.n_fft), tcfg.n_bins
    assert ours["dft"].shape == (le, 2 * nb)
    for mine, ref in (("dft", "dft"), ("dft_hi", "dft_h"), ("dft_lo", "dft_l")):
        want = np.asarray(theirs[ref]).astype(np.float32)
        np.testing.assert_array_equal(ours[mine], want[:le, : 2 * nb])
        assert not want[le:].any() and not want[:, 2 * nb:].any()  # the rest of the TPU layout is 0
    hi, lo = _unpermute(frontend.bf16_matrix(tcfg), tcfg)
    kp, nbp = frontend.bf16_dims(tcfg)
    assert hi.shape == (kp, 2 * nbp) and kp % 16 == 0 and nbp % 136 == 0
    for m, part in ((hi, ours["dft_hi"]), (lo, ours["dft_lo"])):
        cos, sin = m[:, 0::2], m[:, 1::2]
        np.testing.assert_array_equal(cos[:le, :nb], part[:, :nb])
        np.testing.assert_array_equal(sin[:le, :nb], part[:, nb:])
        assert not cos[le:].any() and not cos[:, nb:].any() and not sin[:, nb:].any()


def test_split_matches_the_reference_bitwise():
    g = np.random.default_rng(0)
    a = np.concatenate([
        g.standard_normal(4096) * 10.0 ** g.integers(-30, 30, 4096),
        [0.0, -0.0, 1.0, 1.00390625, 1.001953125, 1.005859375, 3e38, -3e38, 1e-40],
    ]).astype(np.float32)
    hi, lo = tconstants.bf16_split(a)
    h, l = jfrontend._bf16_split_np(a)
    np.testing.assert_array_equal(hi, h.astype(np.float32))
    np.testing.assert_array_equal(lo, l.astype(np.float32))
    assert hi.dtype == np.float32 and (hi.astype(ml_dtypes.bfloat16).astype(np.float32) == hi).all()


def _unpermute(mat, cfg):
    """`frontend.bf16_matrix`'s ring order [pass][k16 step][hi | lo][8-column
    group][K half][column][k] back to the hi and lo matrices [kp, 2·nbp],
    column 2b the cosine and 2b + 1 the sine of bin b."""
    kp, nbp = frontend.bf16_dims(cfg)
    steps, passes = kp // 16, nbp // 136
    assert mat.dtype == torch.bfloat16 and mat.numel() == 2 * kp * 2 * nbp
    m = mat.float().numpy().reshape(passes, steps, 2, 34, 2, 8, 8)
    m = m.transpose(2, 1, 4, 6, 0, 3, 5).reshape(2, kp, 2 * nbp)
    return m[0], m[1]


def _emulate_tile_power(frames, cfg, promote=None):
    """The kernel's bf16x3 DFT in numpy: each frame's first min(L, n_fft)
    samples, zero to kp, as bf16 hi = rn(g) and lo = rn(g - hi); the
    un-permuted ring matrices; the fp32 accumulator summed step after step
    over k16 slices, ah·Wh, then al·Wh, then ah·Wl, as the three wgmma
    products of a ring stage; with `promote` (the block plans' kBfPromote)
    each stretch of that many steps summed from 0 and added to the earlier
    stretches' fp32 sum, the last stretch's sum plus that sum at the end;
    re and im of each bin from its adjacent cosine and sine columns;
    re² + im²."""
    kp, nbp = frontend.bf16_dims(cfg)
    hi_m, lo_m = _unpermute(frontend.bf16_matrix(cfg), cfg)
    x = np.zeros(frames.shape[:-1] + (kp,), np.float32)
    le = min(cfg.frame_length, cfg.n_fft)
    x[..., :le] = frames[..., :le]
    ah = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    al = (x - ah).astype(ml_dtypes.bfloat16).astype(np.float32)
    y = np.zeros(frames.shape[:-1] + (2 * nbp,), np.float32)
    total = None
    for s, k in enumerate(range(0, kp, 16)):
        ks = slice(k, k + 16)
        y = y + ah[..., ks] @ hi_m[ks]
        y = y + al[..., ks] @ hi_m[ks]
        y = y + ah[..., ks] @ lo_m[ks]
        if promote and (s + 1) % promote == 0 and k + 16 < kp:
            total = y if total is None else total + y
            y = np.zeros_like(y)
    if total is not None:
        y = y + total
    re, im = y[..., 0::2], y[..., 1::2]
    return (re * re + im * im)[..., : cfg.n_bins]


@pytest.mark.parametrize("case", ["classic13", "n_fft_404", "frames_over_n_fft", "whisper80"])
def test_kernel_mirror_matches_plain_power(case):
    cfg, _ = _configs(MATRIX_CASES, case)
    g = np.random.default_rng(3)
    frames = (g.standard_normal((3, 7, cfg.frame_length)) * 3000).astype(np.float32)
    want = tchain.bf16x3_power(torch.as_tensor(frames), cfg).numpy()
    got = _emulate_tile_power(frames, cfg)
    rowmax = want.max(axis=-1, keepdims=True)
    assert float((np.abs(got - want) / rowmax).max()) < 1e-6


@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_plain_bf16x3_matches_reference_route(case):
    tcfg, jcfg = _configs(PREFIX_CASES, case)
    sigs = golden_signals()
    b = pad_batch([sigs[n] for n in ("noise", "speechish", "short", "tone_offbin")], tcfg)
    audio, lengths = torch.as_tensor(b.audio), torch.as_tensor(b.lengths)
    st = frontend.fused_logmel_stages(audio, lengths, tcfg, dft_passes="bf16x3")
    got = st["prefix"][..., : tcfg.n_mels].double().numpy()
    js = jfrontend.fused_logmel_stages(jnp.asarray(b.audio), jnp.asarray(b.lengths), jcfg,
                                       interpret=True, dft_passes="bf16x3")
    ref = np.asarray(js["logmel"], np.float64)
    twin = np.asarray(jchain.logmel_stages(jnp.asarray(b.audio), jnp.asarray(b.lengths), jcfg)["logmel"],
                      np.float64)
    f64 = frontend.logmel_prefix_reference(audio, lengths, tcfg.replace(dtype="float64"))
    k = tcfg.log_kind
    np.testing.assert_array_equal(st["frame_mask"].numpy(), np.asarray(js["frame_mask"]))
    assert _loud_max_abs(got, ref, k) < PORT_VS_REFERENCE_LOUD
    assert _loud_max_abs(got, twin, k) < CLASS_LOUD
    assert _loud_max_abs(ref, twin, k) < CLASS_LOUD
    assert _loud_max_abs(got, f64[..., : tcfg.n_mels].numpy(), k) < CLASS_LOUD
    np.testing.assert_allclose(st["prefix"][..., tcfg.n_mels].numpy(), np.asarray(js["energy"]),
                               rtol=1e-4, atol=1e-12)


def test_dft_passes_validation_and_routing():
    cfg = T_CONFIGS["classic13"]
    x, n = torch.zeros((1, 1600)), torch.tensor([1600])
    with pytest.raises(ValueError, match=r"dft_passes='bf16' not in \('radix4', 'bf16x3', 'fp32'\)"):
        frontend.fused_logmel_stages(x, n, cfg, dft_passes="bf16")
    with pytest.raises(ValueError, match="not in"):
        frontend.logmel_prefix(x, n.int(), cfg, dft_passes="HIGHEST")
    assert frontend.resolve_dft_passes(cfg) == "radix4"
    assert frontend.resolve_dft_passes(cfg.replace(n_fft=404)) == "fp32"
    assert frontend.resolve_dft_passes(cfg.replace(n_fft=404), "bf16x3") == "bf16x3"
    assert frontend.kernel_form(cfg) == "stockham"
    assert frontend.kernel_form(T_CONFIGS["whisper80"]) == "stockham"
    assert frontend.kernel_form(cfg, "fp32") == "stockham"
    assert frontend.kernel_form(cfg.replace(n_fft=404), "fp32") == "bluestein"
    assert frontend.kernel_form(cfg, "bf16x3") == "bf16x3"
    assert frontend.twiddle_count(512, "bf16x3") == 0 and frontend.fft_twiddles(512, "bf16x3").shape == (0, 2)
    # the bf16x3 layout: no twiddles or per-warp rows; 64 frames' signal span,
    # a ring of four 17,408-byte matrix stages and its mbarriers, the tile's
    # power rows (stride 292), energies and means, the projection's scratch
    # (194,752 B at classic13, one block an SM); n_fft 4096's power rows of
    # every bin are over the block, so it takes a block plan ("gather": the
    # tile's A, kp = 400, in the workspace); 60,000 filters, refused before (the packed table's filter
    # field), take "gather_out"; what is still refused is, on the card, a
    # matrix over the card's memory
    assert frontend.bf16_plan(cfg) == (64, 4) and frontend.bf16_power_stride(cfg) == 292
    assert frontend.bf16_dims(cfg) == (400, 272)
    assert frontend.smem_bytes(cfg, "bf16x3") == 194752
    assert frontend.layout_reason(cfg, "bf16x3") is None
    assert frontend.layout_reason(cfg.replace(n_fft=4096), "bf16x3") is None
    assert frontend.bf16_layout(cfg.replace(n_fft=4096))[0] == "gather"
    assert frontend.layout_reason(cfg.replace(n_mels=60000), "bf16x3") is None
    assert frontend.bf16_layout(cfg.replace(n_mels=60000))[0] == "gather_out"
    wide = cfg.replace(n_fft=131072, win_len_s=131072 / 16000)
    assert "over the card's 80,000,000,000 bytes" in frontend.bf16_matrix_reason(wide, 80 * 10**9)
    with pytest.raises(ValueError, match="not in"):
        tchain.logmel_stages(x, n, cfg, dft_passes="bf16x6")


def test_bf16x3_layout_takes_every_n_fft_the_parent_took():
    """`bf16_plan` takes 32 frames a block (the wgmma's upper 32 rows zero)
    and fewer ring stages where 64 frames' power rows do not fit, so every
    n_fft up to 2,079 at classic13 (1,791 at kaldi_mfcc with dither 1.0),
    the limits of the wmma form before it, still fits the block."""
    for name, over, top in (("classic13", {}, 2079), ("kaldi_mfcc", {"dither": 1.0}, 1791)):
        cfg = T_CONFIGS[name].replace(**over)
        for n in range(16, top + 1, 7):
            assert frontend.layout_reason(cfg.replace(n_fft=n), "bf16x3") is None, (name, n)
        assert frontend.layout_reason(cfg.replace(n_fft=top), "bf16x3") is None
    assert frontend.bf16_plan(T_CONFIGS["classic13"].replace(n_fft=1024)) == (64, 2)
    assert frontend.bf16_plan(T_CONFIGS["classic13"].replace(n_fft=2048))[0] == 32


def _a4(n):
    return (n + 3) & ~3


def _fused_bf16_layout(cfg, tile, stages, int16):
    """csrc/frontend.cu layout() of the fused resample's bf16x3 form, field
    by field (floats): the signal row (span + 1), the window, the packed
    mel weights and bin-filter words, the filters' offsets; at a 128-byte
    boundary the ring (17,408 B a stage) and its full and empty mbarriers;
    then the power rows, the frames' energies and means and the per-warp
    projection scratch, which the input window (16-byte vectors of the rows'
    samples plus one for the shift) overlays; then the tap table."""
    from mfcc_tpu_torch.kernels import resample as K
    from mfcc_tpu_torch.ops import resample as R

    span = (tile - 1) * cfg.frame_step + cfg.frame_length
    nnz = frontend.packed_count(cfg)
    head = _a4(span + 1) + _a4(max(cfg.frame_length, cfg.n_fft)) + 2 * _a4(nnz) + _a4(cfg.n_mels + 1)
    ring = (head + 31) // 32 * 32 + stages * 17408 // 4 + _a4(4 * stages)
    pws = (cfg.n_bins + 31) // 32 * 32 + 4
    rows = tile * pws + 2 * _a4(tile) + 8 * _a4(32 + cfg.n_mels)
    d = R.polyphase_design(*R.ratio(cfg.input_sample_rate, cfg.sample_rate))
    v = 8 if int16 else 4  # samples a 16-byte vector
    n_in = K.input_span(span + 1, d) if d["up"] > 1 else K.input_span(-(-(span + 1) // 7) * 7, d)
    fir = (-(-n_in // v) * v + v) * (2 if int16 else 4) // 4
    taps = d["up"] * K.table_stride(d)
    return 4 * (ring + max(rows, _a4(fir)) + _a4(taps))


@pytest.mark.parametrize("name", ["mfcc39_48k", "mfcc39_44k"])
def test_fused_resample_form_refuses_bf16x3(name):
    """bf16x3 in the fused-resample form, which the card refused before,
    runs. Here:
      - its plan (`bf16_plan`: 64 frames a block where the input window and
        the taps fit beside the ring, else 32) and layout, by hand, for int16
        and float32 rows; the route is the fused one (the float32 layout
        fits);
      - the kernel's staging and product in numpy (`_emulate_fused_staging`
        at the plan's tile, then `_emulate_tile_power`) against the plain
        bf16x3 power of the plain chain's resampled frames: 1e-5 of the row's
        max power;
      - the plain fused bf16x3 prefix (the wrapper's CPU path: the plain
        resample, then `chain.bf16x3_power`) against the JAX package's
        `fused_logmel_stages(dft_passes="bf16x3", interpret=True)` on the same
        resampled rows, loud bins within CLASS_LOUD (the reference's bf16x3
        gate), and against the jnp twin and the float64 chain at that gate;
        the masks equal."""
    from tests.test_torch_resample import _emulate_fused_staging
    from mfcc_tpu.ops import resample as jresample

    tcfg, jcfg = T_CONFIGS[name], J_CONFIGS[name]
    want_plan = {"mfcc39_48k": {True: (64, 4), False: (64, 3)},
                 "mfcc39_44k": {True: (64, 4), False: (32, 4)}}[name]
    for int16 in (True, False):
        tile, stages = frontend.bf16_plan(tcfg, int16)
        assert (tile, stages) == want_plan[int16]
        n = frontend.smem_bytes(tcfg, "bf16x3", int16)
        assert n == _fused_bf16_layout(tcfg, tile, stages, int16) <= 232448
        if stages < 4 or tile < 64:  # the next larger plan is over the block
            bigger = (tile, stages + 1) if stages < 4 else (64, 2)
            assert _fused_bf16_layout(tcfg, *bigger, int16) > 232448
    assert frontend.resample_route(tcfg, "bf16x3") == "fused"

    sr = tcfg.input_sample_rate
    g = np.random.default_rng(31)
    utts = [np.round(g.standard_normal(n) * 3000) for n in (sr, sr // 2 + 313, 1201)]
    b = pad_batch(utts, tcfg, dtype="int16")
    audio, lengths = torch.as_tensor(b.audio), torch.as_tensor(b.lengths)

    tile = frontend.bf16_plan(tcfg, True)[0]
    sig = _emulate_fused_staging(b.audio.astype(np.float32), b.lengths, tcfg, np.float32, tile=tile)
    x16, l16 = tchain.resample_input(audio, lengths, tcfg)
    F, S, L = tcfg.num_frames(x16.shape[1]), tcfg.frame_step, tcfg.frame_length
    idx = np.arange(F)[:, None] * S + np.arange(L)[None, :]
    got_p = _emulate_tile_power(sig[:, idx], tcfg)
    y = tchain.zero_beyond(tchain.preemphasis(x16, tcfg.preemph), l16)
    y = torch.nn.functional.pad(y, (0, max(0, (F - 1) * S + L - y.shape[1])))
    want_p = tchain.bf16x3_power(tchain.frame_signal(y, F, tcfg), tcfg).numpy()
    rowmax = want_p.max(axis=-1, keepdims=True) + 1e-30
    assert float((np.abs(got_p - want_p) / rowmax).max()) < 1e-5

    st = frontend.fused_logmel_stages(audio, lengths, tcfg, dft_passes="bf16x3")
    got = st["prefix"][..., : tcfg.n_mels].double().numpy()
    ya = jresample.resample_batch(jnp.asarray(b.audio, jnp.float32), sr, tcfg.sample_rate)
    ja = jresample.output_lengths(jnp.asarray(b.lengths), sr, tcfg.sample_rate)
    js = jfrontend.fused_logmel_stages(ya, ja, jcfg, interpret=True, dft_passes="bf16x3")
    ref = np.asarray(js["logmel"], np.float64)[:, : got.shape[1]]
    twin = np.asarray(jchain.logmel_stages(ya, ja, jcfg)["logmel"], np.float64)
    np.testing.assert_array_equal(st["frame_mask"].numpy(), np.asarray(js["frame_mask"])[:, : got.shape[1]])
    f64 = frontend.logmel_prefix_reference(audio, lengths, tcfg.replace(dtype="float64"))
    k = tcfg.log_kind
    assert _loud_max_abs(got, ref, k) < CLASS_LOUD
    assert _loud_max_abs(got, twin, k) < CLASS_LOUD
    assert _loud_max_abs(got, f64[..., : tcfg.n_mels].numpy(), k) < CLASS_LOUD


def test_bf16x3_in_float64_raises():
    cfg = T_CONFIGS["classic13"].replace(dtype="float64")
    with pytest.raises(NotImplementedError, match="float32"):
        tchain.logmel_stages(torch.zeros((1, 1600)), torch.tensor([1600]), cfg, dft_passes="bf16x3")
