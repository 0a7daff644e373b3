"""The port's front-end (`mfcc_tpu_torch/kernels/frontend.py`) ≡ the JAX
package's fused Pallas front-end ≡ its jnp twin.

On the CPU the wrapper runs its plain version, `logmel_prefix_reference`;
it is held against `fused_logmel_stages(..., interpret=True)["prefix_fp"]`
and `chain.logmel_stages` at the gates of
tests/test_pallas_kernels.py::test_kernel_matches_jnp_twin (both fp32, only
roundoff order differs): log-mel within 2e-5 on loud bins (within 40 dB of
the row max), linear-domain 1e-5 of the row max elsewhere, energy rtol 1e-5.

The CUDA kernel cannot run here. `_emulate_kernel` mirrors its loop
structure in numpy — 32-frame tiles staged with pre-emphasis across tile
starts, no DFT for frames past a row's length, the radix-8 Stockham stages
on the host's twiddle and output-base tables, the real split, the Bluestein
form (chirp, the P-point stages, the filter product folded into the
inverse's loads, the inverse as forward stages on the conjugate), the
balanced lane-split projection over the packed mel bands in its summation
order, each feature kind's epilogue (log, raw PLP lanes, the spectrogram's
identity projection, SSC's clamped centroids) and the energy — so the
index algebra is tested on the CPU; with the block plan (`frontend.fft_plan`)
it runs each stage's butterflies, the real split and the projection by the
block's 256 thread ranks, each output written once, the block sums in the
kernel's order. tests/test_torch_gpu.py holds the kernel itself to the
plain version on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.kernels import fused_logmel_stages
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu.pipeline import pad_batch as j_pad_batch
from mfcc_tpu.testing.golden import golden_signals
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.ops import constants as tconstants
from mfcc_tpu_torch.ops import dither as tdither
from mfcc_tpu_torch.testing import assert_prefix_close

CONFIGS = ["classic13", "classic13_deltas"]
SIGNALS = ("noise", "speechish", "short", "tone_offbin")
BOUNDARY_LENGTHS = [0, 1, 399, 400, 401, 32 * 160 - 1, 32 * 160, 32 * 160 + 1]


def _batch(config_name, names=SIGNALS):
    sigs = golden_signals()
    chosen = [sigs[n] for n in names]
    cfg = J_CONFIGS[config_name]
    b = j_pad_batch(chosen, cfg, bucket_len=max(s.shape[0] for s in chosen))
    return b.audio, b.lengths


def _reference(audio, lengths, cfg):
    return frontend.logmel_prefix_reference(
        torch.as_tensor(audio), torch.as_tensor(lengths), cfg
    ).numpy()


@pytest.mark.parametrize("config_name", CONFIGS)
def test_reference_matches_pallas_prefix(config_name):
    audio, lengths = _batch(config_name)
    cfg = T_CONFIGS[config_name]
    F = cfg.num_frames(audio.shape[1])
    fused = fused_logmel_stages(
        jnp.asarray(audio), jnp.asarray(lengths), J_CONFIGS[config_name],
        interpret=True,
    )
    want = np.asarray(fused["prefix_fp"])[:, :F]
    got = _reference(audio, lengths, cfg)
    assert got.shape == (len(SIGNALS), F, cfg.n_mels + 1)
    assert_prefix_close(got, want, cfg.n_mels)


@pytest.mark.parametrize("config_name", CONFIGS)
def test_reference_matches_jnp_stages(config_name):
    audio, lengths = _batch(config_name)
    cfg = T_CONFIGS[config_name]
    twin = jchain.logmel_stages(
        jnp.asarray(audio), jnp.asarray(lengths), J_CONFIGS[config_name]
    )
    want = np.concatenate(
        [np.asarray(twin["logmel"]), np.asarray(twin["energy"])[..., None]], -1
    )
    assert_prefix_close(_reference(audio, lengths, cfg), want, cfg.n_mels)


@pytest.mark.parametrize("preemph", [0.0, 0.97])
def test_dirty_tail_zeroed(preemph):
    """Garbage past each length must not reach the output: zeroing follows
    pre-emphasis, so y[length] is 0 too, and nothing relies on zero
    padding (test_pallas_kernels.py::test_dirty_tail_zeroed_without_preemph
    is the model)."""
    cfg = T_CONFIGS["classic13"].replace(preemph=preemph)
    g = np.random.default_rng(3)
    T, n = 24000, 17000
    audio = g.standard_normal((1, T)).astype(np.float32)  # dirty tail
    clean = audio.copy()
    clean[0, n:] = 0.0
    lengths = np.array([n], np.int32)
    got = _reference(audio, lengths, cfg)
    np.testing.assert_array_equal(got, _reference(clean, lengths, cfg))
    twin = jchain.logmel_stages(
        jnp.asarray(clean), jnp.asarray(lengths),
        J_CONFIGS["classic13"].replace(preemph=preemph),
    )
    want = np.concatenate(
        [np.asarray(twin["logmel"]), np.asarray(twin["energy"])[..., None]], -1
    )
    assert_prefix_close(got, want, cfg.n_mels)


def test_int16_rows_equal_float_rows_bitwise():
    cfg = T_CONFIGS["classic13_deltas"]
    g = np.random.default_rng(5)
    audio = (g.standard_normal((3, 9000)) * 3000).astype(np.int16)
    lengths = np.array([9000, 5000, 0], np.int32)
    np.testing.assert_array_equal(
        _reference(audio, lengths, cfg),
        _reference(audio.astype(np.float32), lengths, cfg),
    )


def test_boundary_lengths_match_jnp():
    """Lengths at the frame edges and around the kernel's 32-frame tile
    (5,120 samples); a length-0 row is the clamp constant everywhere."""
    cfg = T_CONFIGS["classic13"]
    g = np.random.default_rng(7)
    audio = (g.standard_normal((len(BOUNDARY_LENGTHS), 6000)) * 3000).astype(np.float32)
    lengths = np.array(BOUNDARY_LENGTHS, np.int32)
    for i, n in enumerate(BOUNDARY_LENGTHS):
        audio[i, n:] = 0.0
    got = _reference(audio, lengths, cfg)
    twin = jchain.logmel_stages(
        jnp.asarray(audio), jnp.asarray(lengths), J_CONFIGS["classic13"]
    )
    want = np.concatenate(
        [np.asarray(twin["logmel"]), np.asarray(twin["energy"])[..., None]], -1
    )
    assert_prefix_close(got, want, cfg.n_mels)
    eps = np.float32(cfg.log_eps)
    np.testing.assert_allclose(got[0, :, : cfg.n_mels], np.log(eps), rtol=1e-6)
    np.testing.assert_array_equal(got[0, :, cfg.n_mels], eps)


def test_wrapper_on_cpu_is_the_plain_version():
    cfg = T_CONFIGS["classic13_deltas"]
    audio, lengths = _batch("classic13_deltas")
    before = frontend.launches
    got = frontend.logmel_prefix(
        torch.as_tensor(audio), torch.as_tensor(lengths), cfg
    )
    assert frontend.launches == before  # no kernel launched on the CPU
    np.testing.assert_array_equal(got.numpy(), _reference(audio, lengths, cfg))


def test_wrapper_raises_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a card must raise, not fall back."""
    cfg = T_CONFIGS["classic13"]
    audio = torch.empty((2, 1000), dtype=torch.int16, device="meta")
    lengths = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        frontend.logmel_prefix(audio, lengths, cfg)


def test_wrapper_refuses_configs_outside_the_slice():
    """Nothing is refused for its layout now: 60,000 filters, refused
    before (over the packed table's filter field) on both routes, take
    the wide plan (without it "gather_sums") and bf16x3's "gather_out", and the wrapper's plain
    version here ≡ the JAX package's jnp stages within the prefix gates (the
    bf16x3 opt-in takes n_fft 4096 in a block plan; what its card
    wrapper still refuses is a matrix over the card's memory); n_fft 7,001, which it refused before
    (275,360 B in the gather plan), runs with the packed bands read from
    device memory ("gather_bands", 222,384 B), here as its plain version ≡
    the JAX package's jnp stages; n_fft 5,393, refused before that
    (232,464 B in the block plan), runs in the gather plan, and n_fft 4096
    (420,160 B in the warp plan) in the block plan (161,136 B), here as
    their plain versions.
    Centered framing of resampled rows, which it refused before, runs: whisper80 fed 48 kHz takes the split route
    (resample.cu, then the plain form's centered staging) on the card, and
    here its plain version, whose prefix is the JAX package's resample and
    jnp stages (the reflection of the 16 kHz rows at each row's output
    length) within the prefix gates (whisper80's narrow Slaney filters at
    the log-mel gate, 1e-4), with no launch."""
    audio = torch.zeros((1, 1000))
    lengths = torch.tensor([1000], dtype=torch.int32)
    c60k, j60k = T_CONFIGS["classic13"].replace(n_mels=60000), J_CONFIGS["classic13"].replace(n_mels=60000)
    assert frontend.layout_reason(c60k) is None and frontend.fft_plan(c60k) == "wide"
    assert frontend.fft_layout(c60k, wide=False)[0] == "gather_sums"
    assert frontend.layout_reason(c60k, "bf16x3") is None and frontend.bf16_layout(c60k)[0] == "gather_out"
    x = np.round(np.random.default_rng(60000).standard_normal((2, 4000)) * 3000).astype(np.float32)
    lens = np.array([4000, 2500], np.int32)
    x[1, 2500:] = 0.0
    got60k = frontend.logmel_prefix(torch.as_tensor(x), torch.as_tensor(lens), c60k)
    st = jchain.logmel_stages(jnp.asarray(x), jnp.asarray(lens), j60k)
    want = np.concatenate([np.asarray(st["logmel"]), np.asarray(st["energy"])[..., None]], axis=-1)
    assert got60k.shape == want.shape
    assert_prefix_close(got60k.numpy(), want, c60k.n_mels)
    wide = T_CONFIGS["classic13"].replace(n_fft=131072, win_len_s=131072 / 16000)
    assert "over the card's" in frontend.bf16_matrix_reason(wide, 80 * 10**9)
    c7001, j7001 = T_CONFIGS["classic13"].replace(n_fft=7001), J_CONFIGS["classic13"].replace(n_fft=7001)
    assert frontend.layout_reason(c7001) is None and frontend.fft_plan(c7001) == "gather_bands"
    x = np.round(np.random.default_rng(7001).standard_normal((2, 9000)) * 3000).astype(np.float32)
    lens = np.array([9000, 5001], np.int32)
    x[1, 5001:] = 0.0
    got7001 = frontend.logmel_prefix(torch.as_tensor(x), torch.as_tensor(lens), c7001)
    st = jchain.logmel_stages(jnp.asarray(x), jnp.asarray(lens), j7001)
    want = np.concatenate([np.asarray(st["logmel"]), np.asarray(st["energy"])[..., None]], axis=-1)
    assert got7001.shape == want.shape
    assert_prefix_close(got7001.numpy(), want, c7001.n_mels)
    c5393 = T_CONFIGS["classic13"].replace(n_fft=5393)
    assert frontend.layout_reason(c5393) is None and frontend.fft_plan(c5393) == "gather_global"
    got5393 = frontend.logmel_prefix(audio, lengths, c5393)
    np.testing.assert_array_equal(got5393.numpy(), _reference(audio.numpy(), lengths.numpy(), c5393))
    c4096 = T_CONFIGS["classic13"].replace(n_fft=4096)
    assert frontend.layout_reason(c4096) is None and frontend.fft_plan(c4096) == "block"
    got4096 = frontend.logmel_prefix(audio, lengths, c4096)
    assert got4096.shape == (1, c4096.num_frames(1000), c4096.n_mels + 1)
    np.testing.assert_array_equal(got4096.numpy(), _reference(audio.numpy(), lengths.numpy(), c4096))
    from mfcc_tpu.ops import resample as jresample
    from mfcc_tpu_torch import testing

    tcfg = T_CONFIGS["whisper80"].replace(input_sample_rate=48000)
    jcfg = J_CONFIGS["whisper80"].replace(input_sample_rate=48000)
    assert frontend.resample_route(tcfg) == "split" and frontend.layout_reason(tcfg) is None
    g = np.random.default_rng(21)
    lens = np.array([48000, 20011, 1500], np.int32)
    x = np.round(g.standard_normal((3, 48000)) * 3000).astype(np.float32)
    x[np.arange(48000)[None, :] >= lens[:, None]] = 0.0
    before = (frontend.launches, frontend.split_launches, frontend.resample_launches)
    got = frontend.logmel_prefix(torch.as_tensor(x), torch.as_tensor(lens), tcfg)
    assert (frontend.launches, frontend.split_launches, frontend.resample_launches) == before
    y = jresample.resample_batch(jnp.asarray(x), 48000, 16000)
    n16 = jresample.output_lengths(jnp.asarray(lens), 48000, 16000)
    st = jchain.logmel_stages(y, n16, jcfg)
    want = np.concatenate([np.asarray(st["logmel"]), np.asarray(st["energy"])[..., None]], axis=-1)
    assert got.shape == want.shape == (3, tcfg.num_frames(16000), tcfg.n_mels + 1)
    mel = tchain.device_constants(tcfg, torch.device("cpu"), torch.float32)["mel"]
    narrow = testing.narrow_lanes(mel)
    testing.assert_prefix_close(got, want, tcfg.n_mels, tcfg.log_kind, narrow=narrow)


def _twiddles64(n_fft):
    """frontend.fft_twiddles' Stockham table in complex128: the real split's
    e^{-2πik/n_fft}, k <= n_fft/4, then each later stage's twists
    e^{-2πi·r·(j mod ns)/(ns·R)} at j·(R-1) + r - 1."""
    parts = [np.exp(-2j * np.pi * np.arange(n_fft // 4 + 1) / n_fft)]
    ns = 1
    for s, R in enumerate(frontend.radices(n_fft)):
        j = np.arange(n_fft // 2 // R)
        if s:
            parts.append(np.exp(-2j * np.pi * np.outer(j % ns, np.arange(1, R)) / (ns * R)).ravel())
        ns *= R
    return np.concatenate(parts)


def test_fft_twiddles_table():
    """n_fft 512 (8·8·4): the split's 129 entries, then 32 butterflies × 7
    twists of stage 1 and 64 × 3 of stage 2, each rounded once from float64;
    the stages' output bases (j - k)·R + k."""
    tw = frontend.fft_twiddles(512, "stockham")
    assert tw.shape == (129 + 32 * 7 + 64 * 3, 2) and tw.dtype == np.float32
    np.testing.assert_array_equal(tw[:, 0] + 1j * tw[:, 1], _twiddles64(512).astype(np.complex64))
    np.testing.assert_array_equal(tw[:129, 0], np.cos(2 * np.pi * np.arange(129) / 512).astype(np.float32))
    bases = frontend.stage_bases(512)
    j = np.arange(64)
    np.testing.assert_array_equal(bases, np.concatenate([8 * np.arange(32), (np.arange(32) // 8) * 64
                                                         + np.arange(32) % 8, j]))


@pytest.mark.parametrize("n_fft,form,count", [(400, "stockham", 421), (480, "stockham", 593),
                                              (404, "bluestein", 1457), (405, "bluestein", 2530),
                                              (1024, "stockham", 1153), (2047, "bluestein", 16895)])
def test_dft_forms_and_twiddle_tables(n_fft, form, count):
    """The form each n_fft takes at classic13, its radices, and its
    float64-built table: the split's quarter circle and the stages' twists
    for the Stockham form; for the Bluestein form the split (even n_fft),
    the P-point stages' twists, the chirp and the filter spectrum (n_fft
    2047, which took the direct DFT before, at P = 4,096 = 8·8·8·8)."""
    assert frontend.dft_form(T_CONFIGS["classic13"].replace(n_fft=n_fft)) == form
    tw = frontend.fft_twiddles(n_fft, form)
    assert tw.shape == (count, 2) == (frontend.twiddle_count(n_fft, form), 2)
    if form == "stockham":
        r = frontend.radices(n_fft)
        assert np.prod(r) == n_fft // 2 and set(r) <= {2, 3, 4, 5, 8}
        want = _twiddles64(n_fft)
        assert len(frontend.stage_bases(n_fft)) == sum(n_fft // 2 // R for R in r)
    elif form == "bluestein":
        want = _bluestein64(n_fft)
        P = frontend.bluestein_dims(n_fft)[2]
        assert len(frontend.stage_bases(n_fft, form)) == sum(P // R for R in frontend.radices(2 * P))
    np.testing.assert_array_equal(tw[:, 0] + 1j * tw[:, 1], want.astype(np.complex64))


def test_radix_plans():
    """8s first, then one 4 or 2, then 3s and 5s; powers of two take the
    Stockham form too (three passes at 256 points)."""
    assert frontend.radices(400) == (8, 5, 5)
    assert frontend.radices(480) == (8, 2, 3, 5)
    assert frontend.radices(512) == (8, 8, 4) and frontend.radices(2048) == (8, 8, 8, 2)
    assert frontend.radices(404) is None and frontend.radices(401) is None
    assert frontend.dft_form(T_CONFIGS["classic13"]) == "stockham"
    assert frontend.dft_form(T_CONFIGS["classic13"].replace(n_fft=2)) == "bluestein"
    assert "radix2" not in frontend.DFT_FORMS and "direct" not in frontend.DFT_FORMS
    assert frontend.smem_bytes(T_CONFIGS["whisper80"]) == 62832  # three blocks an SM


# sizes the layout refuses: none. With dither 1.0 the parent's layout kept a
# second x row (span + 1 floats) and refused n_fft 1944, 2000 and 2048 at
# kaldi_mfcc; the dither now stages in the signal row itself, one float wider
PARENT_REFUSED = {"classic13": (), "kaldi_mfcc_dither": ()}
# the top of the range every n_fft fits at classic13: from n_fft 5,393 (the
# Bluestein form's P = 8,192) only the gather plan fits, and the Bluestein
# rows of n_fft 6,205 (P = 10,240) and its packed bands are over the block in
# the parent's plans: it takes "gather_bands"
TOP_N_FFT = 6204


@pytest.mark.parametrize("case", sorted(PARENT_REFUSED))
def test_every_n_fft_from_16_to_2100_fits_a_form(case):
    """Every n_fft from 16 to TOP_N_FFT takes the Stockham or the Bluestein
    form (no direct DFT is left) in a plan whose layout fits the block, but
    those the parent layout refused too: the warp plan where it fits, else
    the block plan, 4, 2 or 1 frames a block at once with its tables
    staged, else with them in device memory, else the gather plan with them
    in device memory (`fft_layout` takes the first of `FFT_LAYOUTS` that
    fits; at a 10 ms hop the gather plan with staged tables is never the
    first); the "fp32" route takes the same form as "radix4" at every size.
    6,205, refused before, takes "gather_bands" (the packed bands read from
    device memory)."""
    cfg = T_CONFIGS["classic13"] if case == "classic13" else T_CONFIGS["kaldi_mfcc"].replace(dither=1.0)
    sizes = range(16, TOP_N_FFT + 1)
    refused = [n for n in sizes if frontend.layout_reason(cfg.replace(n_fft=n))]
    assert refused == list(PARENT_REFUSED[case])
    forms, layouts = set(), set()
    budget = frontend.rs_kernel.SMEM_BUDGET_BYTES
    for n in sizes:
        c = cfg.replace(n_fft=n)
        form, layout = frontend.dft_form(c), frontend.fft_layout(c)
        assert frontend.kernel_form(c, "fp32") == frontend.kernel_form(c) == form
        forms.add(form)
        layouts.add(layout)
        earlier = frontend.FFT_LAYOUTS[: frontend.FFT_LAYOUTS.index(layout)]
        assert all(frontend._fft_smem(c, form, pl, True, g) > budget for pl, g in earlier), (n, layout)
    assert forms == {"stockham", "bluestein"}
    assert {pl for pl, _ in layouts} == set(frontend.FFT_PLANS) - {"gather", "cluster", "wide", "gather_bands",
                                                                   "gather_rows", "gather_sums"}
    over = T_CONFIGS["classic13"].replace(n_fft=TOP_N_FFT + 1)
    assert frontend.layout_reason(over) is None and frontend.fft_plan(over) == "gather_bands"


def test_bluestein_sizes_and_layouts():
    """n_fft 404: Q = K = 202 packed points, P = 512 (8·8·8: three stages,
    fewer than 405 = 3⁴·5 or 480 = 8·4·3·5), 114,384 B a block: two blocks
    an SM (233,472 B / 2 less 1 KB a block). n_fft 551 (odd): Q = 551, K =
    276, P = 960 (8·8·3·5), 201,264 B, one block an SM. The layout mirrors
    csrc/frontend.cu: the Stockham head, the twiddle table, the P-point
    stages' bases, and two rows of P + P/8 + 1 float2 a warp."""
    c13 = T_CONFIGS["classic13"]
    assert frontend.bluestein_dims(404) == (202, 202, 512) and frontend.radices(1024) == (8, 8, 8)
    assert frontend.bluestein_dims(551) == (551, 276, 960) and frontend.radices(1920) == (8, 8, 3, 5)
    assert frontend.filter_count(404) == 257 and frontend.filter_count(551) == 960
    assert frontend.row_floats(404, "bluestein") == 1156
    assert frontend.smem_bytes(c13.replace(n_fft=404)) == 114384 <= 233472 // 2 - 1024
    assert frontend.smem_bytes(c13.replace(n_fft=404), "fp32") == 114384
    assert frontend.smem_bytes(c13.replace(n_fft=551)) == 201264
    assert frontend.dft_form(c13.replace(n_fft=404)) == frontend.dft_form(c13.replace(n_fft=551)) == "bluestein"
    # the filter of an even n_fft is even: the kernel reads entry min(n, P - n)
    h = frontend.bluestein_filter(404)
    np.testing.assert_allclose(h[1:], h[1:][::-1], rtol=0, atol=1e-15)


def test_dither_layouts_meet_the_occupancy_goals():
    """The dither stages in the signal row, one float wider (x[t0-1 ..
    t0+span)), with no second x row: kaldi_mfcc with dither 1.0 takes
    71,232 B, three blocks an SM (233,472 B / 3 less 1 KB a block), as
    without dither (71,216 B); the Bluestein form at n_fft 404 with dither
    two (233,472 / 2 less 1 KB); bf16x3 with dither its 64 frames and four
    ring stages, as without."""
    kaldi = T_CONFIGS["kaldi_mfcc"]
    assert frontend.smem_bytes(kaldi.replace(dither=1.0)) == 71232 <= 233472 // 3 - 1024
    assert frontend.smem_bytes(kaldi) == 71216
    for name in ("classic13", "kaldi_mfcc"):
        c = T_CONFIGS[name].replace(n_fft=404, dither=1.0)
        assert frontend.dft_form(c) == "bluestein"
        assert frontend.smem_bytes(c) <= 233472 // 2 - 1024, name
    for name in ("classic13", "kaldi_mfcc"):
        c = T_CONFIGS[name]
        assert frontend.bf16_plan(c.replace(dither=1.0)) == frontend.bf16_plan(c) == (64, 4)


def test_mel_bands_cover_every_weight():
    """The bands hold every nonzero weight; the packed table holds each of
    them exactly once (scattered back it is the dense matrix), an all-zero
    column one zero weight at bin 0."""
    mel = torch.as_tensor(tconstants.chain_constants(T_CONFIGS["classic13"])["mel"])
    mel = torch.cat([mel, torch.zeros(mel.shape[0], 1, dtype=mel.dtype)], dim=1)
    lo, hi = frontend.mel_bands(mel)
    k = torch.arange(mel.shape[0])[:, None]
    inside = (k >= lo.long()) & (k < hi.long())
    assert not bool(((mel != 0) & ~inside).any())
    assert (int(lo[-1]), int(hi[-1])) == (0, 0)  # all-zero column: empty band
    nz = (mel[:, 0] != 0).nonzero()
    assert int(lo[0]) == int(nz.min()) and int(hi[0]) == int(nz.max()) + 1
    off, index = frontend.mel_packed(mel)
    assert int(off[-1]) == index.numel() == int((hi - lo).sum()) + 1
    assert torch.equal(index[off[:-1].long()] // mel.shape[1], lo.long())  # each band's start
    assert index.unique().numel() == index.numel()  # each entry once
    dense = torch.zeros(mel.numel(), dtype=mel.dtype)
    dense[index] = mel.reshape(-1)[index]
    assert torch.equal(dense.reshape(mel.shape), mel)
    assert int(off[-1] - off[-2]) == 1 and int(index[-1]) == mel.shape[1] - 1  # bin 0, last column
    meta = frontend.packed_meta(off, index, mel.shape[1]).long()
    assert torch.equal(meta & 0x7FFFFFFF, index // mel.shape[1])  # each weight's bin, no filter
    assert torch.equal((meta < 0).nonzero()[:, 0], off[1:].long() - 1)  # each filter's last


def test_layouts_meet_the_occupancy_goal():
    """Three blocks of 256 threads an SM: the SM's 233,472 B of shared
    memory over 3, less the 1 KB each block reserves, is 76,800 B; the
    packed bands bring classic13, logmel80 and whisper80 under it."""
    for name in ("classic13", "classic13_deltas", "logmel80", "whisper80"):
        assert frontend.smem_bytes(T_CONFIGS[name]) <= 233472 // 3 - 1024, name
    assert frontend.smem_bytes(T_CONFIGS["classic13"]) == 71200
    assert frontend.chunk(459) == 15 and frontend.chunk(470) == 15 and frontend.chunk(448) == 15


def test_n_fft_2048_matches_jnp_stages():
    """n_fft 2048 at 26 filters fits the block now (its 1,915 packed
    weights, where the dense matrix took 104 KB): the plain version ≡ the
    JAX package's jnp chain."""
    cfg = T_CONFIGS["classic13"].replace(n_fft=2048)
    assert frontend.layout_reason(cfg) is None and frontend.packed_count(cfg) == 1915
    audio, lengths = _batch("classic13")
    twin = jchain.logmel_stages(jnp.asarray(audio), jnp.asarray(lengths),
                                J_CONFIGS["classic13"].replace(n_fft=2048))
    want = np.concatenate([np.asarray(twin["logmel"]), np.asarray(twin["energy"])[..., None]], -1)
    assert_prefix_close(_reference(audio, lengths, cfg), want, cfg.n_mels)


# ---------------------------------------------------------------------------
# numpy mirror of csrc/frontend.cu
# ---------------------------------------------------------------------------

TILE = 32


def _reflect(t, n, kind):
    """chain.reflect_index in numpy (n >= 1)."""
    if kind == "center":
        m = np.mod(t, 2 * n)
        return np.where(m < n, m, 2 * n - 1 - m)
    m = np.mod(t, max(2 * n - 2, 1))
    return np.where(m < n, m, 2 * n - 2 - m)


def _stockham(z, n_fft, w, form="stockham", team=None):
    """The kernel's Stockham stages on rows z [nf, H] (H = fft_points:
    n_fft/2, or P for the Bluestein form) with the twiddle table w
    (`frontend.fft_twiddles` order): stage s of radix R after ns points,
    butterfly j < H/R reads src[j + r·H/R], twists input r by w[after the
    split and the earlier stages + j·(R-1) + r - 1] (stage 0: none), takes
    the R-point DFT and writes dst[base[j] + q·ns] with the host's output
    bases (`frontend.stage_bases`). With a team size (the block plan's 256)
    each thread rank takes butterflies rank, rank + team, ... of a stage,
    one rank after another, into a row of NaNs: every input a butterfly
    reads was written by the stage before, and every output is written
    once."""
    H = frontend.fft_points(n_fft, form)
    bases = frontend.stage_bases(n_fft, form)
    src, ns, tw, b0 = z, 1, frontend.split_count(n_fft), 0
    for s, R in enumerate(frontend.radices(2 * H)):
        hr = H // R
        q = np.arange(R)
        dft = np.exp(-2j * np.pi * np.outer(q, q) / R).astype(z.dtype)
        t = w[tw : tw + hr * (R - 1)].reshape(hr, R - 1) if s else None
        d = bases[b0 : b0 + hr]
        dst = np.full_like(src, np.nan)
        written = np.zeros(H, np.int64)
        ranks = [np.arange(hr)] if team is None else [np.arange(r, hr, team) for r in range(min(team, hr))]
        for j in ranks:
            v = np.stack([src[:, j + r * hr] for r in range(R)])  # [R, nf, len(j)]
            assert not np.isnan(v).any()
            if s:
                v[1:] = v[1:] * t[j].T[:, None, :]
            out = np.einsum("qr,rfj->qfj", dft, v)
            for qq in range(R):
                dst[:, d[j] + qq * ns] = out[qq]
                written[d[j] + qq * ns] += 1
        assert (written == 1).all()
        if s:
            tw += hr * (R - 1)
        b0 += hr
        src, ns = dst, ns * R
    return src


def _bluestein64(n_fft):
    """frontend.fft_twiddles' Bluestein table in complex128: the split
    (even n_fft) and the P-point stages' twists as `_twiddles64` lays them
    out, the chirp e^{-iπ (n² mod 2Q)/Q}, n < Q, and the first
    `filter_count` entries of the filter spectrum."""
    q, _, P = frontend.bluestein_dims(n_fft)
    parts = [np.exp(-2j * np.pi * np.arange(frontend.split_count(n_fft)) / n_fft)]
    ns = 1
    for s, R in enumerate(frontend.radices(2 * P)):
        j = np.arange(P // R)
        if s:
            parts.append(np.exp(-2j * np.pi * np.outer(j % ns, np.arange(1, R)) / (ns * R)).ravel())
        ns *= R
    n = np.arange(q)
    parts.append(np.exp(-1j * np.pi * ((n * n) % (2 * q)) / q))
    parts.append(frontend.bluestein_filter(n_fft)[: frontend.filter_count(n_fft)])
    return np.concatenate(parts)


def _real_split(z, w, pscale, dtype):
    """The kernel's real split of the half-size FFT rows z [nf, H] into
    the power rows [nf, H + 1] (w[k] = e^{-2πik/n_fft}, k <= H/2)."""
    H = z.shape[1]
    kk = np.arange(H // 2 + 1)
    a, cc = z[:, kk], np.conj(z[:, np.where(kk == 0, 0, H - kk)])
    xe, xo = (a + cc) / 2, (a - cc) / 2j
    X, Y = xe + w[kk] * xo, xe - w[kk] * xo
    P = np.empty((z.shape[0], H + 1), dtype)
    P[:, kk] = np.abs(X) ** 2 * pscale
    mirror = 2 * kk != H
    P[:, H - kk[mirror]] = np.abs(Y[:, mirror]) ** 2 * pscale
    return P


def _bluestein(fr, n_fft, w, ctype, team=None):
    """The kernel's Bluestein form on windowed frames fr [nf, >= n_fft]
    (zero past min(L, n_fft)) with its table w: stage 0 loads point n < Q
    (the pair y[2n] + i·y[2n+1] for even n_fft, the sample y[n] for odd)
    times the chirp c[n], zero to P; the P-point stages; the inverse's stage
    0 loads conj(A[n])·filter[n] (filter[min(n, P - n)] for even n_fft) and
    runs the same forward stages; then Z[k] = c[k]·conj(D[k]) for k < K.
    Returns Z [nf, K]: the n_fft/2-point DFT of the packed frame for even
    n_fft (the real split follows), the first n_bins outputs of the n_fft-
    point DFT for odd."""
    q, k, P = frontend.bluestein_dims(n_fft)
    nt, nfl = frontend.twiddle_count(n_fft, "bluestein"), frontend.filter_count(n_fft)
    chirp, filt = w[nt - nfl - q : nt - nfl], w[nt - nfl :]
    if n_fft % 2 == 0:
        filt = filt[np.minimum(np.arange(P), P - np.arange(P))]
        z = fr[:, 0 : 2 * q : 2] + 1j * fr[:, 1 : 2 * q : 2]
    else:
        z = fr[:, :q].astype(ctype)
    a = np.zeros((fr.shape[0], P), ctype)
    a[:, :q] = z * chirp
    A = _stockham(a, n_fft, w, "bluestein", team)
    D = _stockham((np.conj(A) * filt).astype(ctype), n_fft, w, "bluestein", team)
    return (chirp[:k] * np.conj(D[:, :k])).astype(ctype)


@pytest.mark.parametrize("n_fft", [404, 551, 286, 1102, 683, 2501, 5392])
def test_bluestein_dft_matches_numpy_rfft_in_float64(n_fft):
    """The Bluestein form's loops in float64 (packing, chirp, the P-point
    stages, the filter product, the inverse, the split) ≡ np.fft.rfft
    within 1e-9: n_fft 404 (P = 512), 551 (odd, 960), 286 (n_fft under the
    frame length, 320), 683, the largest odd n_fft whose warp plan fits at
    classic13, and the block plan's 1102 (1,280), 2501 (odd, 4,096) and
    5392 (6,144), which took the direct DFT or were refused before, there
    with each stage's butterflies by a group's thread ranks (`_stockham`'s
    team: 64, 128 or 256 by `frontend.fft_layout` at classic13)."""
    g = np.random.default_rng(n_fft)
    fr = g.standard_normal((5, n_fft + 2))
    fr[:, n_fft:] = 0.0
    plan, groups = frontend.fft_layout(T_CONFIGS["classic13"].replace(n_fft=n_fft))
    team = None if plan == "warp" else frontend.THREADS // groups
    assert (team is None) == (n_fft < 685)
    Z = _bluestein(fr, n_fft, _bluestein64(n_fft), np.complex128, team)
    if n_fft % 2 == 0:
        power = _real_split(Z, _bluestein64(n_fft), 1.0, np.float64)
    else:
        power = np.abs(Z) ** 2
    want = np.abs(np.fft.rfft(fr[:, :n_fft], axis=-1)) ** 2
    np.testing.assert_allclose(power, want, rtol=0, atol=1e-9 * want.max())
    if n_fft % 2:
        np.testing.assert_allclose(Z, np.fft.rfft(fr[:, :n_fft], axis=-1), rtol=0, atol=1e-9)


@pytest.mark.parametrize("n_fft,team", [(2160, 64), (4096, 128), (2048, 64), (8192, 256)])
def test_block_plan_stockham_matches_numpy_rfft_in_float64(n_fft, team):
    """The Stockham stages with each stage's butterflies by a block-plan
    group's thread ranks (64, 128 or 256: each output written once, every
    input read after the stage before wrote it), then the real split, ≡
    np.fft.rfft within 1e-9 in float64: n_fft 2160 (1,080 = 8·3·3·3·5
    points) and 4096, which the port refused before, librosa's 2048 and
    8192 (4,096 = 8⁴ points)."""
    g = np.random.default_rng(n_fft)
    fr = g.standard_normal((3, n_fft))
    w = _twiddles64(n_fft)
    P = _real_split(_stockham(fr[:, 0::2] + 1j * fr[:, 1::2], n_fft, w, team=team), w, 1.0, np.float64)
    want = np.abs(np.fft.rfft(fr, axis=-1)) ** 2
    np.testing.assert_allclose(P, want, rtol=0, atol=1e-9 * want.max())


def _project(P, w, wf, off, kbin, eps, ssc, lanes=32):
    """The kernel's balanced projection on power rows P [nf, bins] by
    `lanes` lanes (a warp's 32, the block plan's 256 threads): lane l sums
    packed weights [l·c, l·c + c) in order (c = frontend.chunk), a filter
    that ends in the lane is finished there, the partial of one that goes
    on is posted, and a filter begun in lane a < l is finished as part[a] +
    ... + part[l-1] + the lane's own sum. Returns the mel sums [nf, M] (for
    ssc the melf sums too)."""
    nnz, M = int(off[-1]), len(off) - 1
    c = frontend.chunk(nnz, lanes)
    filt = np.repeat(np.arange(M), np.diff(off))
    nf = P.shape[0]
    z = np.zeros(nf, P.dtype)
    sums, sumsf = np.zeros((nf, M), P.dtype), np.zeros((nf, M), P.dtype)
    part, partf, held = {}, {}, {}
    for lane in range(lanes):
        i0, i1 = lane * c, min(lane * c + c, nnz)
        acc, accf = z.copy(), z.copy()
        for i in range(i0, i1):
            m = filt[i]
            q = P[:, kbin[i]]
            if ssc:
                q = np.where(q <= 0, eps, q)
                accf = accf + q * wf[i]
            acc = acc + q * w[i]
            if i + 1 == off[m + 1]:
                if off[m] < i0:
                    held[lane] = (m, acc, accf)
                else:
                    sums[:, m], sumsf[:, m] = acc, accf
                acc, accf = z.copy(), z.copy()
        part[lane], partf[lane] = acc, accf
    for lane, (m, h, hf) in held.items():
        a = off[m] // c
        t, tf = part[a], partf[a]
        for l in range(a + 1, lane):
            t, tf = t + part[l], tf + partf[l]
        sums[:, m], sumsf[:, m] = t + h, tf + hf
    return sums, sumsf


STAGE_CHUNK = 256 * 8  # csrc/frontend.cu kThreads * kStageBatch: pre-emphasis in place, chunk by chunk


def _stage_tile(x_row, noise_row, n, f0, cfg, dtype, pre=0.0):
    """csrc/frontend.cu's staged signal row of the tile at frame f0 (span
    floats) for a row of n samples, x_row the converted samples and
    noise_row the contract noise. Centered framing: each position reads the
    reflected source index r and stages x[r] - c·x[r-1] (noise keyed on r).
    Otherwise, with dither (step 1d): x[t0 - o .. t0 + span) converted into
    the row (o = 1 under signal pre-emphasis, 0 in frame mode), 0 outside
    [0, n); the dither pass in place at 0 <= t < n; then for o = 1
    pre-emphasis and zeroing in place, STAGE_CHUNK entries at a time, each
    chunk read whole before it is written. Without dither: x[t] - c·x[t-1],
    zeroed at t >= n, x[-1] = pre (the block launch's pre-context; 0
    otherwise)."""
    S, L, T = cfg.frame_step, cfg.frame_length, x_row.shape[0]
    span = (TILE - 1) * S + L
    c_sig = dtype(0.0 if cfg.preemph_mode == "frame" else cfg.preemph)
    sigma = dtype(cfg.dither)
    xd = x_row + sigma * noise_row if cfg.dither > 0.0 else x_row
    if tchain.centered(cfg):
        r = _reflect(f0 * S + tchain.frame_offset(cfg) + np.arange(span), max(n, 1), cfg.frame_tail)
        ok = r < n
        x = np.where(ok, xd[np.minimum(r, T - 1)], 0)
        xp = np.where(ok & (r > 0), xd[np.clip(r - 1, 0, T - 1)], 0)
        return np.where(ok, x - c_sig * xp, 0).astype(dtype)
    if cfg.dither > 0.0:
        o = int(c_sig != 0)
        t = f0 * S - o + np.arange(span + o)
        live = (t >= 0) & (t < n)
        sig = np.where(live, x_row[np.clip(t, 0, T - 1)], 0).astype(dtype)
        sig[live] = sig[live] + sigma * noise_row[t[live]]  # the dither pass
        if o:
            for c0 in range(0, span, STAGE_CHUNK):
                i = np.arange(c0, min(c0 + STAGE_CHUNK, span))
                v = np.where(f0 * S + i < n, sig[i + 1] - c_sig * sig[i], 0)  # the chunk, read whole
                sig[i] = v
        return sig[:span]
    t = f0 * S + np.arange(span)
    ok = t < n
    x = np.where(ok, x_row[np.minimum(t, T - 1)], 0)
    xp = np.where(t > 0, x_row[np.clip(t - 1, 0, T - 1)], pre)
    return np.where(ok, x - c_sig * xp, 0).astype(dtype)


def _gather_samples(x_row, noise_row, n, t, cfg, dtype, pre=0.0):
    """csrc/frontend.cu staged_at, the gather plan's sample (step 2g), at
    frame positions t (any shape): each from the row alone, by the
    arithmetic of the staging the span would take. Centered framing: the
    reflected source index r of t + offset, x[r] - c·x[r-1] (x[-1] = 0, the
    noise keyed on r), 0 where r >= n. Otherwise 0 at t >= n (zeroing after
    pre-emphasis); with dither d(t) - c·d(t-1), d(u) = x[u] + noise(u) for 0
    <= u < n (d(-1) = 0), or d(t) where c = 0; without x[t] - c·x[t-1],
    x[-1] = pre (the block launch's pre-context; 0 otherwise)."""
    S, T = cfg.frame_step, x_row.shape[0]
    c = dtype(0.0 if cfg.preemph_mode == "frame" else cfg.preemph)
    sigma = dtype(cfg.dither)
    xd = x_row + sigma * noise_row if cfg.dither > 0.0 else x_row
    t = np.asarray(t, np.int64)
    if tchain.centered(cfg):
        r = _reflect(t + tchain.frame_offset(cfg), max(n, 1), cfg.frame_tail)
        ok = r < n
        x = np.where(ok, xd[np.clip(r, 0, T - 1)], dtype(0))
        xp = np.where(ok & (r > 0), xd[np.clip(r - 1, 0, T - 1)], dtype(0))
        return (x - c * xp if c != 0 else x).astype(dtype)
    ok = t < n
    x = np.where(ok, xd[np.clip(t, 0, T - 1)], dtype(0))
    if cfg.dither > 0.0:
        xp = np.where(ok & (t > 0), xd[np.clip(t - 1, 0, T - 1)], dtype(0))
        return np.where(ok, x - c * xp if c != 0 else x, dtype(0)).astype(dtype)
    xp = np.where(t > 0, x_row[np.clip(t - 1, 0, T - 1)], dtype(pre))
    return np.where(ok, x - c * xp, dtype(0)).astype(dtype)


def _emulate_kernel(audio, lengths, cfg, dtype, plan=None, origin=0, frames=None):
    """csrc/frontend.cu's algorithm in numpy, tile by tile, in `dtype`: the
    staged row (`_stage_tile`: x plus the contract noise at t < length when
    cfg dithers, signal pre-emphasis from x[t-1], zeroing at t >= length, in
    the kernel's order; for centered framing each staged position reads the
    reflected source index r and stages x[r] - c·x[r-1]), the per-frame conditioning over all L samples
    (mean, the raw energy as a second pass, frame pre-emphasis from fr[a]
    and fr[a-1], the windowed energy), a frame that starts at or past its
    row's length (non-centered framing) taking no DFT: zero powers and zero
    frame energies; the others' first min(L, n_fft) samples transformed by
    the kernel's DFT form (the Stockham stages on the host tables, then the
    real split; the Bluestein form (`_bluestein`, then the split for even
    n_fft, |X|² for odd)) in the plan of `frontend.fft_layout`, which
    `plan` ((plan, frames a block at once)) can force at any size (the block
    plans: each stage by the 256 / groups thread ranks of a group, the
    projection's chunks over them; their tables are the same entries,
    staged or read from device memory; the gather plans take each frame's
    samples from the row itself, `_gather_samples`), then by
    feature kind the balanced projection over the packed bands (`_project`)
    and the log kind (logmel) or nothing (plp), the log kind of each power
    bin (spectrogram), or the centroids of the per-bin clamped power (ssc,
    lane M = 0), and the energy lane. origin=1 is the block launch: each
    row's sample 0 is the pre-context x[-1], its signal starts at sample 1,
    lengths count from there, and `frames` frames are cut."""
    ctype = np.complex64 if dtype == np.float32 else np.complex128
    k = tconstants.chain_constants(cfg)
    kind = frontend.feature_kind(cfg)
    win, mel = k["window"].astype(dtype), k["mel"].astype(dtype)
    melf = (k["freqs"][:, None] * k["mel"]).astype(dtype)  # rounded once, as _tables does
    off, index = (t.numpy() for t in frontend.mel_packed(torch.as_tensor(mel)))
    w_mel, w_melf = mel.reshape(-1)[index], melf.reshape(-1)[index]
    N, form = cfg.n_fft, frontend.dft_form(cfg)
    plan, groups = plan or frontend.fft_layout(cfg)
    team, n_lanes = (None, 32) if plan == "warp" else (frontend.THREADS // groups,) * 2
    gather = plan.startswith("gather")
    H, nb = N // 2, cfg.n_bins
    if form == "bluestein":
        w = _bluestein64(N)
    else:
        w = _twiddles64(N)
    if dtype == np.float32:
        tw = frontend.fft_twiddles(N, form).astype(dtype)
        w = (tw[:, 0] + 1j * tw[:, 1]).astype(ctype)
    pre = audio[:, 0] if origin else np.zeros(audio.shape[0])
    audio = audio[:, origin:]
    B, T = audio.shape
    S, L, M = cfg.frame_step, cfg.frame_length, cfg.n_mels
    Lk = min(L, N)
    F = cfg.num_frames(T) if frames is None else frames
    span = (TILE - 1) * S + L
    pscale = dtype(1.0 / cfg.n_fft if cfg.power_scale_nfft else 1.0)
    eps = dtype(cfg.log_eps)
    frame_mode = cfg.preemph_mode == "frame"
    c = dtype(cfg.preemph if frame_mode else 0.0)
    keep0 = dtype(np.float32(1.0 - float(c)))  # rounded on the host, passed as a float
    out = np.empty((B, F, M + 1), dtype)
    x_all = audio.astype(dtype) * dtype(cfg.input_scale)
    noise = (tdither.signal_noise(cfg.dither_seed, T, S).numpy().astype(dtype)
             if cfg.dither > 0.0 else None)
    for b in range(B):
        n = min(int(lengths[b]), T)
        for f0 in range(0, F, TILE):
            nf = min(TILE, F - f0)
            if gather:  # each sample from the row itself (step 2g)
                f = _gather_samples(x_all[b], noise, n, ((f0 + np.arange(nf)) * S)[:, None] + np.arange(L),
                                    cfg, dtype, dtype(pre[b]) * dtype(cfg.input_scale))
            else:
                sig = _stage_tile(x_all[b], noise, n, f0, cfg, dtype,
                                  dtype(pre[b]) * dtype(cfg.input_scale))
                f = sig[(np.arange(nf) * S)[:, None] + np.arange(L)]
            # frames wholly past the row's length take no DFT (step 2z)
            zero = np.zeros(nf, bool) if tchain.centered(cfg) else (f0 + np.arange(nf)) * S >= n
            e_raw = np.zeros(nf, dtype)
            if tchain.needs_conditioning(cfg):
                mu = f.sum(axis=-1, keepdims=True) / dtype(L) if cfg.remove_dc_offset else dtype(0)
                d = (f - mu).astype(dtype)
                e_raw = (d * d).sum(axis=-1)
                g = np.concatenate([d[:, :1] * keep0, d[:, 1:] - c * d[:, :-1]], axis=-1)
                f = g
            wf = f * win
            e_win = (wf * wf).sum(axis=-1)  # all L samples, past n_fft too
            fr = np.zeros((nf, 2 * H + 2), dtype)
            fr[:, :Lk] = wf[:, :Lk]
            if form == "bluestein":
                Z = _bluestein(fr, N, w, ctype, team)
                if N % 2:
                    P = (np.abs(Z) ** 2 * pscale).astype(dtype)
                else:
                    P = _real_split(Z, w, pscale, dtype)
            else:
                z = (fr[:, 0 : 2 * H : 2] + 1j * fr[:, 1 : 2 * H : 2]).astype(ctype)
                P = _real_split(_stockham(z, N, w, team=team), w, pscale, dtype)
            P[zero], e_raw[zero], e_win[zero] = 0, 0, 0
            if kind == "spectrogram":
                lanes = _log_lane(P[:, :M], cfg.log_kind, eps, dtype)
            else:
                sums, sumsf = _project(P, w_mel, w_melf, off, index // M, eps, kind == "ssc", n_lanes)
                if kind == "ssc":
                    lanes = sumsf / sums
                elif kind == "plp":
                    lanes = sums
                else:
                    lanes = _log_lane(sums, cfg.log_kind, eps, dtype)
            out[b, f0 : f0 + nf, :M] = lanes
            if kind == "ssc":
                out[b, f0 : f0 + nf, M] = 0
            elif cfg.energy_source == "raw_frame":
                out[b, f0 : f0 + nf, M] = np.maximum(e_raw, eps)
            elif cfg.energy_source == "windowed_frame":
                out[b, f0 : f0 + nf, M] = np.maximum(e_win, eps)
            else:
                e = P.sum(axis=-1)
                out[b, f0 : f0 + nf, M] = np.where(e <= 0, eps, e)
    return out


def _log_lane(acc, kind, eps, dtype):
    if kind == "ln_stab":
        return np.log(acc + dtype(1e-6))
    if kind == "db":
        return dtype(10) * np.log10(np.where(acc <= 0, eps, acc))
    if kind == "ln_floor":
        return np.log(np.maximum(acc, eps))
    if kind == "log10_floor":
        return np.log10(np.maximum(acc, eps))
    return np.log(np.where(acc <= 0, eps, acc))


@pytest.mark.parametrize(
    "overrides",
    [{}, {"win_len_s": 0.040}, {"preemph": 0.0, "window": "hann_periodic"}],
    ids=["classic13", "frame_longer_than_nfft", "no_preemph_hann"],
)
def test_kernel_algebra_exact_in_float64(overrides):
    """In float64 the kernel's FFT, split, band sums and tiles reproduce the
    plain version to ~1e-10 (log of quiet bins): the algorithm is exact, only
    float64 roundoff remains.
    A 640-sample frame is truncated to n_fft = 512, as rfft(n=512) does."""
    cfg = T_CONFIGS["classic13"].replace(dtype="float64", **overrides)
    audio, lengths = _batch("classic13", ("noise", "short", "tone_offbin"))
    audio = audio[:, :12000].astype(np.float64)
    lengths = np.minimum(lengths, 11000)
    got = _emulate_kernel(audio, lengths, cfg, np.float64)
    want = _reference(audio, lengths, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", ["classic13_deltas", "kaldi_mfcc"])
@pytest.mark.parametrize("K", [16, 40])
def test_block_launch_algebra_exact_in_float64(name, K):
    """The block launch (row origin 1: sample 0 read only as x[-1], lengths
    from sample 1, K frames) in the kernel's tiles ≡ its plain version
    `frontend.logmel_block_reference` to ~1e-9 in float64, with a zero and
    a dirty pre-context and valid at 0, 1, L - 1, L, L + 1 and span (K = 40
    spans two 32-frame tiles)."""
    cfg = T_CONFIGS[name].replace(dtype="float64")
    S, L = cfg.frame_step, cfg.frame_length
    span = (K - 1) * S + L
    g = np.random.default_rng(K)
    rows = np.round(g.standard_normal((12, span + 1)) * 3000)
    rows[:6, 0] = 0.0
    valid = np.array([0, 1, L - 1, L, L + 1, span] * 2)
    got = _emulate_kernel(rows, valid, cfg, np.float64, origin=1, frames=K)
    want = frontend.logmel_block_reference(torch.as_tensor(rows), torch.as_tensor(valid), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    # the pre-context reaches frame 0's first sample only under signal pre-emphasis
    other = rows.copy()
    other[:, 0] += 1000.0
    moved = _emulate_kernel(other, valid, cfg, np.float64, origin=1, frames=K)
    assert np.array_equal(moved[:, 1:], got[:, 1:])
    assert np.array_equal(moved[:, 0], got[:, 0]) == (cfg.preemph_mode == "frame")


def test_kernel_algebra_float32_within_gates():
    cfg = T_CONFIGS["classic13_deltas"]
    audio, lengths = _batch("classic13_deltas")
    got = _emulate_kernel(audio, lengths, cfg, np.float32)
    assert_prefix_close(got, _reference(audio, lengths, cfg), cfg.n_mels)


STAGING_CASES = [
    ("classic13", {"dither": 1.0}),
    ("kaldi_mfcc", {"dither": 1.0}),
    ("classic13", {"dither": 0.5, "preemph": 0.0}),
    ("classic13_deltas", {}),
]
STAGING_IDS = ["signal_preemph_dither", "frame_mode_dither", "signal_no_preemph_dither",
               "signal_preemph_no_dither"]


@pytest.mark.parametrize("name,overrides", STAGING_CASES, ids=STAGING_IDS)
def test_staged_row_is_the_chains_dithered_signal(name, overrides):
    """The kernel's staged row (`_stage_tile`: batched loads, the dither
    pass in place, chunked in-place pre-emphasis) over every tile of rows
    at the boundary lengths equals the signal `chain.logmel_stages` frames:
    dithered, pre-emphasized in signal mode, zeroed past each length; in
    frame mode the raw dithered signal (the kernel's host passes preemph =
    0 there; the chain's frames are taken before its frame pre-emphasis and
    DC removal). float64, 1e-9, as the other emulator tests."""
    cfg = T_CONFIGS[name].replace(dtype="float64", **overrides)
    chain_cfg = (cfg.replace(preemph=0.0, remove_dc_offset=False)
                 if cfg.preemph_mode == "frame" else cfg)
    T = 12000
    g = np.random.default_rng(31)
    lens = np.array(BOUNDARY_LENGTHS + [T - 1, T], np.int32)
    audio = np.round(g.standard_normal((len(lens), T)) * 3000)
    frames = tchain.logmel_stages(torch.as_tensor(audio), torch.as_tensor(lens), chain_cfg)["frames"]
    frames = frames.numpy()
    F, S, L = cfg.num_frames(T), cfg.frame_step, cfg.frame_length
    noise = tdither.signal_noise(cfg.dither_seed, T, S).numpy().astype(np.float64)
    assert frames.shape == (len(lens), F, L) and F > 2 * TILE
    for b, n in enumerate(lens):
        for f0 in range(0, F, TILE):
            sig = _stage_tile(audio[b], noise, int(n), f0, cfg, np.float64)
            nf = min(TILE, F - f0)
            got = sig[(np.arange(nf) * S)[:, None] + np.arange(L)]
            np.testing.assert_allclose(got, frames[b, f0 : f0 + nf], rtol=1e-9, atol=1e-9)


BRANCHES = [
    ("kaldi_mfcc", {"dither": 1.0}),
    ("kaldi_mfcc", {}),
    ("kaldi_fbank", {}),
    ("kaldi_mfcc", {"energy_source": "windowed_frame", "remove_dc_offset": False}),
    ("logmel80", {}),
    ("logmel80", {"log_kind": "db"}),
    ("classic13", {"dither": 0.5}),
    ("kaldi_plp", {}),
    ("kaldi_spectrogram", {}),
    ("ssc26", {}),
    ("ssc26", {"dither": 0.5, "remove_dc_offset": True}),
    ("whisper80", {}),
    ("whisper80", {"dither": 0.5}),
    ("classic13", {"frame_tail": "center", "dither": 1.0}),
    ("kaldi_mfcc", {"frame_tail": "center", "dither": 1.0}),
    ("classic13", {"frame_tail": "center_reflect"}),
    ("classic13", {"n_fft": 404}),
    ("classic13", {"n_fft": 480}),
    ("kaldi_fbank", {"n_fft": 405}),
    ("kaldi_mfcc", {"win_len_s": 0.040, "energy_source": "windowed_frame"}),
    ("kaldi_spectrogram", {"n_fft": 400, "n_mels": 201}),
    ("classic13", {"n_fft": 2048}),
    ("classic13", {"n_fft": 404}),
    ("kaldi_fbank", {"n_fft": 405}),
    ("classic13", {"n_fft": 551}),
    ("classic13", {"n_fft": 286}),
    ("kaldi_mfcc", {"n_fft": 404, "dither": 1.0, "energy_source": "windowed_frame"}),
    ("classic13", {"n_fft": 683, "frame_tail": "center"}),
]
BRANCH_IDS = ["kaldi_mfcc_dither", "kaldi_mfcc", "kaldi_fbank", "windowed_energy_no_dc",
              "logmel80_ln_stab", "logmel80_db", "classic13_dither", "kaldi_plp",
              "kaldi_spectrogram", "ssc26", "ssc26_dither_dc", "whisper80", "whisper80_dither",
              "center_preemph_dither", "kaldi_center_dither", "center_reflect_preemph",
              "block_fft_404", "mixed_radix_480", "block_fft_global_odd_405",
              "frame_longer_than_nfft_windowed_energy", "spectrogram_400", "stockham_2048",
              "bluestein_404", "bluestein_odd_405", "bluestein_odd_551", "bluestein_286",
              "bluestein_404_dither_windowed_energy", "bluestein_odd_683_centered"]
# the block plan, forced at small sizes (where the direct DFT was held before
# it was retired): 4 frames a block (64 threads a frame), the tables staged,
# at 404; 2 (128 threads), from device memory, at odd 405
FORCED_PLANS = {"block_fft_404": ("block", 4), "block_fft_global_odd_405": ("block_global", 2)}


def _forced_plan(request):
    return FORCED_PLANS.get(request.node.callspec.id)


@pytest.mark.parametrize("name,overrides", BRANCHES, ids=BRANCH_IDS)
def test_kernel_branches_exact_in_float64(name, overrides, request):
    """The dither staging, the conditioning of the pack loop, each log kind,
    each feature kind, each DFT form and each plan (the block plans forced
    at 404 and 405) reproduce the plain version to ~1e-9 in float64."""
    cfg = T_CONFIGS[name].replace(dtype="float64", **overrides)
    audio, lengths = _batch("classic13", ("noise", "short", "tone_offbin"))
    audio = audio[:, :12000].astype(np.float64) * 3000
    lengths = np.minimum(lengths, 11000)
    got = _emulate_kernel(audio, lengths, cfg, np.float64, _forced_plan(request))
    want = _reference(audio, lengths, cfg)
    assert got.shape == want.shape == (3, cfg.num_frames(12000), cfg.n_mels + 1)
    if cfg.features == "spectrogram":
        # one log per bin, with no filter sum: float64 FFT roundoff is ~1e-16
        # of the row's power, which a bin 1e-7 below the row max reads as
        # ~1e-9 in its log; so the lanes are held in the linear domain
        M = cfg.n_mels
        lin_g, lin_w = np.exp(got[..., :M]), np.exp(want[..., :M])
        rowmax = lin_w.max(axis=-1, keepdims=True)
        np.testing.assert_allclose(lin_g / rowmax, lin_w / rowmax, rtol=1e-9, atol=1e-12)
        got, want = got[..., M], want[..., M]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name,overrides", BRANCHES, ids=BRANCH_IDS)
def test_kernel_branches_float32_within_gates(name, overrides, request):
    cfg = T_CONFIGS[name].replace(**overrides)
    audio, lengths = _batch("classic13_deltas")
    pcm = np.round(audio * 3000).astype(np.int16)
    got = _emulate_kernel(pcm, lengths, cfg, np.float32, _forced_plan(request))
    want = _reference(pcm, lengths, cfg)
    valid = lengths >= cfg.frame_length  # rows with a frame under either framing
    assert_prefix_close(got[valid], want[valid], cfg.n_mels, cfg.log_kind, cfg.features)


def test_emulated_kernel_drop_framing_of_a_short_batch():
    cfg = T_CONFIGS["kaldi_mfcc"]
    audio = np.zeros((2, 300), np.float32)
    got = _emulate_kernel(audio, np.array([300, 5]), cfg, np.float32)
    assert got.shape == (2, 0, cfg.n_mels + 1)
    assert _reference(audio, np.array([300, 5], np.int32), cfg).shape == got.shape


def test_breakdown_cut_points_apply_to_the_kernel_source():
    """scripts/frontend_breakdown.py cuts the kernel after staging and
    before the FFT form's projection: both anchors are in csrc/frontend.cu,
    and each cut is compiled in by its own CUT value."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("frontend_breakdown",
                                                  root / "scripts" / "frontend_breakdown.py")
    fb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fb)
    src = (root / "mfcc_tpu_torch" / "kernels" / "csrc" / "frontend.cu").read_text()
    texts = fb.variants(src)
    assert sorted(texts) == [0, 1, 2]
    for cut, text in texts.items():
        assert text.startswith(f"#define CUT {cut}\n")
        assert "#if CUT == 1" in text and "#if CUT == 2" in text
        assert "frontend_breakdown_blocks" in text
