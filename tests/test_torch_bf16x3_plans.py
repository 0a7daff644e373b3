"""The bf16x3 route at every n_fft, hop and frame length the reference's
takes: the block plans of csrc/frontend.cu's bf16x3 form ≡ the JAX package.

The bf16x3 form staged the tile's span, window, packed bands and the power
rows of every bin, so n_fft from 2,245 at classic13, hops from ~0.07 s and
frames from ~1 s were over the block. `frontend.bf16_layout` now takes,
after that "staged" plan, the plain form's block plans: "pass" (the power
rows of one pass of 136 bins, each pass projected into per-frame
accumulators before the next overwrites them), "gather" (each frame read
from device memory, no span and no window staged), "gather_bands" (the
packed bands and the pass table read from device memory too) and
"gather_out" (the accumulators in a workspace in device memory too). On the
card only the matrix's bytes bound the route (`bf16_matrix_reason`). Here,
on the CPU:
  - each plan's layout, field by field (`_block_layout`, csrc/frontend.cu
    layout()), at n_fft 2,245 / 4,096 / 8,192 / 16,384, hops of 1,214 and
    1,600 samples and 1.1 s and 3 s frames, for int16 and float32 rows, and
    the first fit of `BF16_LAYOUTS`; `layout_reason(cfg, "bf16x3")` None over
    a sweep of n_fft 16-16,384, hops to 2 s and frames to 3 s; the filter
    field the only layout reason left (60,000 filters);
  - the pass table (`frontend.pass_table`): each packed weight in exactly
    one segment, in pass then filter order, its bin the packed table's,
    within the words the layout counts;
  - a numpy mirror of the block plans (`_emulate_block_plan`: the frames
    from the row itself, `_gather_samples`, which tests/test_torch_long_span
    holds bitwise to the staged spans; the conditioning; the tile product of
    tests/test_torch_bf16x3.py `_emulate_tile_power`; then the projection
    pass by pass in the kernel's order, each segment summed in packed order
    and added to its filter's accumulator in pass order, and the epilogue)
    against `chain.bf16x3_power` (4e-6 of the row's max power: a few ulps
    of it, the fp32 sums of the kernel's step order against the plain
    version's float64 ones) and
    `logmel_prefix_reference(dft_passes="bf16x3")` at the card's bf16x3
    kernel-vs-plain gates (`testing.prefix_failures` with BF16X3_LOUD_ATOL),
    and loud log-mel bins within 5e-5 (measured at most 2.3e-5, kaldi_mfcc
    with dither; the sums' order against the plain version's float64
    products);
  - the plain bf16x3 prefix at n_fft 4,096, a 0.1 s hop and 1.1 s frames
    against the JAX package's `fused_logmel_stages(dft_passes="bf16x3",
    interpret=True)` at PORT_VS_REFERENCE_LOUD (2e-4) and CLASS_LOUD (1e-3)
    on loud bins, and against the jnp twin and the float64 chain at
    CLASS_LOUD, masks equal;
  - the matrix-bytes reason from the card's memory, and the bounded cache of
    the card's matrices.
tests/test_torch_gpu.py and chip_smoke.py (phase 30) hold the kernel's
plans to their plain versions on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.kernels import frontend as jfrontend
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.ops import constants as tconstants
from mfcc_tpu_torch.ops import dither as tdither
from mfcc_tpu_torch.pipeline import pad_batch
from tests.test_torch_bf16x3 import CLASS_LOUD, PORT_VS_REFERENCE_LOUD, _emulate_tile_power, _loud_max_abs
from tests.test_torch_frontend import _gather_samples, _log_lane

BUDGET = 232448
# (config, overrides, the plan and (frames a block, ring stages) it takes)
LAYOUT_CASES = {
    "n_fft_2245": ("classic13", dict(n_fft=2245), ("pass", 64, 4)),
    "n_fft_4096": ("classic13", dict(n_fft=4096), ("pass", 64, 3)),
    "n_fft_8192": ("classic13", dict(n_fft=8192), ("pass", 32, 4)),
    "n_fft_16384": ("classic13", dict(n_fft=16384), ("gather", 32, 3)),
    "hop_1214": ("classic13", dict(hop_s=1214 / 16000), ("gather", 64, 4)),
    "hop_1600": ("classic13", dict(hop_s=0.1), ("gather", 64, 4)),
    "frames_1.1s": ("classic13", dict(win_len_s=1.1), ("gather", 64, 4)),
    "frames_3s": ("classic13", dict(win_len_s=3.0), ("gather", 64, 4)),
    "kaldi_dither_4096": ("kaldi_mfcc", dict(dither=1.0, n_fft=4096), ("pass", 64, 3)),
    "ssc_4096": ("ssc26", dict(n_fft=4096), ("pass", 64, 2)),
    "n_fft_24000": ("classic13", dict(n_fft=24000), ("gather_bands", 64, 4)),
    "filters_2000": ("classic13", dict(n_mels=2000, n_fft=4096), ("gather_out", 64, 4)),
    "ssc_filters_1500": ("ssc26", dict(n_mels=1500, n_fft=4096), ("gather_out", 64, 4)),
}
MIRROR_CASES = {
    "classic13_4096": ("classic13", dict(n_fft=4096)),
    "classic13_hop_0.1": ("classic13", dict(hop_s=0.1)),
    "kaldi_mfcc_dither_4096": ("kaldi_mfcc", dict(dither=1.0, n_fft=4096)),
    "ssc26_4096": ("ssc26", dict(n_fft=4096)),
    "kaldi_plp_4096": ("kaldi_plp", dict(n_fft=4096)),
    "kaldi_spectrogram_hop_0.1": ("kaldi_spectrogram", dict(hop_s=0.1)),
    "classic13_filters_300": ("classic13", dict(n_mels=300, n_fft=2048, win_len_s=0.2)),
}
REFERENCE_CASES = {
    "n_fft_4096": ("classic13", dict(n_fft=4096)),
    "hop_0.1": ("classic13", dict(hop_s=0.1)),
    "frames_1.1s": ("classic13", dict(win_len_s=1.1)),
}


def _a4(n):
    return (n + 3) & ~3


def _block_layout(cfg, plan, tile, stages):
    """csrc/frontend.cu layout() of a bf16x3 block plan, field by field
    (floats; the plain form, whose row type changes nothing): the signal row
    ((tile - 1)·S + L, one more under dither) and the window (max(L,
    n_fft)) unless the plan gathers; the packed weights (and SSC's melf
    weights), the filters' offsets, the bin-filter words and the pass table
    (npass + 1 offsets and 4 words for each of at most n_packed // 136 + 2M
    segments) unless they are read from device memory; at a 128-byte
    boundary the ring (17,408 B a stage) and its full and empty mbarriers;
    the re/im rows of one pass (272 columns and 8 of padding), which then
    hold its power rows; the frames' energies and means; the accumulators (M + 1 a frame, 2M for SSC,
    1 for a spectrogram) unless they are in device memory."""
    gather, bands_dev, acc_dev = {"pass": (0, 0, 0), "gather": (1, 0, 0), "gather_bands": (1, 1, 0),
                                  "gather_out": (1, 1, 1)}[plan]
    M, nnz = cfg.n_mels, frontend.packed_count(cfg)
    tables = {"spectrogram": 0, "ssc": 2}.get(frontend.feature_kind(cfg), 1)
    npass = -(-cfg.n_bins // 136)
    n = 0
    if not gather:
        n += _a4((tile - 1) * cfg.frame_step + cfg.frame_length + (cfg.dither > 0)) + _a4(
            max(cfg.frame_length, cfg.n_fft))
    if not bands_dev and tables:
        n += tables * _a4(nnz) + _a4(M + 1) + _a4(nnz) + _a4(npass + 1 + 4 * (nnz // 136 + 2 * M))
    n = (n + 31) // 32 * 32 + stages * 17408 // 4 + _a4(4 * stages)
    n += tile * 280 + 2 * _a4(tile)
    nacc = {"spectrogram": 1, "ssc": 2 * M}.get(frontend.feature_kind(cfg), M + 1)
    return 4 * (n + (0 if acc_dev else _a4(tile * nacc)))


@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_block_plan_layouts_field_by_field(case, int16):
    name, over, want = LAYOUT_CASES[case]
    cfg = T_CONFIGS[name].replace(**over)
    assert frontend.bf16_layout(cfg, int16) == want
    n = frontend.smem_bytes(cfg, "bf16x3", int16)
    assert n == _block_layout(cfg, *want) <= BUDGET
    assert frontend.layout_reason(cfg, "bf16x3") is None and frontend.resolve_dft_passes(cfg, "bf16x3") == "bf16x3"
    # the first fit: every layout the ladder tries before it is over the block
    layouts = frontend.BF16_LAYOUTS
    for plan, tile, stages in layouts[: layouts.index(want)]:
        assert frontend._bf16_smem(cfg, plan, tile, stages, int16) > BUDGET, (plan, tile, stages)
        if plan != "staged":
            assert _block_layout(cfg, plan, tile, stages) > BUDGET


def test_layout_reason_is_none_at_every_n_fft_hop_and_frame_length():
    c = T_CONFIGS["classic13"]
    sizes = [*range(16, 16385, 163), 2244, 2245, 4096, 8192, 16384]
    cfgs = [c.replace(n_fft=n) for n in sizes]
    cfgs += [c.replace(hop_s=h) for h in np.linspace(0.01, 2.0, 23)]
    cfgs += [c.replace(win_len_s=w, n_fft=max(512, 1 << int(np.ceil(np.log2(w * 16000 / 8)))))
             for w in np.linspace(0.025, 3.0, 17)]
    cfgs += [T_CONFIGS["kaldi_mfcc"].replace(dither=1.0, n_fft=4096)]
    for cfg in cfgs:
        assert frontend.layout_reason(cfg, "bf16x3") is None, cfg
        assert frontend.smem_bytes(cfg, "bf16x3", False) <= BUDGET, cfg
    # 60,000 filters, refused before (the packed table's filter field), take
    # "gather_out": nothing is refused for its layout
    assert frontend.layout_reason(c.replace(n_mels=60000), "bf16x3") is None
    assert frontend.bf16_layout(c.replace(n_mels=60000)) == ("gather_out", 64, 4)
    # a resampling config's fused form keeps "staged"; past it the split
    # route's plain form takes a block plan at the feature rate
    r = T_CONFIGS["mfcc39_48k"].replace(hop_s=0.1)
    assert frontend.bf16_layout(r)[0] == "staged" and frontend.resample_route(r, "bf16x3") == "split"
    assert frontend.bf16_layout(frontend.feature_rate_config(r))[0] == "gather"
    assert frontend.layout_reason(r, "bf16x3") is None
    assert frontend.bf16_layout(T_CONFIGS["mfcc39_48k"], True) == ("staged", 64, 4)


@pytest.mark.parametrize("name,over", [("classic13", dict(n_fft=4096)), ("logmel80", dict(n_fft=8192)),
                                       ("ssc26", dict(n_fft=2245)), ("classic13", dict(n_mels=300))])
def test_pass_table_covers_each_packed_weight_once(name, over):
    cfg = T_CONFIGS[name].replace(**over)
    mel = torch.as_tensor(tconstants.mel_filterbank(cfg).astype(np.float32))
    off, index = frontend.mel_packed(mel)
    table = frontend.pass_table(mel).numpy()
    npass = -(-cfg.n_bins // 136)
    offsets, segs = table[: npass + 1], table[npass + 1 :].reshape(-1, 4)
    assert offsets[0] == 0 and offsets[-1] == len(segs) and (np.diff(offsets) >= 0).all()
    assert table.size <= frontend.pass_table_words(cfg)
    covered = np.zeros(int(off[-1]), int)
    bins = (index // cfg.n_mels).numpy()
    for p in range(npass):
        part = segs[offsets[p] : offsets[p + 1]]
        assert (np.diff(part[:, 0]) > 0).all()  # filter order, one segment a filter a pass
        for m, i0, i1, k0 in part:
            assert off[m] <= i0 < i1 <= off[m + 1]
            covered[i0:i1] += 1
            np.testing.assert_array_equal(bins[i0:i1], 136 * p + k0 + np.arange(i1 - i0))
            assert 0 <= k0 and k0 + i1 - i0 <= 136
    assert (covered == 1).all()


def _emulate_block_plan(audio, lengths, cfg):
    """csrc/frontend.cu's bf16x3 block plans in numpy, float32: each frame's
    L samples from the row itself (`_gather_samples`, the gather plans'
    staged_at, which the staged span equals bitwise), under conditioning the
    mean, raw energy and frame pre-emphasis over all L samples and the
    windowed energy; the tile product (`_emulate_tile_power`) of the first
    min(L, n_fft), its steps summed in stretches of BF16_PROMOTE; then pass after pass (bins [136p, 136p + 136)) each
    segment of `frontend.pass_table` summed over its weights in packed order
    (SSC: the clamped power, both sums) and added to its filter's
    accumulator, and the pass's powers summed in bin order and added to the
    energy's; a spectrogram's lanes the log kind of each bin; then the log
    kind (logmel), nothing (plp) or the centroid (ssc) of each accumulator
    and the energy lane."""
    f32 = np.float32
    k = tconstants.chain_constants(cfg)
    kind = frontend.feature_kind(cfg)
    B, T = audio.shape
    S, L, M = cfg.frame_step, cfg.frame_length, cfg.n_mels
    F = cfg.num_frames(T)
    eps = f32(cfg.log_eps)
    win = k["window"].astype(f32)
    x_all = audio.astype(f32) * f32(cfg.input_scale)
    noise = tdither.signal_noise(cfg.dither_seed, T, S).numpy().astype(f32) if cfg.dither > 0.0 else None
    pos = (np.arange(F) * S)[:, None] + np.arange(L)
    fr = np.stack([_gather_samples(x_all[b], noise, min(int(lengths[b]), T), pos, cfg, f32) for b in range(B)])
    e_frame = np.zeros((B, F), f32)
    if tchain.needs_conditioning(cfg):
        c = f32(cfg.preemph if cfg.preemph_mode == "frame" else 0.0)
        keep0 = f32(1.0 - float(c))
        mu = fr.sum(axis=-1, keepdims=True) / f32(L) if cfg.remove_dc_offset else f32(0)
        d = (fr - mu).astype(f32)
        e_raw = (d * d).sum(axis=-1)
        fr = np.concatenate([d[..., :1] * keep0, d[..., 1:] - c * d[..., :-1]], axis=-1).astype(f32)
        wf = fr * win
        e_frame = e_raw if cfg.energy_source == "raw_frame" else (wf * wf).sum(axis=-1)
    power = _emulate_tile_power(fr, cfg, frontend.BF16_PROMOTE)
    out = np.zeros((B, F, M + 1), f32)
    if kind != "spectrogram":
        consts = tchain.device_constants(cfg, torch.device("cpu"), torch.float64)
        tabs = frontend._tables(consts, "cpu")
        w, wf_ = tabs["mel_w"].numpy(), tabs["melf_w"].numpy()
        table = frontend.pass_table(consts["mel"].float()).numpy()
    npass = -(-cfg.n_bins // 136)
    acc = np.zeros((B, F, frontend.bf16_accumulators(cfg)), f32)
    e_at = 0 if kind == "spectrogram" else M
    for p in range(npass):
        pw = power[..., 136 * p : 136 * p + 136]
        if kind != "spectrogram":
            segs = table[npass + 1 :].reshape(-1, 4)[table[p] : table[p + 1]]
            for m, i0, i1, k0 in segs:
                s, sf = np.zeros((B, F), f32), np.zeros((B, F), f32)
                for j in range(i0, i1):
                    v = pw[..., k0 + j - i0]
                    if kind == "ssc":
                        v = np.where(v <= 0, eps, v)
                        sf = (sf + v * wf_[j]).astype(f32)
                    s = (s + v * w[j]).astype(f32)
                acc[..., m] += s
                if kind == "ssc":
                    acc[..., M + m] += sf
        if kind != "ssc":
            e = np.zeros((B, F), f32)
            for kk in range(pw.shape[-1]):
                e = (e + pw[..., kk]).astype(f32)
            acc[..., e_at] += e
    if kind == "spectrogram":
        out[..., :M] = _log_lane(power[..., :M], cfg.log_kind, eps, f32)
    elif kind == "ssc":
        out[..., :M] = acc[..., M:] / acc[..., :M]
    elif kind == "plp":
        out[..., :M] = acc[..., :M]
    else:
        out[..., :M] = _log_lane(acc[..., :M], cfg.log_kind, eps, f32)
    if kind != "ssc":
        if tchain.needs_conditioning(cfg) and cfg.energy_source != "pspec":
            out[..., M] = np.maximum(e_frame, eps)
        else:
            out[..., M] = np.where(acc[..., e_at] <= 0, eps, acc[..., e_at])
    return out, power, fr


def _batch(cfg, seconds, seed, rows=(1.0, 0.61)):
    sr = cfg.input_sample_rate or cfg.sample_rate
    g = np.random.default_rng(seed)
    utts = [np.round(g.standard_normal(int(sr * seconds * r)) * 3000) for r in rows]
    return pad_batch(utts + [np.zeros(0)], cfg, dtype="int16")


@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_block_plan_mirror_matches_plain(case):
    name, over = MIRROR_CASES[case]
    cfg = T_CONFIGS[name].replace(**over)
    assert frontend.bf16_layout(cfg)[0] != "staged"
    b = _batch(cfg, 1.0 if cfg.frame_step < 1000 else 2.5, sum(map(ord, case)))
    audio, lengths = torch.as_tensor(b.audio), torch.as_tensor(b.lengths)
    got, power, frames = _emulate_block_plan(b.audio, b.lengths, cfg)
    want_p = tchain.bf16x3_power(torch.as_tensor(frames), cfg).numpy()
    rowmax = want_p.max(axis=-1, keepdims=True) + 1e-30
    assert float((np.abs(power - want_p) / rowmax).max()) < 4e-6  # a few ulps of the row's max
    want = frontend.logmel_prefix_reference(audio, lengths, cfg, dft_passes="bf16x3")
    assert got.shape == tuple(want.shape)
    errs = testing.prefix_errors(got, want, cfg.n_mels, cfg.log_kind, cfg.features)
    assert not testing.prefix_failures(errs, testing.BF16X3_LOUD_ATOL), errs
    if "logmel_loud_max_abs" in errs:
        assert errs["logmel_loud_max_abs"] < 5e-5, errs  # measured at most 2.3e-5


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_block_plans_match_reference_route(case):
    name, over = REFERENCE_CASES[case]
    tcfg, jcfg = T_CONFIGS[name].replace(**over), J_CONFIGS[name].replace(**over)
    assert frontend.bf16_layout(tcfg)[0] in ("pass", "gather")
    b = _batch(tcfg, 1.5 if tcfg.frame_step < 1000 else 3.0, 19 + len(case), rows=(1.0, 0.55, 0.2))
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
    assert got.shape == ref.shape
    assert _loud_max_abs(got, ref, k) < PORT_VS_REFERENCE_LOUD
    assert _loud_max_abs(got, twin, k) < CLASS_LOUD
    assert _loud_max_abs(got, f64[..., : tcfg.n_mels].numpy(), k) < CLASS_LOUD
    np.testing.assert_allclose(st["prefix"][..., tcfg.n_mels].numpy(), np.asarray(js["energy"]),
                               rtol=1e-4, atol=1e-12)


def test_matrix_bytes_reason_and_the_matrix_cache(monkeypatch):
    """What bounds the route on a card: its matrix (8·kp·nbp bytes) or the
    host's float64 folding of it (16·min(L, n_fft)·n_bins) over the card's
    memory, named before anything is built; at n_fft = L = 131,072 on an
    80 GB card (68.7 GB of matrix, 137.4 GB folded). The card's matrices are
    cached least recently used first out past BF16_MATRIX_CACHE_BYTES."""
    c = T_CONFIGS["classic13"]
    card = 80 * 10**9
    big = c.replace(n_fft=131072, win_len_s=131072 / 16000)
    assert frontend.bf16_matrix_bytes(big) == (8 * 131072 * 65552, 16 * 131072 * 65537)
    reason = frontend.bf16_matrix_reason(big, card)
    assert "68,736,253,952 bytes" in reason and "137,441,050,624" in reason and "80,000,000,000" in reason
    assert frontend.layout_reason(big, "bf16x3") is None
    for n in (512, 4096, 16384, 65536):
        assert frontend.bf16_matrix_reason(c.replace(n_fft=n, win_len_s=n / 16000), card) is None
    assert frontend.bf16_matrix_bytes(c) == (8 * 400 * 272, 16 * 400 * 257)
    assert frontend.bf16_matrix_reason(c, 1_000_000) is not None  # folded 1.6 MB
    assert frontend.bf16_matrix_reason(T_CONFIGS["mfcc39_48k"], card) is None

    monkeypatch.setattr(frontend, "_bf16_matrices", type(frontend._bf16_matrices)())
    sizes = [c.replace(n_fft=n) for n in (512, 1024, 2048)]
    each = [frontend.bf16_matrix(x).numel() * 2 for x in sizes]
    monkeypatch.setattr(frontend, "BF16_MATRIX_CACHE_BYTES", each[0] + each[2])
    cpu = torch.device("cpu")
    m0 = frontend._device_bf16_matrix(sizes[0], cpu)
    frontend._device_bf16_matrix(sizes[1], cpu)
    assert frontend._device_bf16_matrix(sizes[0], cpu) is m0  # cached, now the newest
    frontend._device_bf16_matrix(sizes[2], cpu)  # over the bound: the least recent goes
    assert [k[0].n_fft for k in frontend._bf16_matrices] == [512, 2048]
    monkeypatch.setattr(frontend, "BF16_MATRIX_CACHE_BYTES", 1)
    frontend._device_bf16_matrix(sizes[1], cpu)  # the newest is kept whatever its size
    assert [k[0].n_fft for k in frontend._bf16_matrices] == [1024]
    torch.testing.assert_close(frontend._device_bf16_matrix(sizes[1], cpu), frontend.bf16_matrix(sizes[1]),
                               rtol=0, atol=0)
