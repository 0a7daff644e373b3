"""The bf16x3 route at every n_fft, hop and frame length the reference's
takes: the block plans of csrc/frontend.cu's bf16x3 form ≡ the JAX package.

The bf16x3 form staged the tile's span, window, packed bands and the power
rows of every bin, so n_fft from 2,245 at classic13, hops from ~0.07 s and
frames from ~1 s were over the block. `frontend.bf16_layout` takes, after
that "staged" plan, the plain form's block plans (csrc/frontend.cu
logmel_kernel_bf16: two consumer warpgroups, a producer warp and three
projector warps; 128 frames a block), each pass of 136 bins projected into
per-frame accumulators while
the next pass's products run, the tile's A (bf16 hi and lo of the
conditioned frames) built once a tile from device memory: "pass" (A in
shared memory), "gather" (A in the tile's rows of a workspace, streamed
through the ring beside the matrix), "gather_bands" (the packed weights and
the pass table read from device memory too) and "gather_out" (the
accumulators in the workspace too). On the card only the matrix's bytes
bound the route (`bf16_matrix_reason`). Here, on the CPU:
  - each plan's layout, field by field (`_block_layout`, csrc/frontend.cu
    bf16_block_layout()), at n_fft 2,245 / 4,096 / 8,192 / 16,384 / 24,000
    / 32,768, hops of 1,214 and 1,600 samples, 10 ms, 1.1 s and 3 s frames,
    librosa's 8,192-point framing (L = n_fft: A in the workspace), 2,000
    and 40,000 filters, for int16 and float32 rows, and the first fit of
    `BF16_LAYOUTS`; the workspace (`bf16_workspace`);
    `layout_reason(cfg, "bf16x3")` None over a sweep of n_fft 16-16,384,
    hops to 2 s and frames to 3 s; the filter field the only layout reason
    left (60,000 filters);
  - the tile's A in wgmma's K-major core matrices (`_stage_a`, the kernel's
    16-byte units step by step) read back through the descriptors' strides
    (`_a_from_stage`) to each frame's bf16 hi and lo;
  - the pass table (`frontend.pass_table`): each packed weight in exactly
    one segment, in pass then filter order, its bin the packed table's,
    within the words the layout counts;
  - a numpy mirror of the block plans (`_emulate_block_plan`: the frames
    from the row itself, `_gather_samples`, which tests/test_torch_long_span
    holds bitwise to the staged spans; the conditioning; the tile's A staged
    and read back as the consumers' descriptors read it; the tile product of
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

import ml_dtypes
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
LIBROSA_8192 = dict(sample_rate=22050, n_fft=8192, win_len_s=8192 / 22050, hop_s=2048 / 22050, n_mels=128)
LAYOUT_CASES = {
    "n_fft_2245": ("classic13", dict(n_fft=2245), ("gather", 128, 4)),
    "n_fft_4096": ("classic13", dict(n_fft=4096), ("gather", 128, 4)),
    "n_fft_8192": ("classic13", dict(n_fft=8192), ("gather", 128, 4)),
    "n_fft_16384": ("classic13", dict(n_fft=16384), ("gather", 128, 3)),
    "hop_1214": ("classic13", dict(hop_s=1214 / 16000), ("gather", 128, 4)),
    "hop_1600": ("classic13", dict(hop_s=0.1), ("gather", 128, 4)),
    "frames_1.1s": ("classic13", dict(win_len_s=1.1), ("gather", 128, 2)),
    "frames_3s": ("classic13", dict(win_len_s=3.0), ("gather", 128, 2)),
    "kaldi_dither_4096": ("kaldi_mfcc", dict(dither=1.0, n_fft=4096), ("gather", 128, 4)),
    "ssc_4096": ("ssc26", dict(n_fft=4096), ("gather", 128, 3)),
    "n_fft_24000": ("classic13", dict(n_fft=24000), ("gather", 128, 2)),
    "filters_2000": ("classic13", dict(n_mels=2000, n_fft=4096), ("gather_out", 128, 4)),
    "ssc_filters_1500": ("ssc26", dict(n_mels=1500, n_fft=4096), ("gather_out", 128, 4)),
    "frames_10ms_4096": ("classic13", dict(win_len_s=0.01, n_fft=4096), ("pass", 128, 2)),
    "n_fft_32768": ("classic13", dict(n_fft=32768), ("gather_bands", 128, 4)),
    "librosa_8192": ("logmel80", LIBROSA_8192, ("gather_out", 128, 3)),
    "filters_40000": ("classic13", dict(n_mels=40000), ("gather_out", 128, 4)),
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
    """csrc/frontend.cu bf16_block_layout() of a bf16x3 block plan, field by
    field (floats; the row type changes nothing): the packed weights (and
    SSC's melf weights), the filters' offsets (M + 1) and the pass table
    (npass + 1 offsets and 4 words for
    each of at most n_packed // 136 + 2M segments) unless they are read from
    device memory; at a 128-byte boundary the ring (17,408 B a stage, and 64
    B a frame of the tile's A where A is in the workspace), its full and
    empty mbarriers (8 B each) and the claim counter (4 floats); at a
    128-byte boundary the tile's A under "pass" (kp floats a frame: bf16 hi
    and lo); the power rows (stride 137), or where a pass takes more than 25
    steps the re/im rows (272 columns and 8 of padding) that then take its
    powers; the frames' energies and means; the accumulators (M + 1 a
    frame, 2M for SSC, 1 for a spectrogram) unless they are in device
    memory. No signal span, window or bin words."""
    gather, bands_dev, acc_dev = {"pass": (0, 0, 0), "gather": (1, 0, 0), "gather_bands": (1, 1, 0),
                                  "gather_out": (1, 1, 1)}[plan]
    M, nnz = cfg.n_mels, frontend.packed_count(cfg)
    tables = {"spectrogram": 0, "ssc": 2}.get(frontend.feature_kind(cfg), 1)
    npass = -(-cfg.n_bins // 136)
    kp = -(-min(cfg.frame_length, cfg.n_fft) // 16) * 16
    n = 0
    if not bands_dev and tables:
        n += tables * _a4(nnz) + _a4(M + 1) + _a4(npass + 1 + 4 * (nnz // 136 + 2 * M))
    n = (n + 31) // 32 * 32 + stages * (17408 + (64 * tile if gather else 0)) // 4 + 2 * 2 * stages + 4
    n = (n + 31) // 32 * 32 + (0 if gather else tile * kp)
    n += tile * (280 if kp // 16 > 25 else 137) + 2 * tile
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
    assert frontend.bf16_layout(c.replace(n_mels=60000)) == ("gather_out", 128, 4)
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


def _bf16_bits(x):
    """The bf16 bits of float32 x, rounded to nearest even (the kernel's
    __float2bfloat16_rn)."""
    return x.astype(ml_dtypes.bfloat16).view(np.uint16)


def _stage_a(g, tile):
    """The tile's A as csrc/frontend.cu logmel_kernel_bf16 step 2a writes
    it: g [tile, kp] float32 (the conditioned samples, zero past min(L,
    n_fft) and in frames past F) → [steps, 2, tile x 16] bf16 bits, step s
    hi then lo, 16-byte unit u = s x 2 tile + v holding frame (v >> 4) x 8 +
    (v & 7), samples 16 s + (v & 8) .. + 7."""
    kp = g.shape[1]
    steps = kp // 16
    hi = g.astype(ml_dtypes.bfloat16).astype(np.float32)
    lo = (g - hi).astype(ml_dtypes.bfloat16).astype(np.float32)
    out = np.zeros((steps, 2, tile * 16), np.uint16)
    v = np.arange(2 * tile)
    fl, k8 = (v >> 4) * 8 + (v & 7), v & 8
    for s in range(steps):
        k = 16 * s + k8[:, None] + np.arange(8)  # [units, 8]
        out[s, 0] = _bf16_bits(hi[fl[:, None], k]).reshape(-1)
        out[s, 1] = _bf16_bits(lo[fl[:, None], k]).reshape(-1)
    return out


def _a_from_stage(stage, rbase):
    """A's 64 rows from `rbase` as the consumers' wgmma descriptors read
    them from `_stage_a`'s layout: K-major core matrices of 8 rows x 16
    bytes, the start rbase x 32 bytes on, the two K halves 128 bytes apart
    (LBO), 8-row groups 256 bytes apart (SBO) → (hi, lo) [64, kp] bits."""
    steps = stage.shape[0]
    m, k = np.arange(64)[:, None], np.arange(16)[None, :]
    at = rbase * 16 + (m // 8) * 128 + (k // 8) * 64 + (m % 8) * 8 + k % 8  # bf16 elements
    return tuple(np.concatenate([stage[s, part][at] for s in range(steps)], axis=1) for part in (0, 1))


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
    # the tile's A, staged in the kernel's layout and read back as the two
    # consumer warpgroups' descriptors read it: the bf16 hi and lo of each
    # frame's first min(L, n_fft) conditioned samples, zero to kp
    plan, tile, _ = frontend.bf16_layout(cfg)
    kp, le = frontend.bf16_dims(cfg)[0], min(L, cfg.n_fft)
    g = np.zeros((B, -(-F // tile) * tile, kp), f32)
    g[:, :F, :le] = fr[..., :le]
    for b in range(B):
        for t0 in range(0, F, tile):
            stage = _stage_a(g[b, t0 : t0 + tile], tile)
            for rbase in range(0, tile, 64):
                hi, lo = _a_from_stage(stage, rbase)
                want = g[b, t0 + rbase : t0 + rbase + 64]
                np.testing.assert_array_equal(hi, _bf16_bits(want))
                np.testing.assert_array_equal(
                    lo, _bf16_bits(want - want.astype(ml_dtypes.bfloat16).astype(f32)))
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


@pytest.mark.parametrize("kp", [160, 400, 512, 1024])
def test_a_staging_reads_back_through_the_descriptors(kp):
    """The tile's A (`_stage_a`, the kernel's units) read through the
    consumers' descriptors (`_a_from_stage`) at each warpgroup's first row
    (0 and 64) gives each frame's bf16 hi and lo back; every unit written
    once; A of a step is tile x 64 bytes (BF16_A_CHUNK a frame), hi then lo."""
    tile = frontend.BF16_BLOCK_TILE
    g = (np.random.default_rng(kp + tile).standard_normal((tile, kp)) * 3000).astype(np.float32)
    stage = _stage_a(g, tile)
    assert stage.nbytes == kp // 16 * tile * frontend.BF16_A_CHUNK
    for rbase in range(0, tile, 64):
        hi, lo = _a_from_stage(stage, rbase)
        rows = g[rbase : rbase + 64]
        h = rows.astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(hi, _bf16_bits(rows))
        np.testing.assert_array_equal(lo, _bf16_bits(rows - h))
    # each frame's sample in exactly one unit of each step
    v = np.arange(2 * tile)
    seen = np.zeros((tile, 16), int)
    for fl, k8 in zip((v >> 4) * 8 + (v & 7), v & 8):
        seen[fl, k8 : k8 + 8] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("case", ["n_fft_4096", "librosa_8192", "filters_40000", "frames_10ms_4096"])
def test_block_workspace_holds_the_accumulators_then_each_tiles_a(case):
    """`bf16_workspace` (csrc/frontend.cu bf16_workspace): "gather_out" the
    accumulators [B, F, nacc] rounded up to 128 bytes, then, past "pass",
    each tile's A (tile x kp floats); "pass" none."""
    name, over, (plan, tile, _) = LAYOUT_CASES[case]
    cfg = T_CONFIGS[name].replace(**over)
    B, F = 3, 1000
    kp = frontend.bf16_dims(cfg)[0]
    acc = -(-B * F * frontend.bf16_accumulators(cfg) // 32) * 32 if plan == "gather_out" else 0
    a = B * -(-F // tile) * tile * kp if plan != "pass" else 0
    assert frontend.bf16_workspace(cfg, B, F) == acc + a
    assert acc % 32 == 0  # the A region's bulk copies start 128-byte aligned


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
