"""The plans of tens of thousands of filters: the front-end's wide plan and
the feature tail's base kernel past 1,024 lanes.

The wide plan (csrc/frontend.cu `logmel_kernel_wide`, `fft_layout`'s
"wide") takes a tile of frames a block: its groups transform the frames
into power rows in shared memory, then thread t projects filters t, t +
256, ..., each filter's weights read once and summed in packed order for
each frame of the tile, its lane stored once. The tail's base kernel
(csrc/tail.cu `tail_base_kernel`) sweeps the lanes of a tile of 64 frames in
chunks, each warp a compensated sum over its stretches, the warps' sums
added in float64. Here, on the CPU:
- a numpy mirror of the wide projection's loop (the tile, filters across
  threads, frames inner): bitwise `_project`'s packed order in float32 (and
  the parent plans' balanced order where every filter has one weight),
  within 1e-12 of the dense product in float64, every lane stored once;
- the layout mirror: the tile, the groups, the shared memory and the
  ladder's choice at 26, 28,797, 40,000, 57,849 and 60,000 filters, held
  to csrc/frontend.cu's wide_layout and plan_wide;
- the tail base's lane partition and staging, and its sum order emulated in
  float32 at 16,385, 40,000 and 60,000 filters against the float64 product.
tests/test_torch_gpu.py and chip_smoke.py (phase 31) hold the kernels to
their plain versions on a card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend, tail
from mfcc_tpu_torch.ops import chain as tchain
from tests.test_torch_frontend import _project
from tests.test_torch_many_filters import _rows, _split_base, _table

CSRC = pathlib.Path(__file__).resolve().parents[1] / "mfcc_tpu_torch" / "kernels" / "csrc"
BUDGET = frontend.rs_kernel.SMEM_BUDGET_BYTES
THREADS = 256  # csrc/frontend.cu kThreads
CASES = {
    "classic13": ("classic13", {}),
    "classic13_deltas_40000": ("classic13_deltas", dict(n_mels=40000)),
    "ssc26_30000_4096": ("ssc26", dict(n_mels=30000, n_fft=4096)),
}


def _cfg(case):
    name, over = CASES[case]
    return T_CONFIGS[name].replace(**over)


def _wide_sums(P, w, wf, meta, off, eps, ssc, tile):
    """csrc/frontend.cu logmel_kernel_wide's stage 2 in numpy, on power rows
    P [nf, bins] in tiles of `tile` frames. From WIDE_CHUNK_TILE frames a
    tile (`chunked`): the filters 2,048 at a time, thread t of 256 taking
    filters c0 + t + 256 k (k < 8), their weights read once a chunk, then
    frame after frame their lanes; below it (`filter_major`): thread t takes
    filters t, t + 256, ..., each one's weights read once, then its lane
    frame after frame. Either way a lane is its filter's weights summed in
    packed order from 0 (SSC: the clamped power, the melf sum beside).
    Returns the sums [nf, M], the melf sums and the stores to each (frame,
    lane)."""
    nf, M = P.shape[0], len(off) - 1
    sums, sumsf = np.full((nf, M), np.nan, P.dtype), np.full((nf, M), np.nan, P.dtype)
    stores = np.zeros((nf, M), np.int64)

    def lane(f, m):
        i0, n = int(off[m]), int(off[m + 1] - off[m])
        acc, accf = P.dtype.type(0), P.dtype.type(0)
        for k, wk, wfk in zip(meta[i0:i0 + n] & 0x7FFFFFFF, w[i0:i0 + n], wf[i0:i0 + n]):
            q = P[f, k]
            if ssc:
                q = P.dtype.type(eps) if q <= 0 else q
                accf = accf + q * wfk
            acc = acc + q * wk
        sums[f, m], sumsf[f, m] = acc, accf
        stores[f, m] += 1

    for f0 in range(0, nf, tile):
        frames = range(f0, min(f0 + tile, nf))
        if tile >= frontend.WIDE_CHUNK_TILE:  # chunked
            for c0 in range(0, M, 8 * THREADS):
                for f in frames:
                    for t in range(THREADS):
                        for k in range(8):
                            if c0 + t + k * THREADS < M:
                                lane(f, c0 + t + k * THREADS)
        else:  # filter_major
            for t in range(THREADS):
                for m in range(t, M, THREADS):
                    for f in frames:
                        lane(f, m)
    return sums, sumsf, stores


@pytest.mark.parametrize("case", list(CASES))
def test_wide_projection_mirror_keeps_the_sums_order(case):
    """The wide plan's projection (`_wide_sums`) in float32: bitwise the
    packed order of `_project` at one lane (each filter a chain from 0), and
    where every filter has one weight (40,000 filters; ssc26 at 30,000 and
    n_fft 4,096) bitwise the parent plans' balanced order too (a warp's 32
    lanes, a group's 64 and 256 threads), in tiles that take the filters one
    at a time (2 frames, the last one short) and a chunk at a time (16);
    within 1e-12 of the dense product in float64; every output lane stored
    exactly once."""
    cfg = _cfg(case)
    mel, off, index, meta = _table(cfg)
    M = mel.shape[1]
    ssc = cfg.features == "ssc"
    w = mel.numpy().reshape(-1)[index]
    melf = frontend._tables(tchain.device_constants(cfg, torch.device("cpu"), torch.float64), "cpu")["melf_w"]
    wf = melf.numpy() if ssc else np.zeros_like(w)
    meta = meta.numpy().astype(np.int64)
    kbin = index // M
    g = np.random.default_rng(M)
    P = g.exponential(size=(5, mel.shape[0]))
    P[1, ::7] = 0.0  # zero bins: SSC's clamp
    one = frontend.packed_count(cfg) == M
    assert one == (case != "classic13")
    for dtype, tile in ((np.float32, 2), (np.float32, frontend.WIDE_CHUNK_TILE), (np.float64, 3)):
        Pd, wd, wfd = P.astype(dtype), w.astype(dtype), wf.astype(dtype)
        got, gotf, stores = _wide_sums(Pd, wd, wfd, meta, off, cfg.log_eps, ssc, tile)
        assert (stores == 1).all()
        for lanes in (1, 32, 64, 256) if one else (1,):
            want, wantf = _project(Pd, wd, wfd, off, kbin, cfg.log_eps, ssc, lanes)
            np.testing.assert_array_equal(got, want)
            if ssc:
                np.testing.assert_array_equal(gotf, wantf)
    Pc = np.where(P <= 0, cfg.log_eps, P) if ssc else P
    dense = Pc @ mel.numpy().astype(np.float64)
    np.testing.assert_allclose(got, dense, rtol=1e-12, atol=1e-12 * np.abs(dense).max())


def _wide_bytes(cfg, groups, tile):
    """csrc/frontend.cu wide_layout in bytes, written out: groups x two FFT
    rows of 2 (h + h/8 + 1) floats rounded up to 4 (h the form's points),
    tile power rows of bins rounded up to 4, the tile's energies rounded up
    to 4, 8 warps' partials."""
    h = frontend.fft_points(cfg.n_fft, frontend.dft_form(cfg))
    row = (2 * (h + h // 8 + 1) + 3) & ~3
    return 4 * (groups * 2 * row + tile * ((cfg.n_bins + 3) & ~3) + ((tile + 3) & ~3) + 8)


def test_wide_layout_mirror_and_the_ladder():
    """The wide plan's layout (`wide_smem`, `wide_layout`): the groups the
    first of 4, 2, 1 whose rows fit beside one power row, the tile the most
    frames whose layout fits WIDE_TWO_BLOCKS bytes (two blocks an SM), else
    the block, at most WIDE_MAX_TILE; the source's wide_layout and plan_wide
    lay it out so (its chunked projection from kWideChunkTile frames, the
    mirror's WIDE_CHUNK_TILE). The ladder's choice at 26, 28,797, 40,000, 57,849 and
    60,000 filters: the warp plan at 26, the wide plan at the others, where
    without it "gather_bands" or "gather_sums" (from 57,849, 28,797 for SSC)
    took them; "gather_sums" stays where one frame's power row does not fit
    beside the FFT rows (n_fft 32,768); nothing refused; a spectrogram never
    takes it."""
    src = (CSRC / "frontend.cu").read_text()
    body = re.search(r"inline WideLayout wide_layout\(const Params& p\) \{(.*?)\n\}", src, re.S).group(1)
    for line in ("l.row = align4(2 * (p.fft_n + (p.fft_n >> 3) + 1));", "l.pw = p.groups * 2 * l.row;",
                 "l.en = l.pw + p.tile * p.pws;", "l.red = l.en + align4(p.tile);", "l.total = l.red + kWarps;"):
        assert line in body
    assert "q.pws = align4(q.bins);" in src and "for (q.groups = 4; q.groups >= 1; q.groups /= 2) {" in src
    assert "__global__ void __launch_bounds__(kThreads, 2)\nlogmel_kernel_wide(" in src
    assert frontend.WIDE_TWO_BLOCKS == (233472 // 2) - 1024  # an SM's 228 KB for two, 1 KB each reserved
    c, s = T_CONFIGS["classic13_deltas"], T_CONFIGS["ssc26"]
    want = {  # (base, filters): (layout, the parent's plan)
        (c, 26): (("warp", 8), "warp"), (c, 28797): (("wide", 32), "gather_bands"),
        (c, 40000): (("wide", 32), "gather_bands"), (c, 57849): (("wide", 32), "gather_sums"),
        (c, 60000): (("wide", 32), "gather_sums"), (s, 26): (("warp", 8), "warp"),
        (s, 28797): (("wide", 32), "gather_sums"), (s, 40000): (("wide", 32), "gather_sums"),
        (s, 57849): (("wide", 32), "gather_sums"), (s, 60000): (("wide", 32), "gather_sums"),
        (s.replace(n_fft=4096), 30000): (("wide", 10), "gather_sums"),
        (c.replace(n_fft=8192), 33000): (("wide", 5), "gather_bands"),
    }
    for (base, M), (layout, parent) in want.items():
        cfg = base.replace(n_mels=M)
        assert frontend.fft_layout(cfg) == layout, (base.name, base.n_fft, M)
        assert frontend.fft_layout(cfg, wide=False)[0] == parent, (base.name, base.n_fft, M)
        assert frontend.layout_reason(cfg) is None
        if layout[0] != "wide":
            continue
        groups, tile = frontend.wide_layout(cfg)
        assert tile == layout[1] and groups == frontend.wide_groups(cfg, frontend.dft_form(cfg), tile)
        nbytes = _wide_bytes(cfg, groups, tile)
        assert frontend.smem_bytes(cfg) == frontend.wide_smem(cfg, frontend.dft_form(cfg), groups, tile) == nbytes
        budget = frontend.WIDE_TWO_BLOCKS if nbytes <= frontend.WIDE_TWO_BLOCKS else BUDGET
        assert nbytes <= budget < _wide_bytes(cfg, groups, tile + 1) or tile == frontend.WIDE_MAX_TILE
        assert groups == 4 or _wide_bytes(cfg, groups * 2, 1) > BUDGET
    far = c.replace(n_mels=60000, n_fft=32768)
    assert frontend.wide_layout(far) is None and frontend.fft_layout(far) == ("gather_sums", 4)
    spec = T_CONFIGS["kaldi_spectrogram"]
    assert frontend.wide_layout(spec) is None
    # the rule's filter count is where "gather_bands" is first taken at n_fft
    # 512; below it that plan keeps its configs (at n_fft 8,192, from 9,815)
    at = c.replace(n_mels=frontend.WIDE_MIN_FILTERS)
    assert frontend.fft_layout(at, wide=False)[0] == "gather_bands" and frontend.fft_plan(at) == "wide"
    assert frontend.fft_layout(c.replace(n_mels=frontend.WIDE_MIN_FILTERS - 1))[0] == "gather_global"
    below = c.replace(n_mels=frontend.WIDE_MIN_FILTERS - 1, n_fft=8192)
    assert frontend.fft_layout(below)[0] == "gather_bands" and frontend.wide_layout(below) is not None
    src_tile = int(re.search(r"constexpr int kWideChunkTile = (\d+);", src).group(1))
    assert src_tile == frontend.WIDE_CHUNK_TILE <= frontend.WIDE_MAX_TILE


def test_wide_tile_fills_the_card():
    """The launch's tile (`wide_tile`): the layout's, or fewer frames a block
    where the launch's frames would leave resident slots idle, at least one:
    60,000 filters at b16 x 10 s (15,984 frames) keeps 32 a block on 264
    slots, at b4 takes 16, a single short row 1; ssc26's 10 at n_fft 4,096
    stays 10 on 132 slots."""
    assert frontend.wide_tile(32, 16 * 999, 264) == 32
    assert frontend.wide_tile(32, 4 * 999, 264) == 16
    assert frontend.wide_tile(32, 5, 264) == 1
    assert frontend.wide_tile(10, 16 * 999, 132) == 10
    for frames in range(1, 5000, 37):
        t = frontend.wide_tile(32, frames, 264)
        assert 1 <= t <= 32 and (t == 32 or -(-frames // t) <= 264 or t == 1)


def test_tail_base_partition_and_staging():
    """tail_base_kernel's sweep (csrc/tail.cu, mirrored): warp w's chunks,
    kBaseLanes lanes each, of stretches w, w + 8, ... of kStretch lanes,
    cover every lane below M1 - 1 exactly once, in lane order within a warp;
    a row's chunk staged from the 16-byte boundary at or below its first
    lane needs at most kBaseRow / 4 copies of 16 bytes at any shift; the
    warps' float64 sums fit the stages' shared memory, which fits the
    block; the mirror's constants are the source's."""
    src = (CSRC / "tail.cu").read_text()
    value = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))  # noqa: E731
    assert (value("kBaseTile"), value("kBaseCols"), value("kStretch"), value("kChainLanes")) == (
        tail.BASE_TILE, tail.BASE_COLS, tail.STRETCH, tail.CHAIN_LANES)
    lanes_a_chunk, stages = value("kBaseLanes"), value("kBaseStages")
    row = lanes_a_chunk + 4
    per = tail.STRETCH // lanes_a_chunk
    stage = tail.BASE_TILE * row + lanes_a_chunk * tail.BASE_COLS
    assert 4 * tail.BASE_WARPS * stages * stage <= BUDGET
    assert tail.BASE_WARPS * tail.BASE_TILE * tail.BASE_COLS * 8 <= 4 * tail.BASE_WARPS * stages * stage
    for lanes in (1025, 16384, 39999, 60000):
        stretches = -(-lanes // tail.STRETCH)
        seen = np.zeros(lanes, np.int64)
        for w in range(tail.BASE_WARPS):
            chunks = (-(-(stretches - w) // tail.BASE_WARPS) if stretches > w else 0) * per
            last = -1
            for c in range(chunks):
                k0 = (w + tail.BASE_WARPS * (c // per)) * tail.STRETCH + (c % per) * lanes_a_chunk
                nl = min(lanes_a_chunk, lanes - k0)
                if nl <= 0:
                    continue
                assert k0 > last
                seen[k0:k0 + nl] += 1
                last = k0
        assert (seen == 1).all(), lanes
    for shift in range(4):
        for nl in range(1, lanes_a_chunk + 1):
            copies = sum(1 for q in range(row // 4) if 4 * q < shift + nl)
            assert copies == -(-(shift + nl) // 4) <= row // 4


def _stretch_chains(x, aug, lanes: int):
    """Plain FMA chains (float32, each FMA rounded once) over stretches of
    `lanes` lanes of prefix rows x [n, M1 - 1], the stretches' partials added
    exactly (float64): the uncompensated order the base kernel does not
    take."""
    f32 = lambda a: np.asarray(a, np.float64).astype(np.float32).astype(np.float64)  # noqa: E731
    out = np.zeros((x.shape[0], aug.shape[1]))
    for a in range(0, x.shape[1], lanes):
        acc = np.zeros_like(out)
        for m in range(a, min(a + lanes, x.shape[1])):
            acc = f32(x[:, m : m + 1].astype(np.float64) * aug[m][None, :].astype(np.float64) + acc)
        out += acc
    return out


@pytest.mark.parametrize("M", [16385, 40000, 60000])
def test_tail_base_sum_order_within_a_hundredth_of_the_gate(M):
    """tail_base_kernel's sum order (`_split_base`: each warp's compensated
    sum over its stretches, the warps' sums added in float64), emulated in
    float32 on a front-end prefix of classic13_deltas at M filters: within
    a hundredth of the tail's gate (max(2e-4, 2e-5·max|f|)) of the float64
    product; the split takes it (`tail.split_base`). At 40,000 filters plain
    FMA chains over stretches of 256 or 16 lanes, the stretches added
    exactly, are not (why every lane joins a compensated sum)."""
    cfg = T_CONFIGS["classic13_deltas"].replace(n_mels=M)
    assert tail.plan(cfg)[0] == "split" and tail.split_base(cfg) == "stretches"
    x, lens = _rows(M)
    prefix, _, _ = frontend.logmel_prefix_counts(torch.as_tensor(x[:1, :4000]), torch.as_tensor(lens[:1] * 0 + 4000),
                                                 cfg)
    p = prefix[0, :, : cfg.n_mels].numpy().astype(np.float32)
    aug = tchain.device_constants(cfg, torch.device("cpu"), torch.float64)["dct_aug"].numpy().astype(np.float32)
    exact = p.astype(np.float64) @ aug[: cfg.n_mels].astype(np.float64)
    gate = max(testing.TAIL_ATOL, testing.TAIL_REL * np.abs(exact).max())
    err = np.abs(_split_base(p, aug, tail.CHAIN_LANES) - exact).max()
    assert err < gate / 100, (err, gate)
    if M == 40000:
        for lanes in (tail.STRETCH, 16):
            assert np.abs(_stretch_chains(p, aug, lanes) - exact).max() > gate / 100, lanes


def test_breakdown_cuts_find_their_anchors():
    """scripts/frontend_breakdown.py's cuts (chip_smoke.py phase 2 builds
    them) find their anchors in this source, where the block plans' group
    loop and the wide plan's stage 1 share the frame code (csrc/frontend.cu
    group_frame): P1 returns from group_frame after step 2g, and both
    callers then skip the frame's FFT; and in an older source, whose block
    plans staged the frame in their own loop."""
    import sys

    sys.path.insert(0, str(CSRC.parents[2] / "scripts"))
    import frontend_breakdown as fb

    src = (CSRC / "frontend.cu").read_text()
    cuts = fb.variants(src)
    assert sorted(cuts) == [0, 1, 2] and all(t.startswith(f"#define CUT {k}\n") for k, t in cuts.items())
    body = cuts[1]
    frame = body[body.index("__device__ __forceinline__ void group_frame("):]
    frame = frame[:frame.index("\n}\n")]
    assert fb.CUT_GATHER_STAGED in frame
    assert fb.CUT_GATHER_FRAME in body and fb.CUT_WIDE_STAGED in body and fb.CUT_WIDE_PROJECTION in body
    older = src.replace(fb.GATHER_STAGED, "").replace(fb.GATHER_FRAME, "") + fb.OLD_GATHER_STAGED
    assert fb.CUT_OLD_GATHER_STAGED in fb.variants(older)[1]
