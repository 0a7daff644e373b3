"""Every n_fft the reference takes: the front-end's plans past the gather
plan's layouts ≡ the JAX package.

The gather plan (`kernels/frontend.py::fft_layout`, csrc/frontend.cu
plan_block) stages no span and no window, but still staged the packed mel
bands and each group's two FFT rows, so an n_fft whose rows and bands were
over the block's shared memory (from 6,205 at classic13) was refused on both
devices, while the JAX package computes every size. Two plans follow it:
"gather_bands" reads the packed bands from device memory (Stockham to n_fft
25,600, Bluestein to P = 12,800), and "gather_rows", the last, keeps each
group's two rows in a workspace in device memory, so its layout does not
depend on n_fft; the packed table's words hold the bin in all 31 bits.
The cluster plan, tried before them at large FFTs, now takes most of these
sizes at CLUSTER_MIN_POINTS[form] points or more (Stockham from n_fft
16,384, Bluestein from P = 16,384; tests/test_torch_cluster.py); the two stay
the ladder's rungs after it (`fft_layout(cfg, cluster=False)`: the plan a launch takes without it).
Here, on the CPU:
- the port's CPU chain (the kernels' plain versions) ≡ the JAX jnp chain on
  the same seeded int16 rows, masks equal, at classic13_deltas n_fft 7,001,
  12,502, 13,001, 16,384 and 32,768 (5e-4), logmel80 at 16,384 (1e-4) and
  kaldi_mfcc at 16,384 (the Kaldi gate). Not the Pallas route in interpret
  mode: its DFT matrix at these sizes is gigabytes;
- the layout mirror: no Stockham or Bluestein layout refused from n_fft 16
  to 131,072 for any named family; every config the parent's five block
  plans fit keeps its plan; the "gather_rows" layout constant in n_fft; the
  tops of "gather_bands"; the bf16x3 opt-in taken where it was refused;
- the packed table at n_fft 131,072 round-trips each bin, and the offsets
  each weight's filter;
- a stream and a block launch at 16,384 ≡ the offline chain.
tests/test_torch_gpu.py and chip_smoke.py (phase 29) hold the kernel's new
plans to their plain versions on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.pipeline import StreamingExtractor

BUDGET = frontend.rs_kernel.SMEM_BUDGET_BYTES
# (config, n_fft, gate on the features' max |diff| from the JAX jnp chain)
CASES = {
    "classic13_deltas_7001": ("classic13_deltas", 7001, testing.FEATURE_ATOL),
    "classic13_deltas_12502": ("classic13_deltas", 12502, testing.FEATURE_ATOL),
    "classic13_deltas_13001": ("classic13_deltas", 13001, testing.FEATURE_ATOL),
    "classic13_deltas_16384": ("classic13_deltas", 16384, testing.FEATURE_ATOL),
    "classic13_deltas_32768": ("classic13_deltas", 32768, testing.FEATURE_ATOL),
    "logmel80_16384": ("logmel80", 16384, testing.LOGMEL_ATOL),
    "kaldi_mfcc_16384": ("kaldi_mfcc", 16384, testing.KALDI_MFCC_ATOL),
}
# the five block plans the parent tried after the warp plan, in its order
PARENT_LAYOUTS = frontend.FFT_LAYOUTS[:13]


def _ladder_plan(cfg):
    """The cluster plan at FFTs of CLUSTER_MIN_POINTS[form] points or more
    (n_fft 16,384, 32,768 and Bluestein 13,001 here), else the parent's
    plan."""
    form = frontend.dft_form(cfg)
    if frontend.fft_points(cfg.n_fft, form) >= frontend.CLUSTER_MIN_POINTS[form]:
        return "cluster"
    return frontend.fft_layout(cfg, cluster=False)[0]


def _rows(n_fft: int, seed: int):
    """Two int16 rows of 1.0 and 0.55 s at 16 kHz (zero past each length),
    and their lengths."""
    g = np.random.default_rng(seed + n_fft)
    lens = np.array([16000, 8800], np.int32)
    x = np.round(g.standard_normal((2, 16000)) * 3000).astype(np.int16)
    x[np.arange(16000)[None, :] >= lens[:, None]] = 0
    return x, lens


@pytest.mark.parametrize("case", list(CASES))
def test_chain_matches_jax_jnp(case):
    """The port's CPU chain ≡ `extract_batch(backend="jnp")` of the JAX
    package on the same int16 rows within the case's gate, masks equal; the
    port refuses nothing on either device, and the card would take a plan
    past the gather plan's layouts."""
    name, n_fft, gate = CASES[case]
    tcfg, jcfg = T_CONFIGS[name].replace(n_fft=n_fft), J_CONFIGS[name].replace(n_fft=n_fft)
    assert tchain.unsupported_reason(tcfg) is None
    assert frontend.fft_layout(tcfg, cluster=False)[0] in ("gather_bands", "gather_rows")
    assert frontend.fft_plan(tcfg) == _ladder_plan(tcfg)
    x, lens = _rows(n_fft, seed=len(case))
    feat, mask = tchain.extract_batch(x, lens, tcfg, device="cpu")
    jfeat, jmask = jchain.extract_batch(jnp.asarray(x.astype(np.float32)), jnp.asarray(lens), jcfg,
                                        backend="jnp")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    got, want = feat.numpy(), np.asarray(jfeat)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= gate, (case, err)


def test_no_stockham_or_bluestein_layout_is_refused():
    """`layout_reason` is None on a grid of n_fft from 16 to 131,072 (the
    powers of two, odd and even sizes between them, the Bluestein and
    Stockham sizes around the old tops) for every named family at its
    feature rate (a spectrogram with a lane a bin), in the Stockham or the
    Bluestein form; the cluster plan at 8 blocks a frame takes the largest,
    and without it the last plan ("gather_rows")."""
    grid = sorted({*(1 << k for k in range(4, 18, 2)), 17, 30, 551, 1102, 2501, 6205, 7001, 12502,
                   13001, 14400, 25600, 25602, 40001, 65535, 131072})
    for name in sorted(T_CONFIGS):
        base = frontend.feature_rate_config(T_CONFIGS[name])
        for n_fft in grid:
            spec = {}
            if base.features == "spectrogram":
                spec = dict(n_mels=n_fft // 2 + 1, n_ceps=min(base.n_ceps, n_fft // 2 + 1))
            cfg = base.replace(n_fft=n_fft, **spec)
            assert frontend.dft_form(cfg) in ("stockham", "bluestein")
            assert frontend.layout_reason(cfg) is None, (name, n_fft)
            assert tchain.unsupported_reason(cfg) is None, (name, n_fft)
            if n_fft == 131072:
                assert frontend.fft_layout(cfg) == ("cluster", 8), name
                assert frontend.fft_layout(cfg, cluster=False)[0] == "gather_rows", name


def _parent_layout(cfg):
    """The first of the parent's plans (warp, block, block_global, gather,
    gather_global at 4, 2 and 1 groups) that fits the block, or None."""
    form = frontend.dft_form(cfg)
    for plan, groups in PARENT_LAYOUTS:
        if frontend._fft_smem(cfg, form, plan, True, groups) <= BUDGET:
            return plan, groups
    return None


def test_every_config_that_fits_today_keeps_its_plan():
    """The two new plans come after the parent's, so every config the
    parent's plans fit keeps its plan (and the kernel's bits): the named
    families at n_fft from 256 to 12,500, hops of 10 ms to 1 s and frames of
    25 ms to 3 s; the others take "gather_bands" or "gather_rows" without the
    cluster plan, which is tried before them (at 2, 4 and 8 blocks a frame)."""
    assert PARENT_LAYOUTS[-1] == ("gather_global", 1)
    assert frontend.FFT_LAYOUTS[13:] == (
        tuple(("cluster", C) for C in frontend.CLUSTER_SIZES)
        + tuple((p, g) for p in ("gather_bands", "gather_rows", "gather_sums") for g in (4, 2, 1)))
    kept = moved = 0
    for name in sorted(T_CONFIGS):
        base = frontend.feature_rate_config(T_CONFIGS[name])
        for n_fft in (256, 512, 1102, 4096, 5393, 6001, 6204, 6205, 7001, 8192, 12500, 12502):
            for hop, win in ((0.01, 0.025), (0.2, 0.025), (1.0, 3.0)):
                spec = dict(n_mels=n_fft // 2 + 1) if base.features == "spectrogram" else {}
                cfg = base.replace(n_fft=n_fft, hop_s=hop, win_len_s=win, **spec)
                parent = _parent_layout(cfg)
                if parent is not None:
                    assert frontend.fft_layout(cfg) == parent, (name, n_fft, hop, win)
                    kept += 1
                else:
                    assert frontend.fft_plan(cfg) in ("cluster", "gather_bands", "gather_rows"), (name, n_fft)
                    assert frontend.fft_layout(cfg, cluster=False)[0] in ("gather_bands", "gather_rows")
                    moved += 1
    assert kept > 300 and moved > 30


def test_gather_rows_layout_is_constant_in_n_fft():
    """"gather_rows" stages only the groups' projection scratch (256 /
    groups thread partials and M sums a weight table) and the 8 warps'
    partials: 1,504 B at classic13 whatever n_fft, hop or frame, four frames
    a block at once; its workspace slot holds the groups' two rows
    (`row_floats`) and grows with n_fft instead. (The cluster plan, tried
    before it, takes these sizes by default.)"""
    c = T_CONFIGS["classic13"]
    sizes = {frontend._fft_smem(c.replace(n_fft=n, hop_s=hop), frontend.dft_form(c.replace(n_fft=n)),
                                "gather_rows", True, 4)
             for n in (512, 7001, 13001, 32768, 65536, 131072) for hop in (0.01, 0.5)}
    assert sizes == {4 * (4 * ((frontend.THREADS // 4 + c.n_mels + 3) & ~3) + frontend.WARPS)} == {1504}
    for n in (25602, 32768, 65536, 131072):
        cfg = c.replace(n_fft=n)
        form = frontend.dft_form(cfg)
        layout = frontend.fft_layout(cfg, cluster=False)
        assert (*layout, frontend._fft_smem(cfg, form, layout[0], True, layout[1])) == ("gather_rows", 4, 1504), n
        assert frontend.fft_plan(cfg) == "cluster", n
        slots, floats = frontend.rows_workspace(cfg, frontend.dft_form(cfg), blocks=10, resident=264)
        assert (slots, floats) == (10, 10 * 4 * 2 * frontend.row_floats(n, frontend.dft_form(cfg)))
    assert frontend.rows_workspace(c.replace(n_fft=65536), "stockham", 10**6, 264)[0] == 264


def test_tops_of_gather_bands():
    """"gather_bands" (the rows staged, the bands in device memory) takes
    Stockham sizes to n_fft 25,600 (h = 12,800: 231,600 B at classic13) and
    Bluestein sizes to P = 12,800 (7,001: 222,384 B; 12,502: 231,600 B);
    the next size of each takes "gather_rows". The sizes the gather plan's
    layout refused take the first plan that fits: without the cluster plan
    these; with it, the cluster plan wherever its size rule and a cluster
    size fit: 16,384 and 25,600 (Stockham, 8,192 points or more), 13,001
    (Bluestein P = 20,480), 25,602 (P = 32,768) and 32,768."""
    c = T_CONFIGS["classic13"]
    want = {6205: ("gather_bands", 185520), 7001: ("gather_bands", 222384),
            12502: ("gather_bands", 231600), 14400: ("gather_bands", 130800),
            16384: ("gather_bands", 148656), 25600: ("gather_bands", 231600),
            13001: ("gather_rows", 1504), 25602: ("gather_rows", 1504), 32768: ("gather_rows", 1504)}

    def parent(cfg):  # the ladder without the cluster plan: (plan, bytes)
        layout = frontend.fft_layout(cfg, cluster=False)
        return layout[0], frontend._fft_smem(cfg, frontend.dft_form(cfg), layout[0], True, layout[1])

    for n, (plan, nbytes) in want.items():
        cfg = c.replace(n_fft=n)
        assert parent(cfg) == (plan, nbytes), n
        form = frontend.dft_form(cfg)
        taken = frontend.fft_points(n, form) >= frontend.CLUSTER_MIN_POINTS[form]
        assert frontend.fft_plan(cfg) == ("cluster" if taken else plan), n
        assert taken == (n in (13001, 16384, 25600, 25602, 32768)), n
    assert frontend.bluestein_dims(12502)[2] == 12800 and frontend.bluestein_dims(13001)[2] > 12800
    stockham = [n for n in range(20000, 40001, 2) if frontend.radices(n) is not None]
    in_bands = [n for n in stockham if parent(c.replace(n_fft=n))[0] == "gather_bands"]
    assert max(in_bands) == 25600
    assert all(parent(c.replace(n_fft=n))[0] == "gather_rows" for n in stockham if n > 25600)
    blue = [n for n in range(6205, 14001, 37) if frontend.dft_form(c.replace(n_fft=n)) == "bluestein"
            and parent(c.replace(n_fft=n))[0] in ("gather_bands", "gather_rows")]
    for n in blue:
        P = frontend.bluestein_dims(n)[2]
        assert parent(c.replace(n_fft=n))[0] == ("gather_bands" if P <= 12800 else "gather_rows"), n
    sizes = {frontend.bluestein_dims(n)[2] for n in blue}
    assert {10240, 12800} <= sizes and max(sizes) > 12800
    # the bands' bytes in device memory are what the gather plan staged beside the rows
    n16 = c.replace(n_fft=16384)
    assert (frontend._fft_smem(n16, "stockham", "gather_global", True, 1)
            - frontend._fft_smem(n16, "stockham", "gather_bands", True, 1)) == 4 * frontend._bands(n16)


def test_bf16x3_is_refused_where_it_was():
    """Where the bf16x3 opt-in was refused (it staged the span: from n_fft
    2,245 at classic13, and at 7,001 and 16,384, where the default form
    runs), its block plans take it now (`frontend.bf16_layout`); so do
    60,000 filters, refused before (the packed table's filter field), in
    "gather_out"; what is still refused, on the card, is a matrix over the
    card's memory (n_fft = frame length = 131,072 on an 80 GB card)."""
    c = T_CONFIGS["classic13"]
    assert frontend.layout_reason(c.replace(n_fft=2244), "bf16x3") is None
    for n in (2245, 4096, 7001, 16384):
        assert frontend.layout_reason(c.replace(n_fft=n), "bf16x3") is None, n
        assert frontend.bf16_layout(c.replace(n_fft=n))[0] != "staged", n
        assert frontend.layout_reason(c.replace(n_fft=n)) is None
    assert frontend.layout_reason(c.replace(n_mels=60000), "bf16x3") is None
    assert frontend.bf16_layout(c.replace(n_mels=60000))[0] == "gather_out"
    wide = c.replace(n_fft=131072, win_len_s=131072 / 16000)
    assert frontend.layout_reason(wide, "bf16x3") is None
    assert "over the card's" in frontend.bf16_matrix_reason(wide, 80 * 10**9)


def test_packed_table_at_131072_round_trips():
    """At n_fft 131,072 (65,537 bins) each packed word holds its weight's
    bin in all 31 bits (the old 16-bit field widened to 17 there and left
    the filter 14), the sign bit on each filter's last weight; the filter
    is in no word: the kernel's binary search of the offsets finds it
    (`torch.searchsorted` here). The packing does not depend on the bins:
    16,384's is the same function of (off, index)."""
    for name in ("classic13_deltas", "ssc26", "logmel80"):
        cfg = T_CONFIGS[name].replace(n_fft=131072)
        mel = tchain.device_constants(cfg, torch.device("cpu"), torch.float32)["mel"]
        assert mel.shape[0] == 65537
        off, index = frontend.mel_packed(mel)
        M = mel.shape[1]
        meta = frontend.packed_meta(off, index, M).long()
        assert torch.equal(meta & 0x7FFFFFFF, index // M)  # each weight's bin
        assert torch.equal((meta < 0).nonzero()[:, 0], off[1:].long() - 1)  # each filter's last
        owner = torch.searchsorted(off[:-1].long(), torch.arange(index.numel()), right=True) - 1
        assert torch.equal(owner, index % M)  # and its filter, from the offsets alone
    # a table whose filters weigh the top bins, past the old 16-bit field
    mel = torch.zeros(65537, 3)
    mel[65530:, 0], mel[:4, 1], mel[65535:, 2] = 1.0, 1.0, 0.5
    off, index = frontend.mel_packed(mel)
    meta = frontend.packed_meta(off, index, 3).long()
    assert torch.equal(meta & 0x7FFFFFFF, index // 3) and int((meta & 0x7FFFFFFF).max()) == 65536
    # 20,000 filters over 65,537 bins, refused before (its 14-bit filter field)
    word = frontend.packed_meta(torch.tensor([0, 1], dtype=torch.int32), torch.tensor([20000 * 65536]), 20000)
    assert int(word[0]) == 65536 - (1 << 31)


@pytest.mark.parametrize("n_fft", [16384, 32768])
def test_stream_and_block_launch_match_the_offline_chain(n_fft):
    """A stream of classic13_deltas at n_fft 16,384 or 32,768 in ragged
    chunks (the block launch, here its plain version) ≡ the offline chain at
    the cepstra gate, frame counts equal; one block launch's prefix ≡ the
    offline prefix on its valid frames."""
    cfg = T_CONFIGS["classic13_deltas"].replace(n_fft=n_fft)
    assert frontend.fft_layout(cfg, cluster=False)[0] in ("gather_bands", "gather_rows")
    assert frontend.fft_plan(cfg) == _ladder_plan(cfg) == "cluster"
    g = np.random.default_rng(n_fft)
    x = np.round(g.standard_normal(16000 + 777) * 3000).astype(np.float32)
    ex = StreamingExtractor(cfg, frames_per_block=16, device="cpu")
    parts, pos = [], 0
    while pos < len(x):
        c = int(g.integers(1, 5000))
        parts.append(ex.push(x[pos : pos + c]))
        pos += c
    parts.append(ex.flush())
    got = np.concatenate(parts, axis=0)
    want = tchain.extract_single(torch.as_tensor(x), cfg, device="cpu").numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= testing.FEATURE_ATOL
    # one block launch over frames [f0, f0 + K) against the offline prefix
    audio = torch.as_tensor(x[None, :])
    lengths = torch.tensor([len(x)], dtype=torch.int32)
    offline = frontend.logmel_prefix(audio, lengths, cfg)
    K, S, L, f0 = 16, cfg.frame_step, cfg.frame_length, 7
    span = (K - 1) * S + L
    rows = audio[:, f0 * S - 1 : f0 * S + span].contiguous()
    blk = frontend.logmel_block(rows, torch.tensor([span], dtype=torch.int32), cfg)
    testing.assert_prefix_close(blk, offline[:, f0 : f0 + K], cfg.n_mels, cfg.log_kind)
