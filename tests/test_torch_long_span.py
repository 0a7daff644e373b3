"""Every hop and frame length the reference takes: the front-end's gather
plan and the feature tail's plans for wide cepstra ≡ the JAX package.

The front-end kernel staged each tile's span, (32 - 1)·S + L samples, and a
window of max(L, n_fft) floats in shared memory, so long hops and long
frames were over the block whatever n_fft was. Its gather plan
(`kernels/frontend.py::fft_layout`, csrc/frontend.cu plan_block, tried only
after every other plan fails) stages neither: each group reads its frame
from the row in device memory (csrc/frontend.cu staged_at). The feature
tail, where its tiled layout does not fit (dct_aug, the staged rows and
their halo), takes the split, three passes through the output ("split").
Here, on
the CPU:
- the port's CPU chain ≡ the JAX jnp chain at each family's gate
  (`tests/test_torch_longform.py::_assert_close`: 5e-4 on cepstra; 8e-4 on
  resampled cepstra; the Kaldi gate; the Whisper gate, 5e-5; the two-regime
  log-mel gate; for 170 and 200 cepstra the reference's tail gate,
  max(2e-4, 2e-5·max|f|), `_gate`), and at two rows ≡ the JAX package's Pallas route in
  interpret mode at the same gates, masks equal, for every config of
  `CASES`; `chain.unsupported_reason` is None for each;
- a numpy mirror of the gather plan's sample (`_gather_samples`: source
  index, pre-emphasis neighbour, zeroing, reflection, dither key, origin 1)
  bitwise the staged-span mirror (`_stage_tile`) on tiles where both fit;
- the kernel's numpy mirror (`_emulate_kernel`) in the gather plan ≡ the
  plain version in float64 within 1e-9;
- the plan of every config that fits a plan today is kept; the layouts,
  the refusal map that remains (the FFT rows and packed bands of an n_fft,
  never a hop, a frame length or a tail shape);
- a stream at a 0.2 s hop ≡ the offline chain.
The feature tail's kernel mirror in its new plans is in
tests/test_torch_tail.py (`_emulate_tail`); tests/test_torch_gpu.py and
chip_smoke.py (phase 28) hold the kernels to their plain versions on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu.pipeline import pad_batch as j_pad_batch
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend, tail
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.ops import dither as tdither
from mfcc_tpu_torch.pipeline import StreamingExtractor
from tests.test_torch_frontend import TILE, _emulate_kernel, _gather_samples, _reference, _stage_tile
from tests.test_torch_longform import _assert_close

# librosa's melspectrogram at n_fft 8192 (win_length n_fft, hop_length
# win_length // 4) and a 44.1 kHz framing of 4096 at hop 2048, as logmel80
# overrides with 128 mels
LIBROSA_8192 = dict(sample_rate=22050, n_fft=8192, win_len_s=8192 / 22050, hop_s=2048 / 22050, n_mels=128)
K44_4096 = dict(sample_rate=44100, n_fft=4096, win_len_s=4096 / 44100, hop_s=2048 / 44100, n_mels=128)
CASES = {
    "classic13_deltas_hop_0.2": ("classic13_deltas", dict(hop_s=0.2)),
    "classic13_deltas_hop_1.0": ("classic13_deltas", dict(hop_s=1.0)),
    "classic13_deltas_frames_3s": ("classic13_deltas", dict(win_len_s=3.0)),
    "kaldi_mfcc_dither_hop_0.25": ("kaldi_mfcc", dict(dither=1.0, hop_s=0.25)),
    "whisper80_hop_0.2": ("whisper80", dict(hop_s=0.2)),
    "librosa_8192_hop_2048": ("logmel80", LIBROSA_8192),
    "logmel_44k_4096_hop_2048": ("logmel80", K44_4096),
    "mfcc39_48k_hop_0.2": ("mfcc39_48k", dict(hop_s=0.2)),
    "tail_170_cepstra_window_8": ("classic13_deltas", dict(n_mels=170, n_ceps=170, delta_window=8)),
    "tail_200_cepstra_window_40": ("classic13_deltas", dict(n_mels=200, n_ceps=200, delta_window=40)),
}
# the front-end plan (at the feature rate) and the tail plan each case takes
PLANS = {
    "classic13_deltas_hop_0.2": (("gather", 4), "staged"),
    "classic13_deltas_hop_1.0": (("gather", 4), "staged"),
    "classic13_deltas_frames_3s": (("gather", 4), "staged"),
    "kaldi_mfcc_dither_hop_0.25": (("gather", 4), "staged"),
    "whisper80_hop_0.2": (("gather", 4), None),
    "librosa_8192_hop_2048": (("gather", 1), None),
    "logmel_44k_4096_hop_2048": (("gather", 4), None),
    "mfcc39_48k_hop_0.2": (("gather", 4), "staged"),
    "tail_170_cepstra_window_8": (("warp", 8), "split"),
    "tail_200_cepstra_window_40": (("warp", 8), "split"),
}


def _gate(case, cfg, got, want):
    """The family's gate (`_assert_close`); for the wide-cepstra tail cases
    the reference's own tail gate (tests/test_pallas_kernels.py::
    _TAIL_CASES), max(2e-4, 2e-5·max|f|) absolute, which scales with the
    features: cepstra of ~500 carry ~2e-3 of fp32 noise from float64 in
    either chain (the JAX jnp chain 2.9e-3, the port's 1.9e-3 at 170
    cepstra), over the 5e-4 of 13 cepstra of tens."""
    if case.startswith("tail_"):
        np.testing.assert_allclose(got, want, atol=max(2e-4, 2e-5 * float(np.abs(want).max())), rtol=0)
    else:
        _assert_close(cfg, got, want)


def _configs(case):
    name, over = CASES[case]
    return T_CONFIGS[name].replace(**over), J_CONFIGS[name].replace(**over)


def _rows(cfg, seconds, seed):
    """int16-valued rows of the given lengths in seconds at cfg's input rate
    (zero past each length), as float32, padded by the JAX package."""
    g = np.random.default_rng(seed)
    sr = cfg.input_sample_rate or cfg.sample_rate
    utts = [np.round(g.standard_normal(int(sr * s)) * 3000) for s in seconds]
    b = j_pad_batch(utts, cfg)
    return b.audio.astype(np.float32), b.lengths


@pytest.mark.parametrize("case", sorted(CASES))
def test_plans_and_support(case):
    """Each case is taken on both devices (`unsupported_reason` is None: the
    CPU chain and the card's wrappers check the same mirror), in the plan
    `PLANS` names; mfcc39_48k at a 0.2 s hop takes the split route, whose
    second launch plans at 16 kHz."""
    tcfg, _ = _configs(case)
    assert tchain.unsupported_reason(tcfg) is None
    assert frontend.fft_layout(frontend.feature_rate_config(tcfg)) == PLANS[case][0]
    assert (tail.plan(tcfg)[0] if tcfg.features == "mfcc" else None) == PLANS[case][1]
    if tchain.resamples(tcfg):
        assert frontend.resample_route(tcfg) == "split"


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_matches_jax_jnp(case):
    """The port's CPU chain (int16 rows of 4.0, 2.5 and 0.3 s) ≡ the JAX jnp
    chain at the family's gate, masks equal."""
    tcfg, jcfg = _configs(case)
    x, lens = _rows(jcfg, (4.0, 2.5, 0.3), seed=sum(map(ord, case)))
    feat, mask = tchain.extract_batch(x.astype(np.int16), lens, tcfg, device="cpu")
    jfeat, jmask = jchain.extract_batch(jnp.asarray(x), jnp.asarray(lens), jcfg, backend="jnp")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    valid = mask.numpy() > 0
    assert valid.sum() > 0 and feat.shape == np.asarray(jfeat).shape
    _gate(case, tcfg, feat.numpy()[valid], np.asarray(jfeat)[valid])
    assert (feat.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_matches_jax_pallas_interpret(case):
    """At two rows, the port's CPU chain ≡ the JAX package's Pallas route in
    interpret mode (its slab and view modes frame any hop and frame length;
    its tail the jnp one where its fused tail refuses) at the family's
    gate, masks equal."""
    tcfg, jcfg = _configs(case)
    x, lens = _rows(jcfg, (3.0, 1.7), seed=len(case))
    feat, mask = tchain.extract_batch(x.astype(np.int16), lens, tcfg, device="cpu")
    jfeat, jmask = jchain.extract_batch(jnp.asarray(x), jnp.asarray(lens), jcfg, backend="pallas")
    F = feat.shape[1]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask)[:, :F])
    valid = mask.numpy() > 0
    _gate(case, tcfg, feat.numpy()[valid], np.asarray(jfeat)[:, :F][valid])


# the branches of the staging: (config, overrides), each at a hop where a
# 32-frame span still fits, so both mirrors apply
SAMPLE_CASES = {
    "signal_preemph": ("classic13_deltas", {}),
    "signal_preemph_dither": ("classic13", {"dither": 1.0}),
    "signal_no_preemph_dither": ("classic13", {"dither": 0.5, "preemph": 0.0}),
    "frame_mode_dither": ("kaldi_mfcc", {"dither": 1.0}),
    "frame_mode": ("kaldi_fbank", {}),
    "center_preemph_dither": ("classic13", {"frame_tail": "center", "dither": 1.0}),
    "center_reflect": ("whisper80", {}),
    "center_reflect_preemph": ("classic13", {"frame_tail": "center_reflect"}),
    "hop_over_frame": ("classic13_deltas", {"hop_s": 0.05}),
}
GATHER_LENGTHS = [0, 1, 399, 400, 401, 32 * 160 - 1, 32 * 160, 32 * 160 + 1, 11999, 12000]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_gather_samples_are_the_staged_spans(case, dtype):
    """Each frame sample of the gather plan (`_gather_samples`, csrc/
    frontend.cu staged_at), computed from the row alone, is bitwise the
    value the staged span holds at that position (`_stage_tile`: batched
    loads, the dither pass in place, chunked in-place pre-emphasis,
    reflection) over every tile of rows at the boundary lengths, in float32
    and float64; with origin 1 (the block launch) the pre-context sample as
    x[-1], zero and dirty."""
    name, over = SAMPLE_CASES[case]
    cfg = T_CONFIGS[name].replace(**over)
    T, S, L = 12000, cfg.frame_step, cfg.frame_length
    g = np.random.default_rng(len(case))
    x = (np.round(g.standard_normal((len(GATHER_LENGTHS), T)) * 3000) * cfg.input_scale).astype(dtype)
    noise = tdither.signal_noise(cfg.dither_seed, T, S).numpy().astype(dtype)
    F = cfg.num_frames(T)
    pres = [0.0] if cfg.dither > 0.0 or tchain.centered(cfg) else [0.0, 1234.0 * cfg.input_scale]
    for pre in pres:
        for b, n in enumerate(GATHER_LENGTHS):
            for f0 in range(0, F, TILE):
                nf = min(TILE, F - f0)
                pos = (np.arange(nf) * S)[:, None] + np.arange(L)
                want = _stage_tile(x[b], noise, n, f0, cfg, dtype, dtype(pre))[pos]
                got = _gather_samples(x[b], noise, n, f0 * S + pos, cfg, dtype, dtype(pre))
                assert got.dtype == want.dtype and np.array_equal(got, want), (case, n, f0, pre)


GATHER_EMULATED = {
    "hop_0.2": ("classic13_deltas", dict(hop_s=0.2), ("gather", 4)),
    "frames_1.6s_windowed_energy": ("kaldi_mfcc", dict(win_len_s=1.6, energy_source="windowed_frame"),
                                    ("gather", 4)),
    "frames_1.6s_raw_energy_dither": ("kaldi_fbank", dict(win_len_s=1.6, dither=1.0), ("gather", 2)),
    "whisper80_hop_0.2": ("whisper80", dict(hop_s=0.2), ("gather", 4)),
    "center_dither_hop_0.2": ("classic13", dict(frame_tail="center", dither=1.0, hop_s=0.2), ("gather", 1)),
    "bluestein_551_hop_0.2_global": ("classic13", dict(n_fft=551, hop_s=0.2), ("gather_global", 2)),
}


@pytest.mark.parametrize("case", sorted(GATHER_EMULATED))
def test_gather_plan_algebra_exact_in_float64(case):
    """The kernel's numpy mirror in a gather plan (its frames from
    `_gather_samples`, each stage by the group's thread ranks, the
    conditioning's sums over all L samples, those past n_fft included) ≡
    the plain version in float64 within 1e-9; each case's own plan is
    the gather plan, but the forced ones at 551 and the centered dither."""
    name, over, plan = GATHER_EMULATED[case]
    cfg = T_CONFIGS[name].replace(dtype="float64", **over)
    if plan == ("gather", 4) and case != "whisper80_hop_0.2":
        assert frontend.fft_layout(cfg)[0] == "gather"
    g = np.random.default_rng(len(case))
    T = 40000
    audio = np.round(g.standard_normal((3, T)) * 3000)
    lengths = np.array([T, 23457, 700])
    got = _emulate_kernel(audio, lengths, cfg, np.float64, plan)
    want = _reference(audio, lengths, cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def _parent_layout(cfg):
    """The first block-or-warp plan of the parent's search (the first seven
    of `FFT_LAYOUTS`: warp, then block and block_global at 4, 2 and 1
    groups) that fits the block, or None."""
    form = frontend.dft_form(cfg)
    for plan, groups in frontend.FFT_LAYOUTS[:7]:
        if frontend._fft_smem(cfg, form, plan, True, groups) <= frontend.rs_kernel.SMEM_BUDGET_BYTES:
            return plan, groups
    return None


def test_every_config_that_fits_today_keeps_its_plan():
    """The gather plans come after every plan the parent tried, in that
    order, so every config the parent's layouts fit keeps its plan (and its
    kernel's bits): the named configs and their variants at n_fft from 256
    to 6,001, hops of 5 to 40 ms and frames of 20 to 64 ms; the others take
    a gather plan (the last two, with the packed bands and then the FFT rows
    in device memory, after the first two) and are no longer refused."""
    assert frontend.FFT_LAYOUTS[:7] == (
        ("warp", 8), ("block", 4), ("block", 2), ("block", 1),
        ("block_global", 4), ("block_global", 2), ("block_global", 1))
    assert [p for p, _ in frontend.FFT_LAYOUTS[7:]] == (
        ["gather"] * 3 + ["gather_global"] * 3 + ["cluster"] * 3 + ["gather_bands"] * 3 + ["gather_rows"] * 3
        + ["gather_sums"] * 3)
    kept = moved = 0
    for name in sorted(T_CONFIGS):
        base = frontend.feature_rate_config(T_CONFIGS[name])
        for n_fft in (256, 400, 512, 1102, 2048, 2501, 4096, 5392, 5393, 6001):
            for hop in (0.005, 0.01, 0.02, 0.04):
                for win in (0.02, 0.025, 0.064):
                    spec = dict(n_mels=n_fft // 2 + 1) if base.features == "spectrogram" else {}
                    cfg = base.replace(n_fft=n_fft, hop_s=hop, win_len_s=win, **spec)
                    parent = _parent_layout(cfg)
                    if parent is not None:
                        assert frontend.fft_layout(cfg) == parent, (name, n_fft, hop, win)
                        kept += 1
                    else:
                        plan = frontend.fft_layout(cfg, cluster=False)[0]
                        assert plan.startswith("gather"), (name, n_fft, hop, win)
                        assert frontend.fft_plan(cfg) in (plan, "cluster"), (name, n_fft, hop, win)
                        moved += 1
    assert kept > 1000 and moved > 0


def test_layouts_of_the_gather_plan():
    """The gather plan's layout (csrc/frontend.cu layout with p.gather) is
    the packed bands, the tables where staged, and per group two rows and
    the projection's scratch, then the 8 warps' partials: at classic13_deltas
    28,736 B whatever the hop or the frame (0.2 s, 1 s, 3 s), where the block
    plan staged 31·S + L and max(L, n_fft) floats (the parent refused from a
    hop of 0.125 s: 261,248 B); librosa's 8,192-point frames at hop 2,048 one
    group with its tables staged, 230,432 B; n_fft 6,001 (Bluestein, P =
    10,240) one group, its tables in device memory, 230,912 B."""
    c = T_CONFIGS["classic13_deltas"]
    for over in (dict(hop_s=0.2), dict(hop_s=1.0), dict(win_len_s=3.0), dict(hop_s=0.125)):
        cfg = c.replace(**over)
        assert (*frontend.fft_layout(cfg), frontend.smem_bytes(cfg)) == ("gather", 4, 28736), over
        assert frontend.smem_bytes(cfg, int16=False) == 28736
    assert frontend._fft_smem(c.replace(hop_s=0.125), "stockham", "block_global", True, 1) == 261248
    lib = T_CONFIGS["logmel80"].replace(**LIBROSA_8192)
    assert (*frontend.fft_layout(lib), frontend.smem_bytes(lib)) == ("gather", 1, 230432)
    n6001 = c.replace(n_fft=6001)
    assert frontend.bluestein_dims(6001)[2] == 10240
    assert (*frontend.fft_layout(n6001), frontend.smem_bytes(n6001)) == ("gather_global", 1, 230912)
    # the bands, the rows and the 8 partials of one group, and nothing of the hop
    rows = 2 * frontend.row_floats(6001, "bluestein")
    scratch = (frontend.mel_matrices(n6001) * (frontend.THREADS + n6001.n_mels) + 3) & ~3
    assert 4 * (frontend._bands(n6001) + rows + scratch + frontend.WARPS) == 230912


@pytest.mark.parametrize("over,plan", [
    (dict(n_fft=6001), "gather_global"), (dict(n_fft=6204), "block_global"), (dict(n_fft=6205), "gather_bands"),
    (dict(n_fft=7001), "gather_bands"), (dict(n_fft=12500), "gather_global"), (dict(n_fft=12502), "gather_bands"),
    (dict(n_fft=16384), "gather_bands"), (dict(n_fft=6001, hop_s=1.0, win_len_s=3.0), "gather_global"),
    (dict(n_fft=7001, hop_s=0.001), "gather_bands"),
], ids=["6001", "6204", "6205", "7001", "12500", "12502", "16384", "6001_long_span", "7001_short_hop"])
def test_refusal_map_names_rows_and_bands(over, plan):
    """What the parent refused was an n_fft whose two FFT rows and packed
    mel bands were over the block in its last plan, whatever the hop and the
    frame: 6,205 and 7,001 (Bluestein, P = 10,240 and 12,288), 12,502 and
    16,384 (its bands). Each now takes "gather_bands", the bands read from
    device memory, at any hop (16,384, a Stockham FFT of 8,192 points, takes
    the cluster plan before it); what the parent took keeps its plan;
    nothing is refused, and the formerly refused sizes' CPU chain ≡ the JAX
    jnp chain at the cepstra gate (one row of 1.0 s)."""
    cfg = T_CONFIGS["classic13_deltas"].replace(**over)
    assert tchain.unsupported_reason(cfg) is None
    assert frontend.fft_layout(cfg, cluster=False)[0] == plan
    assert frontend.fft_plan(cfg) == ("cluster" if cfg.n_fft == 16384 else plan)
    if plan == "gather_bands":
        jcfg = J_CONFIGS["classic13_deltas"].replace(**over)
        x, lens = _rows(jcfg, (1.0,), seed=cfg.n_fft)
        feat, mask = tchain.extract_batch(x.astype(np.int16), lens, cfg, device="cpu")
        jfeat, jmask = jchain.extract_batch(jnp.asarray(x), jnp.asarray(lens), jcfg, backend="jnp")
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        _assert_close(cfg, feat.numpy(), np.asarray(jfeat))


@pytest.mark.parametrize("name,over,top", [
    ("classic13", {}, 6204), ("kaldi_mfcc", {"dither": 1.0}, 6238), ("logmel80", {}, 6312),
    ("whisper80", {}, 5924),
], ids=["classic13", "kaldi_mfcc_dither", "logmel80", "whisper80"])
def test_refusal_map_edges(name, over, top):
    """The top of each family's contiguous n_fft range in the parent's plans
    at any hop (a 10 ms hop and 0.5 s) keeps the parent's plan; the next size,
    which the parent refused, takes a plan past it (the cluster plan, or
    without it "gather_bands" or "gather_rows"); at classic13 every
    Stockham size to 13,824 keeps "gather_global" and 14,400, refused
    before, takes "gather_bands" (`PERF.md` §1, `ROADMAP.md` queue 2 item
    4). None is refused."""
    cfg = T_CONFIGS[name].replace(**over)
    for hop in (cfg.hop_s, 0.5):
        assert frontend.fft_layout(cfg.replace(n_fft=top, hop_s=hop)) in frontend.FFT_LAYOUTS[:13]
        nxt = cfg.replace(n_fft=top + 1, hop_s=hop)
        assert frontend.fft_layout(nxt, cluster=False)[0] in ("gather_bands", "gather_rows")
        assert frontend.fft_plan(nxt) in ("cluster", "gather_bands", "gather_rows")
        assert frontend.layout_reason(cfg.replace(n_fft=top + 1, hop_s=hop)) is None
    if name == "classic13":
        stockham = [n for n in range(top + 2, 14401, 2) if frontend.radices(n) is not None]
        kept = [n for n in stockham if frontend.fft_plan(cfg.replace(n_fft=n)) == "gather_global"]
        assert max(kept) == 13824 and frontend.fft_plan(cfg.replace(n_fft=14400)) == "gather_bands"


def test_bf16x3_form_still_stages_the_span():
    """The bf16x3 form (an opt-in route) stages the span in its first plan
    ("staged"): at classic13 to n_fft 2,244, hops of 1,213 samples and
    frames of 16,788 samples, as before. One past each edge, and at n_fft
    8192 and a hop of 0.2 s, which the default form takes, it takes its
    block plans (`frontend.bf16_layout`: the tile's A built once from
    device memory, in shared memory or the workspace) instead of being
    refused."""
    c = T_CONFIGS["classic13"]
    for over in (dict(n_fft=8192), dict(hop_s=0.2)):
        cfg = c.replace(**over)
        assert frontend.layout_reason(cfg) is None
        assert frontend.layout_reason(cfg, "bf16x3") is None
        assert frontend.bf16_layout(cfg)[0] in ("pass", "gather")
    for key, edge in (("n_fft", 2244), ("hop_s", 1213 / 16000), ("win_len_s", 16788 / 16000)):
        step = 1 if key == "n_fft" else 1 / 16000
        assert frontend.layout_reason(c.replace(**{key: edge}), "bf16x3") is None, key
        assert frontend.bf16_layout(c.replace(**{key: edge}))[0] == "staged", key
        assert frontend.layout_reason(c.replace(**{key: edge + step}), "bf16x3") is None, key
        assert frontend.bf16_layout(c.replace(**{key: edge + step}))[0] in ("pass", "gather"), key


@pytest.mark.parametrize("case", ["classic13_deltas_hop_0.2", "librosa_8192_hop_2048"])
def test_wrapper_on_cpu_launches_nothing(case):
    """On CPU tensors the wrapper in the gather plan is its plain version,
    with no launch counted."""
    tcfg, jcfg = _configs(case)
    x, lens = _rows(jcfg, (1.0, 0.4), seed=3)
    before = (frontend.launches, frontend.block_fft_launches, frontend.gather_launches)
    got = frontend.logmel_prefix(torch.as_tensor(x), torch.as_tensor(lens), tcfg)
    assert (frontend.launches, frontend.block_fft_launches, frontend.gather_launches) == before
    np.testing.assert_array_equal(
        got.numpy(), frontend.logmel_prefix_reference(torch.as_tensor(x), torch.as_tensor(lens), tcfg).numpy())


@pytest.mark.parametrize("K", [4, 16])
def test_stream_at_a_long_hop_matches_the_offline_chain(K):
    """A stream at a 0.2 s hop (the block launch in the gather plan on the
    card; here its plain version) in ragged chunks ≡ the offline chain at
    the cepstra gate, frame counts equal. A block advances K·S samples, more
    than its window of (K - 1)·S + L + 1 holds when the hop is longer than a
    frame: the port drops the rest as they arrive. The reference's
    StreamingExtractor drops only what it has on hand and loses the stream's
    alignment (`mfcc_tpu/pipeline/streaming.py` prepare/advance): its
    features at this hop are off by tens, so it is not the yardstick here."""
    from mfcc_tpu.pipeline import streaming as jstreaming

    cfg = T_CONFIGS["classic13_deltas"].replace(hop_s=0.2)
    assert frontend.fft_plan(cfg) == "gather"
    g = np.random.default_rng(K)
    x = np.round(g.standard_normal(16000 * 9 + 777) * 3000).astype(np.float32)
    sizes, left = [], len(x)
    while left > 0:
        sizes.append(int(min(left, g.integers(1, 9000))))
        left -= sizes[-1]
    outs = []
    for ex in (StreamingExtractor(cfg, frames_per_block=K, device="cpu"),
               jstreaming.StreamingExtractor(J_CONFIGS["classic13_deltas"].replace(hop_s=0.2),
                                             frames_per_block=K)):
        parts, pos = [], 0
        for c in sizes:
            parts.append(ex.push(x[pos : pos + c]))
            pos += c
        parts.append(ex.flush())
        outs.append(np.concatenate(parts, axis=0))
    got, theirs = outs
    want = tchain.extract_single(torch.as_tensor(x), cfg, device="cpu").numpy()
    assert got.shape == want.shape == theirs.shape and got.shape[0] > 2 * K
    _assert_close(cfg, got, want)
    assert np.abs(theirs - want).max() > 1.0


@pytest.mark.parametrize("name,over", [
    ("classic13_deltas", {}), ("classic13_deltas", dict(hop_s=0.2)), ("whisper80", dict(hop_s=0.2)),
    ("kaldi_mfcc", dict(hop_s=0.25)), ("kaldi_mfcc", dict(frame_tail="center", hop_s=0.2)),
    ("classic13_deltas", dict(win_len_s=3.0)),
], ids=["hop_10ms", "hop_0.2", "centered_hop_0.2", "kaldi_hop_0.25", "kaldi_center_hop_0.2", "frames_3s"])
def test_bound_counts_the_samples_the_frames_read(name, over):
    """chip_smoke.py's bound counts the input samples the front-end's frames
    read (`framed_mask`): the chain's own frame indices (reflected under
    centered framing, frames from before the row's length otherwise) and,
    under signal pre-emphasis, each sample's x[t-1]. At a hop over the frame
    length that is a fraction of the row (1/8 at a 0.2 s hop of 400-sample
    frames); at a 10 ms hop, every sample up to the last frame's end. Where
    the config resamples, `input_read` counts the FIR's inputs of those
    outputs (ops/resample.py: x[q - K + 1 .. q], q = (j·down + half_len) //
    up)."""
    import chip_smoke
    from mfcc_tpu_torch.ops import resample as R

    cfg = T_CONFIGS[name].replace(**over)
    L, S = cfg.frame_length, cfg.frame_step
    pre = cfg.preemph_mode == "signal" and cfg.preemph != 0.0
    F = cfg.num_frames(48000)
    for n in (1, 401, 7777, 48000):
        want = np.zeros(n, bool)
        t = torch.arange(L)[None, :] + S * torch.arange(F)[:, None] + tchain.frame_offset(cfg)
        if tchain.centered(cfg):
            r = tchain.reflect_index(t, torch.tensor(n), cfg.frame_tail).numpy().ravel()
        else:
            t = t[t[:, 0] < n]
            r = t[t < n].numpy()
        want[r] = True
        if pre:
            want[np.maximum(r - 1, 0)] = True
        got = chip_smoke.framed_mask(cfg, n, F)
        np.testing.assert_array_equal(got, want)
        assert chip_smoke.input_read(cfg, n, F) == int(want.sum())
    if S > L:
        assert chip_smoke.framed_mask(cfg, 48000, F).sum() < 48000 * L / S * 1.01 + L
    rcfg = cfg.replace(input_sample_rate=48000)
    d = R.polyphase_design(*R.ratio(48000, cfg.sample_rate))
    n_in = 48000 * 2 - 1713
    out = chip_smoke.framed_mask(rcfg, R.output_length(n_in, 48000, cfg.sample_rate), F)
    want = np.zeros(n_in, bool)
    for j in np.nonzero(out)[0]:
        q = (j * d["down"] + d["half_len"]) // d["up"]
        want[max(q - d["K"] + 1, 0) : min(q + 1, n_in)] = True
    assert chip_smoke.input_read(rcfg, n_in, F) == int(want.sum())
