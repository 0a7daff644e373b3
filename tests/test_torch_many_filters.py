"""Every filter count the reference takes: the packed mel table without a
filter field, and the projection's sums in device memory where the block
cannot hold them.

The front-end's packed table (`kernels/frontend.py::packed_meta`) held each
weight's bin and filter in one word, so 32,768 filters and more (16,384 at
n_fft 131,072) were refused on both devices; and the last plan
("gather_rows") staged the projection's M filter sums, over the block from
57,849 filters (28,797 for SSC). The table now holds the bin alone (the sign
bit on a filter's last weight): each thread of the projection finds the
filter its chunk starts in by a binary search of the offsets
(csrc/frontend.cu filter_of) and counts the filters' ends from there, the
sums in their old order. A plan past "gather_rows", "gather_sums", keeps the
filter sums in the output row and SSC's melf sums in the workspace; the wide
plan (tests/test_torch_wide.py) replaces it, and "gather_bands" at tens of
thousands of filters, where it fits. Here, on the CPU:
- the port's `extract_batch(device="cpu")` against the JAX jnp chain and
  the float64 plain chain at tens of thousands of filters (`CASES`), each
  at its family's gate of the float64 chain. Where the JAX package is
  itself within that gate of float64 the port is held to it at the fp32
  gate; where it is not (its DCT over tens of thousands of lanes sums in
  fp32: the mfcc cases, `ROADMAP.md` queue 3), the port is held no further
  from float64 than the JAX package;
- the table against a numpy loop (each weight's bin and last flag, every
  bin to 2^31 - 1, the filter each chunk starts in for the warp's and each
  group size's chunk);
- a numpy mirror of the kernel's projection with the new table, bitwise the
  old order's mirror and within 1e-12 of the dense product, every sum
  stored once and in bounds where a chunk holds hundreds of filter ends;
- the plan ladder: "gather_sums" after "gather_rows" (csrc/frontend.cu
  kLadder parsed), where it is first taken without the wide plan, its
  layout constant in M, its workspace; nothing refused at any of these
  counts, the bf16x3 opt-in's plan at each;
- the CLI, a stream and the server at 60,000 filters on the CPU.
tests/test_torch_gpu.py and chip_smoke.py (phase 31) hold the kernel's new
plan to its plain version on a card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend, tail
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.pipeline import StreamingExtractor
from tests.test_torch_frontend import _project

CSRC = pathlib.Path(__file__).resolve().parents[1] / "mfcc_tpu_torch" / "kernels" / "csrc" / "frontend.cu"
BUDGET = frontend.rs_kernel.SMEM_BUDGET_BYTES
# (config, overrides, whether the JAX jnp chain is itself within the
# family's gate of the float64 chain on these rows)
CASES = {
    "classic13_deltas_40000": ("classic13_deltas", dict(n_mels=40000), False),
    "classic13_deltas_60000": ("classic13_deltas", dict(n_mels=60000), False),
    "classic13_deltas_33000_8192": ("classic13_deltas", dict(n_mels=33000, n_fft=8192), False),
    "logmel80_33000": ("logmel80", dict(n_mels=33000), True),
    "kaldi_mfcc_33000": ("kaldi_mfcc", dict(n_mels=33000), False),
    "kaldi_plp_33000": ("kaldi_plp", dict(n_mels=33000), True),
    "ssc26_30000_4096": ("ssc26", dict(n_mels=30000, n_fft=4096), True),
}


def _rows(seed: int):
    """Two int16 rows of 1.0 and 0.55 s at 16 kHz (zero past each length),
    and their lengths."""
    g = np.random.default_rng(seed)
    lens = np.array([16000, 8800], np.int32)
    x = np.round(g.standard_normal((2, 16000)) * 3000).astype(np.int16)
    x[np.arange(16000)[None, :] >= lens[:, None]] = 0
    return x, lens


def _errors(got, want, cfg, against: str) -> tuple[float, list[str]]:
    """(max |got - want| where want is finite, the family's gate failures)
    of features against a reference: "float64" the float64 plain chain,
    "fp32" another fp32 chain. NaN must fall where the reference has it
    (an SSC filter with no weight is 0/0 in every chain)."""
    g, w = testing._f64(got), testing._f64(want)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    fin = np.isfinite(w)
    g, w = np.where(fin, g, 0.0), np.where(fin, w, 0.0)
    err = float(np.abs(g - w).max())
    if cfg.features == "logmel":
        return err, testing.logmel_failures(testing.logmel_errors(g, w, cfg.log_kind))
    if cfg.features in testing.FAMILY_GATES:
        return err, testing.family_feature_failures(
            testing.family_feature_errors(g, w, cfg.features, against), cfg.features, against)
    atol = testing.FEATURE_ATOL  # Kaldi's cepstra gate (KALDI_MFCC_ATOL) is the same 5e-4
    excess = float((np.abs(g - w) - testing.FEATURE_RTOL * np.abs(w)).max())
    return err, [] if excess <= atol else [f"max(|diff| - {testing.FEATURE_RTOL}|want|) {excess:.3e} > {atol}"]


@pytest.mark.parametrize("case", list(CASES))
def test_chain_at_many_filters(case):
    """The port takes the config on both devices (nothing refused, the card
    in a plan of its block ladder); its CPU chain on seeded int16 rows is
    within the family's gate of the float64 plain chain (mfcc: 5e-4 +
    1e-5·|f|, Kaldi's cepstra too; log-mel the two-regime 1e-4 loud / 1e-5
    linear gate; PLP 5e-4 + 1e-4·|f|; SSC 2e-2 + 2e-5·|f|), masks equal to
    the JAX package's; where the JAX jnp chain is within that gate too, the
    port is within the fp32 gate of it, and where it is not (the mfcc
    cases), the port is no further from float64 than it."""
    name, over, reference_within = CASES[case]
    tcfg, jcfg = T_CONFIGS[name].replace(**over), J_CONFIGS[name].replace(**over)
    assert tchain.unsupported_reason(tcfg) is None and frontend.layout_reason(tcfg) is None
    assert frontend.layout_reason(tcfg, "bf16x3") is None
    assert frontend.fft_plan(tcfg) == "wide"
    assert frontend.fft_layout(tcfg, wide=False)[0] in ("gather_bands", "gather_rows", "gather_sums")
    x, lens = _rows(len(case))
    feat, mask = tchain.extract_batch(x, lens, tcfg, device="cpu")
    f64, mask64 = tchain.extract_batch(x, lens, tcfg.replace(dtype="float64"), device="cpu")
    jfeat, jmask = jchain.extract_batch(jnp.asarray(x.astype(np.float32)), jnp.asarray(lens), jcfg,
                                        backend="jnp")
    jfeat = np.asarray(jfeat)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(mask.numpy(), mask64.numpy())
    assert feat.shape == f64.shape == jfeat.shape
    err, fails = _errors(feat, f64, tcfg, "float64")
    assert not fails, (case, err, fails)
    jerr, jfails = _errors(jfeat, f64, tcfg, "float64")
    assert (not jfails) == reference_within, (case, jerr, jfails)
    if reference_within:
        _, fails = _errors(feat, jfeat, tcfg, "fp32")
        assert not fails, (case, fails)
    else:
        assert err <= jerr, (case, err, jerr)


def test_fp32_cepstra_at_40000_filters_over_the_gate_on_a_quiet_bin():
    """A recorded fault of both packages' fp32 chains (ROADMAP.md queue 3
    item 5), pinned: classic13_deltas at 40,000 filters on frames 546-561
    of the row chip_smoke.py phase 31 holds apart (seed 1620): one quiet
    bin's fp32 power reads ~3e-2 off in log, ~155 filters of one weight
    share it, the DCT sums them and the lifter scales cepstrum 10 by ~12, so
    the port's CPU fp32 cepstra sit ~1.9e-3 over 1e-5 |f| from the float64
    chain, over the 5e-4 gate. The cause is the prefix: the float64 tail on
    the fp32 prefix reads the same. The JAX jnp chain is no nearer float64.
    A fix that brings the port within the gate turns the first assertion
    round and closes the item."""
    tcfg = T_CONFIGS["classic13_deltas"].replace(n_mels=40000)
    jcfg = J_CONFIGS["classic13_deltas"].replace(n_mels=40000)
    row = (np.random.default_rng(1620).standard_normal(160000) * 3000).astype(np.int16)
    f0, frames = 546, 16  # the frames around the fault's (554 of the row), whole deltas windows
    x = row[f0 * tcfg.frame_step:(f0 + frames - 1) * tcfg.frame_step + tcfg.frame_length][None]
    lens = np.array([x.shape[1]], np.int32)
    feat, _ = tchain.extract_batch(x, lens, tcfg, device="cpu")
    f64, _ = tchain.extract_batch(x, lens, tcfg.replace(dtype="float64"), device="cpu")
    jfeat, _ = jchain.extract_batch(jnp.asarray(x.astype(np.float32)), jnp.asarray(lens), jcfg, backend="jnp")
    assert feat.shape == f64.shape == (1, frames, tcfg.feat_dim)

    def excess(got):
        d = np.abs(np.asarray(got, np.float64) - f64.numpy())
        return float((d - testing.FEATURE_RTOL * np.abs(f64.numpy())).max())

    err = excess(feat)
    assert 1.5e-3 < err < 2.5e-3, err  # the fault, at the size it was recorded
    prefix, nv, _ = frontend.logmel_prefix_counts(torch.as_tensor(x), torch.as_tensor(lens), tcfg)
    mixed = tail.feature_tail_reference(prefix.double(), nv, tcfg.replace(dtype="float64"))
    assert abs(excess(mixed) - err) < 1e-5, (excess(mixed), err)
    assert err <= excess(np.asarray(jfeat)), (err, excess(np.asarray(jfeat)))


def _filter_of(off, i: int) -> int:
    """csrc/frontend.cu filter_of: the last m with off[m] <= i, by the
    kernel's binary search of off[0 .. M]."""
    lo, hi = 0, len(off) - 1
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if off[mid] <= i:
            lo = mid
        else:
            hi = mid
    return lo


def _table(cfg):
    mel = tchain.device_constants(cfg, torch.device("cpu"), torch.float32)["mel"]
    off, index = frontend.mel_packed(mel)
    return mel, off.numpy().astype(np.int64), index.numpy(), frontend.packed_meta(off, index, mel.shape[1])


@pytest.mark.parametrize("case", ["classic13", "classic13_deltas_40000", "classic13_deltas_60000",
                                  "ssc26_30000_4096"])
def test_packed_table_and_chunk_filters_mirror(case):
    """The packed table against a numpy loop: each weight's word is its bin
    (index // M), negative exactly at each filter's last weight, and names
    no filter; the filter each chunk starts in (`filter_of` at lane ·
    chunk, for the warp's 32 lanes and the block plans' 64, 128 and 256)
    is the one whose weights hold it. A table at 65,537 bins and 16,385
    filters (n_fft 131,072, past the old 14-bit filter field) and one whose
    bins reach 2^31 - 1 keep every bin."""
    cfg = T_CONFIGS["classic13"] if case == "classic13" else T_CONFIGS[CASES[case][0]].replace(**CASES[case][1])
    mel, off, index, meta = _table(cfg)
    M = mel.shape[1]
    meta = meta.numpy().astype(np.int64)
    owner = np.empty(index.size, np.int64)
    last = np.zeros(index.size, bool)
    for m in range(M):  # the loop
        owner[off[m]:off[m + 1]] = m
        last[off[m + 1] - 1] = True
    np.testing.assert_array_equal(meta & 0x7FFFFFFF, index // M)
    np.testing.assert_array_equal(meta < 0, last)
    for lanes in (32, 64, 128, 256):
        c = frontend.chunk(index.size, lanes)
        for lane in range(lanes):
            if lane * c < index.size:
                assert _filter_of(off, lane * c) == owner[lane * c], (lanes, lane)
    # synthetic tables: 16,385 filters over 65,537 bins, and bins to 2^31 - 1
    g = np.random.default_rng(131072)
    for bins, M in ((65537, 16385), (2**31, 5)):
        lo = np.sort(g.integers(0, bins - 64, M))
        width = g.integers(1, 64, M)
        off = np.concatenate([[0], np.cumsum(width)])
        k = np.concatenate([lo[m] + np.arange(width[m]) for m in range(M)])
        k[-1] = bins - 1
        index = k * M + np.repeat(np.arange(M), width)
        meta = frontend.packed_meta(torch.as_tensor(off, dtype=torch.int32), torch.as_tensor(index), M)
        meta = meta.numpy().astype(np.int64)
        np.testing.assert_array_equal(meta & 0x7FFFFFFF, k)
        np.testing.assert_array_equal(np.flatnonzero(meta < 0), off[1:] - 1)
        assert int((meta & 0x7FFFFFFF).max()) == bins - 1
        c = frontend.chunk(int(off[-1]), 256)
        for first in range(0, int(off[-1]), c):
            m = _filter_of(off, first)
            assert off[m] <= first < off[m + 1]


def _write_frame_sums(P, w, meta, off, lanes: int):
    """csrc/frontend.cu write_frame's projection with the new table, in
    numpy, on power rows P [nf, bins]: lane l sums weights [l c, l c + c)
    from filter m0 = filter_of(l c), one filter on at each negative word;
    the filter m0, where it began in an earlier lane from = off[m0] // c
    (both found once a tile), is held and finished as part[from] + ... +
    part[l-1] + its own sum. Returns the sums [nf, M] and the count of
    stores to each filter's sum (each must be 1)."""
    nnz, M, nf = int(off[-1]), len(off) - 1, P.shape[0]
    c = frontend.chunk(nnz, lanes)
    sums = np.full((nf, M), np.nan, P.dtype)
    stores = np.zeros(M, np.int64)
    part, held = {}, {}
    for lane in range(lanes):
        i0, i1 = lane * c, min(lane * c + c, nnz)
        m0 = _filter_of(off, i0) if i0 < nnz else 0
        frm = off[m0] // c if i0 < nnz and off[m0] < i0 else -1
        head = frm >= 0
        filt, acc = m0, np.zeros(nf, P.dtype)
        for i in range(i0, i1):
            e = int(meta[i])
            acc = acc + P[:, e & 0x7FFFFFFF] * w[i]
            if e < 0:
                assert 0 <= filt < M
                if head:
                    held[lane], head = (filt, frm, acc), False
                else:
                    sums[:, filt] = acc
                    stores[filt] += 1
                acc = np.zeros(nf, P.dtype)
                filt += 1
        part[lane] = acc
    for lane, (m, frm, h) in held.items():
        assert m == _filter_of(off, lane * c) and frm * c <= off[m] < (frm + 1) * c <= lane * c
        s = part[frm]
        for lane_ in range(frm + 1, lane):
            s = s + part[lane_]
        sums[:, m] = s + h
        stores[m] += 1
    return sums, stores


@pytest.mark.parametrize("case,lanes", [("classic13", 32), ("classic13", 256), ("classic13_deltas_40000", 32),
                                        ("classic13_deltas_40000", 256), ("ssc26_30000_4096", 64)])
def test_projection_mirror_keeps_the_sums_order(case, lanes):
    """The kernel's projection with the new table (`_write_frame_sums`):
    bitwise the mirror of the old order (tests/test_torch_frontend.py
    `_project`, which found each weight's filter from its word) in float32,
    within 1e-12 of the dense product in float64, every filter's sum stored
    exactly once and in bounds, also where a chunk holds hundreds of filter
    ends (40,000 filters: 1,251 a lane of a warp, 157 a thread of a group)."""
    cfg = T_CONFIGS["classic13"] if case == "classic13" else T_CONFIGS[CASES[case][0]].replace(**CASES[case][1])
    mel, off, index, meta = _table(cfg)
    M = mel.shape[1]
    w = mel.numpy().reshape(-1)[index]
    kbin = index // M
    meta = meta.numpy()
    P = np.random.default_rng(lanes).exponential(size=(3, mel.shape[0]))
    for dtype in (np.float32, np.float64):
        Pd, wd = P.astype(dtype), w.astype(dtype)
        got, stores = _write_frame_sums(Pd, wd, meta, off, lanes)
        assert (stores == 1).all()
        want, _ = _project(Pd, wd, wd, off, kbin, 0.0, False, lanes)
        np.testing.assert_array_equal(got, want)
    dense = P @ mel.numpy().astype(np.float64)
    np.testing.assert_allclose(got, dense, rtol=1e-12, atol=1e-12 * np.abs(dense).max())
    ends = np.diff(np.searchsorted(off[1:] - 1, np.arange(0, off[-1] + 1, frontend.chunk(int(off[-1]), lanes))))
    assert ends.max() >= (100 if case != "classic13" else 1)


def test_gather_sums_ends_the_ladder():
    """"gather_sums" is the last plan of the block ladder (`FFT_PLANS`,
    `PLAN_TRAITS`, and the kernel's kLadder parsed from csrc/frontend.cu,
    plan_block walking all seven, every plan but the cluster plan and the
    wide plan, which a launch asks for by its cluster size and its tile):
    tried after "gather_rows" at 4, 2 and 1 groups, so every layout the
    parent's plans fit keeps its plan; without the wide plan it is first
    taken at 57,849 filters (28,797 for SSC), where "gather_rows" at one
    group is over the block by the projection's sums, and with it the wide
    plan takes those counts (and "gather_rows"' above WIDE_MIN_FILTERS); its
    layout, the thread partials and the warps' partials, is 1,056 B (2,080 B
    for SSC) at any group count and filter count; its workspace adds a slot
    of groups x M melf sums for SSC alone; it stays past the wide plan's
    layouts (n_fft 32,768 at 60,000 filters)."""
    assert frontend.FFT_PLANS[-2:] == ("gather_rows", "gather_sums")
    assert [p for p, _ in frontend.FFT_LAYOUTS[22:]] == ["gather_sums"] * 3
    src = CSRC.read_text()
    rows = re.search(r"constexpr int kLadder\[7\]\[5\] = \{(.*?)\};", src, re.S).group(1)
    ladder = [tuple(bool(int(v)) for v in r.split(",")) for r in re.findall(r"\{([01, ]+)\}", rows)]
    assert ladder == [frontend.PLAN_TRAITS[p] for p in frontend.BLOCK_LADDER]
    assert frontend.BLOCK_LADDER == tuple(p for p in frontend.FFT_PLANS[1:] if p not in ("cluster", "wide"))
    assert "for (int plan = 0; plan < 7; ++plan)" in src
    c, s = T_CONFIGS["classic13_deltas"], T_CONFIGS["ssc26"]
    edges = {(c, 57848): ("gather_rows", 1, BUDGET), (c, 57849): ("gather_sums", 4, 1056),
             (s, 28796): ("gather_rows", 1, BUDGET), (s, 28797): ("gather_sums", 4, 2080)}
    for (base, M), want in edges.items():
        cfg = base.replace(n_mels=M)
        layout = frontend.fft_layout(cfg, wide=False)
        assert (*layout, frontend._fft_smem(cfg, frontend.dft_form(cfg), *layout)) == want, (base.name, M)
        assert frontend.fft_layout(cfg) == ("wide", frontend.wide_layout(cfg)[1]), (base.name, M)
        assert frontend.layout_reason(cfg) is None
    far = c.replace(n_mels=60000, n_fft=32768)
    assert frontend.wide_layout(far) is None and frontend.fft_layout(far) == ("gather_sums", 4)
    for base, nbytes in ((c, 1056), (s, 2080)):
        for M in (26, 30000, 60000):
            cfg = base.replace(n_mels=M)
            form = frontend.dft_form(cfg)
            assert {frontend._fft_smem(cfg, form, "gather_sums", True, g) for g in (4, 2, 1)} == {nbytes}
    parent = [layout for layout in frontend.FFT_LAYOUTS[:-3] if layout[0] != "cluster"]
    for cfg in (c, s, c.replace(n_fft=32768), c.replace(n_mels=40000), s.replace(n_mels=20000, n_fft=4096)):
        form = frontend.dft_form(cfg)
        first = next((p, g) for p, g in parent if frontend._fft_smem(cfg, form, p, True, g) <= BUDGET)
        assert frontend.fft_layout(cfg, cluster=False, wide=False) == first, cfg
        # the cluster plan takes the FFT of 16,384 points ahead of "gather_rows",
        # the wide plan 20,000 and 40,000 filters ahead of "gather_bands"
        want = (("cluster", 2) if cfg.n_fft == 32768 else ("wide", frontend.wide_layout(cfg)[1])
                if cfg.n_mels >= frontend.WIDE_MIN_FILTERS else first)
        assert frontend.fft_layout(cfg) == want, cfg
    big = s.replace(n_mels=30000, n_fft=4096)
    assert frontend.fft_layout(big, wide=False) == ("gather_sums", 4) and frontend.fft_layout(big) == ("wide", 10)
    row = frontend.row_floats(4096, "stockham")
    assert frontend.rows_workspace(big, "stockham", 10, 264) == (10, 10 * 4 * (2 * row + 30000))
    mf = c.replace(n_mels=60000)
    assert frontend.rows_workspace(mf, "stockham", 10**6, 264) == (264, 264 * 4 * 2 * frontend.row_floats(512, "stockham"))


@pytest.mark.parametrize("name", ["classic13_deltas", "logmel80", "kaldi_plp", "ssc26"])
def test_nothing_refused_and_the_bf16x3_plan_at_many_filters(name):
    """At 40,000 and 60,000 filters nothing is refused on the default route
    or the bf16x3 opt-in (`layout_reason`, `chain.unsupported_reason`): the
    default route takes the wide plan at both, where without it it took
    "gather_bands" at 40,000 (its packed bands in device memory, the sums
    staged) for the one-table families and "gather_sums" at 60,000 (SSC,
    two tables, at both); bf16x3 takes "gather_out" (its accumulators in
    the workspace) at both, whose layout holds the ring and one pass's rows
    alone."""
    for M in (40000, 60000):
        cfg = T_CONFIGS[name].replace(n_mels=M)
        assert tchain.unsupported_reason(cfg) is None and frontend.layout_reason(cfg) is None
        assert frontend.layout_reason(cfg, "bf16x3") is None
        plan = "gather_sums" if M == 60000 or name == "ssc26" else "gather_bands"
        assert frontend.fft_plan(cfg) == "wide" and frontend.fft_layout(cfg, wide=False)[0] == plan, (name, M)
        assert frontend.bf16_layout(cfg)[0] == "gather_out", (name, M)
        assert frontend.smem_bytes(cfg, "bf16x3", False) <= BUDGET


def test_stream_and_serve_at_60000_filters(tmp_path, monkeypatch, capsys):
    """classic13 at 60,000 filters, refused before on both devices: a stream
    in ragged pushes ≡ the offline CPU chain, and `cli serve --device cpu`
    answers a session, its frames those of the stream."""
    import base64
    import importlib
    import io
    import json

    tcli = importlib.import_module("mfcc_tpu_torch.cli.main")
    cfg = T_CONFIGS["classic13"].replace(n_mels=60000)
    x = np.round(np.random.default_rng(60000).standard_normal(9000) * 3000).astype(np.float32)
    ex = StreamingExtractor(cfg, frames_per_block=8, device="cpu")
    got = np.concatenate([ex.push(x[:4100]), ex.push(x[4100:]), ex.flush()], axis=0)
    want = tchain.extract_single(torch.as_tensor(x), cfg, device="cpu").numpy()
    assert got.shape == want.shape
    testing.assert_features_close(got, want)
    pcm16 = base64.b64encode(x.astype("<i2").tobytes()).decode()
    lines = [json.dumps({"op": "open"}), json.dumps({"op": "push", "sid": 0, "pcm16": pcm16}),
             json.dumps({"op": "end", "sid": 0})]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    assert tcli.main(["serve", "--config", "classic13", "--set", "n_mels=60000", "--device", "cpu"]) == 0
    events = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]
    frames = np.concatenate([np.frombuffer(base64.b64decode(ev["data"]), "<f4").reshape(ev["n"], ev["dim"])
                             for ev in events if ev.get("event") == "frames"])
    assert any(ev.get("event") == "done" for ev in events)
    assert frames.shape == want.shape
    testing.assert_features_close(frames, want)


def _split_base(x, aug, lanes: int):
    """csrc/tail.cu's split base over prefix rows x [n, M1 - 1] (the energy
    lane left out) and dct_aug's first M1 - 1 rows, emulated in float32
    (each FMA rounded once): the plain FMA chain (tail_split_kernel) up to
    `lanes` lanes (kChainLanes); past it tail_base_kernel's order: warp w of
    tail.BASE_WARPS takes stretches w, w + 8, ... of tail.STRETCH lanes and
    keeps a compensated (Kahan) sum over their lanes in order, the warps'
    sums (acc - comp) then added in float64 in warp order and rounded once."""
    f32 = lambda a: np.asarray(a, np.float64).astype(np.float32).astype(np.float64)  # noqa: E731
    n = x.shape[1]
    prod = lambda m: x[:, m : m + 1].astype(np.float64) * aug[m][None, :].astype(np.float64)  # noqa: E731
    if n <= lanes:
        acc = np.zeros((x.shape[0], aug.shape[1]))
        for m in range(n):
            acc = f32(prod(m) + acc)
        return acc
    out = np.zeros((x.shape[0], aug.shape[1]))
    starts = range(0, n, tail.STRETCH)
    for w in range(tail.BASE_WARPS):
        acc, comp = np.zeros_like(out), np.zeros_like(out)
        for a in starts[w::tail.BASE_WARPS]:
            for m in range(a, min(a + tail.STRETCH, n)):
                y = f32(prod(m) - comp)
                t = f32(acc + y)
                comp = f32(f32(t - acc) - y)
                acc = t
        out = out + (acc - comp)
    return f32(out)


def test_tail_split_base_is_compensated_past_its_chain():
    """The tail's split (the plan every mfcc config past ~1,100 filters
    takes) sums base as the tiled kernel's FMA chain up to kChainLanes
    (1,024) lanes, so the plans agree bitwise there, and past it as
    tail_base_kernel's compensated sums (each warp's over its stretches of
    tail.STRETCH lanes, the warps' added in float64): on a front-end prefix
    of classic13_deltas with 40,000 filters the chain, emulated in float32,
    is over the tail's gate (max(2e-4, 2e-5·max|f|)) from the float64
    product, the compensated sums within a hundredth of it
    (tests/test_torch_wide.py also at 16,385 and 60,000 filters)."""
    src = (CSRC.parent / "tail.cu").read_text()
    lanes = int(re.search(r"constexpr int kChainLanes = (\d+);", src).group(1))
    assert lanes == tail.CHAIN_LANES == 1024 and "c = __fsub_rn(__fsub_rn(t, s), y);" in src
    cfg = T_CONFIGS["classic13_deltas"].replace(n_mels=40000)
    assert tail.plan(cfg)[0] == "split" and tail.split_base(cfg) == "stretches"
    x, lens = _rows(40000)
    prefix, _, _ = frontend.logmel_prefix_counts(torch.as_tensor(x[:1, :4000]), torch.as_tensor(lens[:1] * 0 + 4000),
                                                 cfg)
    p = prefix[0, :, : cfg.n_mels].numpy().astype(np.float32)
    aug = tchain.device_constants(cfg, torch.device("cpu"), torch.float64)["dct_aug"].numpy().astype(np.float32)
    exact = p.astype(np.float64) @ aug[: cfg.n_mels].astype(np.float64)
    gate = max(testing.TAIL_ATOL, testing.TAIL_REL * np.abs(exact).max())
    chain_err = np.abs(_split_base(p, aug, cfg.n_mels) - exact).max()
    base_err = np.abs(_split_base(p, aug, lanes) - exact).max()
    assert base_err < gate / 100 < gate < chain_err, (base_err, gate, chain_err)
