"""The port's feature tail (`mfcc_tpu_torch/kernels/tail.py`) ≡ the JAX
package's in-kernel cepstral tail and jnp chain.

On the CPU the wrapper takes its plain version (the prefix branch of
`chain.features_from_logmel`), so these tests hold:
  - `fused_logmel_stages(feature_tail=True)` against the JAX package's
    `fused_logmel_stages(..., interpret=True, feature_tail=True)` over the
    nine cases of tests/test_pallas_kernels.py::_TAIL_CASES, on the same
    signals, at that test's gate: max(2e-4, 2e-5·max|f|) absolute, masks
    equal, pad frames exactly 0;
  - a numpy mirror of csrc/tail.cu (128-frame tiles: the distinct prefix
    rows staged from the flat prefix with the kernel's alignment shift or
    padded stride, base for each, D at clamped positions, ΔΔ, the mask, the
    output in the kernel's 16-byte store order with each float written once,
    the CMVN kernel's two passes; in the split plan its three passes through
    the output) against the plain version in float64, over n_valid at the
    old and new tile edges and F ∈ {1, 3, 31, 32, 33, 100, 127, 128, 129,
    257}: 1e-12 (the same arithmetic, only the order of sums differs); the
    tail's plans and layouts;
  - rows longer than the reference's largest frame block (15 s), where the
    reference's tail refuses, against the JAX jnp chain at the 5e-4 cepstra
    gate;
  - `tail_reason` against `fused_tail_reason` on every named config, and
    tails whose tiled layout is over the block taken on the CPU as on the
    card (the split plan).
"""

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
from mfcc_tpu_torch.kernels import frontend, tail
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.ops import constants as tconstants
from mfcc_tpu_torch.pipeline import pad_batch

# tests/test_pallas_kernels.py::_TAIL_CASES
TAIL_CASES = {
    "deltas2": dict(name="classic13_deltas"),
    "deltas2_cmvn": dict(name="classic13_deltas", cmvn="utterance"),
    "deltas1": dict(name="classic13", deltas=1),
    "plain13": dict(name="classic13"),
    "no_energy": dict(name="classic13", append_energy=False),
    "kaldi": dict(name="kaldi_mfcc"),
    "kaldi_dither": dict(name="kaldi_mfcc", dither=1.0, dither_seed=5),
    "kaldi_floor": dict(name="kaldi_mfcc", energy_floor=1e-3),
    "kaldi_center": dict(name="kaldi_mfcc", frame_tail="center"),
}


def _configs(case):
    kw = dict(TAIL_CASES[case])
    name = kw.pop("name")
    return T_CONFIGS[name].replace(**kw), J_CONFIGS[name].replace(**kw)


def _tail_gate(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=max(2e-4, 2e-5 * scale), rtol=0)


@pytest.mark.parametrize("case", sorted(TAIL_CASES))
def test_feature_tail_matches_pallas_tail(case):
    tcfg, jcfg = _configs(case)
    assert tail.tail_reason(tcfg) is None and jfrontend.fused_tail_reason(jcfg) is None
    sigs = golden_signals()
    xs = [sigs["speechish"], sigs["short"], np.zeros(700), sigs["noise"]]
    b = pad_batch(xs, tcfg, bucket_len=max(s.shape[0] for s in xs))
    st = frontend.fused_logmel_stages(torch.as_tensor(b.audio), torch.as_tensor(b.lengths), tcfg,
                                      feature_tail=True)
    assert "features_fused" in st and "prefix" not in st
    js = jfrontend.fused_logmel_stages(jnp.asarray(b.audio), jnp.asarray(b.lengths), jcfg,
                                       interpret=True, feature_tail=True)
    assert "features_fused" in js
    want = np.asarray(jchain.features_from_logmel(js, jcfg))[:, : js["num_frames"]]
    got = tchain.features_from_logmel(st, tcfg).numpy()
    mask = st["frame_mask"].numpy()
    np.testing.assert_array_equal(mask, np.asarray(js["frame_mask"]))
    assert got.shape == want.shape and st["num_frames"] == js["num_frames"]
    _tail_gate(got, want)
    assert (got[mask == 0] == 0).all()


def _stage(flat, total, lo, n, M1):
    """csrc/tail.cu step 1: the n floats from flat index lo as the block's
    staged row region holds them. Odd M1: 16-byte copies from the boundary
    at or below lo (floats past the tensor's end read as 0), the rows then
    begin `shift` floats in; even M1: one float a copy into rows M1 + 1
    apart. Returns (region, shift, row stride)."""
    XS = M1 | 1
    region = np.full(n // M1 * XS + 6 + 3, np.nan)
    if XS == M1:
        shift = lo % 4
        nvec = (n + shift + 3) // 4
        idx = lo - shift + np.arange(4 * nvec)
        region[: 4 * nvec] = np.where(idx < total, flat[np.minimum(idx, total - 1)], 0)
        return region, shift, XS
    i = np.arange(n)
    region[i // M1 * XS + i % M1] = flat[lo + i]
    return region, 0, XS


def _store_order(go, n_out):
    """csrc/tail.cu step 4: the output floats each store writes, in order:
    16-byte stores from the 16-byte boundary of the flat output index go,
    scalar stores for the head before it and the tail after the last whole
    quad."""
    head = min((4 - go % 4) % 4, n_out)
    quads = (n_out - head) // 4
    return ([head + 4 * q + np.arange(4) for q in range(quads)], list(range(head)),
            list(range(head + 4 * quads, n_out)))


def _emulate_split(prefix, n_valid, cfg, aug):
    """csrc/tail.cu's split plan (tail_split_kernel) in numpy (float64): pass
    0 writes base (the energy lane logged and floored, x·dct_aug) into each
    row's first C columns below n_valid and zeros across the rows at and
    past it; pass 1 writes D into [C, 2C) from the base columns, pass 2 ΔΔ
    into [2C, 3C) from the D columns, every read at a row clamped to [0,
    last]; the columns a later pass writes are NaN until then."""
    B, F, M1 = prefix.shape
    C, N, nd = cfg.n_ceps, cfg.delta_window, cfg.deltas
    D = C * (nd + 1)
    denom = 2.0 * sum(i * i for i in range(1, N + 1))
    out = np.full((B, F, D), np.nan)
    for b in range(B):
        nv = min(max(int(n_valid[b]), 0), F)
        out[b, nv:] = 0.0
        x = prefix[b, :nv].copy()
        if cfg.append_energy:
            lane = np.log(np.where(x[:, -1] <= 0, cfg.log_eps, x[:, -1]))
            x[:, -1] = np.maximum(lane, np.log(cfg.energy_floor)) if cfg.energy_floor > 0 else lane
        out[b, :nv, :C] = x @ aug
        s = np.arange(nv)
        for p in range(1, nd + 1):
            src = out[b, :, (p - 1) * C : p * C]
            out[b, :nv, p * C : (p + 1) * C] = sum(
                k * (src[np.minimum(s + k, nv - 1)] - src[np.maximum(s - k, 0)])
                for k in range(1, N + 1)) / denom
    return out


def _emulate_tail(prefix, n_valid, cfg):
    """csrc/tail.cu in numpy (float64), tile by tile at `tail.plan`'s tile
    (128 frames; 64 or 32 for a wide generic shape), or by the split's passes
    (`_emulate_split`) in its split plan: the distinct prefix
    rows [q_lo, q_hi] = [max(f0 - h, 0), min(f0 + tile - 1 + h, last)] (h =
    deltas·N) staged from the flat prefix (`_stage`), the energy lane logged
    and floored, base = x·dct_aug for each distinct row, D at the distinct
    positions [max(f0 - e, 0), min(f0 + tile - 1 + e, last)] (e = N for ΔΔ)
    with every read clamped to [0, last], then the tile's flat output in the
    kernel's store order (`_store_order`, each float written once): base, D,
    ΔΔ from D, 0 past n_valid; a tile wholly past n_valid writes zeros. Then
    the CMVN kernel: per column, the mean over rows < n_valid (at least 1),
    the centred squares, the rows normalized in place."""
    aug = tconstants.chain_constants(cfg)["dct_aug"]
    mode, tile, _ = tail.plan(cfg)
    B, F, M1 = prefix.shape
    C, N, nd = cfg.n_ceps, cfg.delta_window, cfg.deltas
    N = N if nd else 0
    D = C * (nd + 1)
    h, e = nd * N, (N if nd >= 2 else 0)
    denom = 2.0 * sum(i * i for i in range(1, N + 1))
    flat = prefix.reshape(-1)
    split = mode == "split"
    out = _emulate_split(prefix, n_valid, cfg, aug).reshape(-1) if split else np.full(B * F * D, np.nan)
    for b in range(B):
        nv = min(max(int(n_valid[b]), 0), F)
        last = nv - 1
        for f0 in range(0, 0 if split else F, tile or 1):
            rows = min(tile, F - f0)
            go = (b * F + f0) * D
            vals = np.zeros(rows * D)
            if f0 < nv:
                q_lo, q_hi = max(f0 - h, 0), min(f0 + tile - 1 + h, last)
                n = (q_hi - q_lo + 1) * M1
                region, shift, XS = _stage(flat, flat.size, (b * F + q_lo) * M1, n, M1)
                r = np.arange(q_hi - q_lo + 1)
                x = region[shift + r[:, None] * XS + np.arange(M1)]
                if cfg.append_energy:
                    lane = x[:, M1 - 1]
                    lane = np.log(np.where(lane <= 0, cfg.log_eps, lane))
                    if cfg.energy_floor > 0:
                        lane = np.maximum(lane, np.log(cfg.energy_floor))
                    x[:, M1 - 1] = lane
                base = x @ aug  # row q at q - q_lo

                def clamp(j):
                    return np.clip(j, 0, last)

                def dsum(v, c, lo):  # sum_k k (v(c + k) - v(c - k)) / denom, reads clamped
                    return sum(k * (v[clamp(c + k) - lo] - v[clamp(c - k) - lo])
                               for k in range(1, N + 1)) / denom

                if nd >= 1:
                    d_lo, d_hi = max(f0 - e, 0), min(f0 + tile - 1 + e, last)
                    d1 = dsum(base, np.arange(d_lo, d_hi + 1), q_lo)  # position c at c - d_lo
                s = np.arange(f0, min(f0 + rows, nv))
                parts = [base[s - q_lo]]
                if nd >= 1:
                    parts.append(d1[s - d_lo])
                if nd >= 2:
                    parts.append(dsum(d1, s, d_lo))
                vals[: len(s) * D] = np.concatenate(parts, axis=1).reshape(-1)
            quads, head, tail_ = _store_order(go, rows * D)
            order = np.concatenate([np.concatenate(quads) if quads else np.zeros(0, int),
                                    np.asarray(head, int), np.asarray(tail_, int)])
            assert np.array_equal(np.sort(order), np.arange(rows * D))  # each float once
            out[go + order] = vals[order]
        if cfg.cmvn == "utterance":
            v = out[b * F * D: (b + 1) * F * D].reshape(F, D)[:nv]
            n = max(nv, 1)
            mu = v.sum(axis=0) / n
            if cfg.cmvn_var_norm:
                sd = np.sqrt(((v - mu) ** 2).sum(axis=0) / n + cfg.cmvn_eps)
                v[:] = (v - mu) / sd
            else:
                v[:] = v - mu
    return out.reshape(B, F, D)


MIRROR_CASES = {
    "deltas2": dict(name="classic13_deltas"),
    "deltas2_cmvn": dict(name="classic13_deltas", cmvn="utterance"),
    "deltas2_cmvn_mean": dict(name="classic13_deltas", cmvn="utterance", cmvn_var_norm=False),
    "deltas1_window3": dict(name="classic13", deltas=1, delta_window=3),
    "no_deltas_no_energy": dict(name="classic13", append_energy=False),
    "kaldi_floor_window1": dict(name="kaldi_mfcc", deltas=2, delta_window=1, energy_floor=1e-3),
    "kaldi": dict(name="kaldi_mfcc"),
    "wide_generic_tile64": dict(name="classic13_deltas", n_mels=150, n_ceps=140),
    # 170 cepstra at delta window 8: over the block at every tile, so the split
    "dct_global_170_window8": dict(name="classic13_deltas", n_mels=170, n_ceps=170, delta_window=8),
    "split_200_window40_cmvn": dict(name="classic13_deltas", n_mels=200, n_ceps=200, delta_window=40,
                                    cmvn="utterance"),
    "split_deltas1": dict(name="classic13", deltas=1, n_mels=200, n_ceps=200, delta_window=60),
}
# the new tile's edges (tile - 1, tile, tile + 1, two tiles + 1) beside the
# parent's 32-frame ones
TAIL_F = [1, 3, 31, 32, 33, 100, 127, 128, 129, 257]


@pytest.mark.parametrize("F", TAIL_F)
@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_kernel_mirror_matches_plain_tail(case, F):
    kw = dict(MIRROR_CASES[case])
    cfg = T_CONFIGS[kw.pop("name")].replace(dtype="float64", **kw)
    nvs = sorted(v for v in {0, 1, 2, 3, 31, 32, 33, 63, 64, 65, 127, 128, 129, F} if v <= F)
    g = np.random.default_rng(F)
    prefix = g.standard_normal((len(nvs), F, cfg.n_mels + 1))
    prefix[..., -1] = np.abs(prefix[..., -1]) * 1e3 * (g.random((len(nvs), F)) > 0.1)  # some 0s
    want = tail.feature_tail_reference(torch.as_tensor(prefix), torch.tensor(nvs, dtype=torch.int32),
                                       cfg).numpy()
    got = _emulate_tail(prefix, nvs, cfg)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=1e-12)
    assert (got[np.arange(F)[None, :] >= np.asarray(nvs)[:, None]] == 0).all()


def test_tail_plans_and_layouts():
    """The named mfcc shapes are compiled with fixed sizes at 128 frames a
    block; a generic shape halves the tile until its layout fits (150 mels,
    140 cepstra: 64 frames), then takes the split (170 cepstra at delta
    window 8: 236,256 B at 32 frames; 200 at window 40: 558,400 B; no tile
    and no shared memory). The layout mirrors csrc/tail.cu tail_layout: at
    classic13_deltas 136 staged rows of 27 floats (+6), 136 base rows and
    132 D rows of 13, 28,656 B; kaldi_mfcc's even rows padded to 25."""
    c = T_CONFIGS
    assert all(tail.fixed_shape(c[n]) for n in c if c[n].features == "mfcc")
    assert not tail.fixed_shape(c["classic13"].replace(deltas=1))
    assert tail.plan(c["classic13_deltas"]) == (
        "staged", 128, 4 * ((136 * 27 + 6 + 3) // 4 * 4 + 136 * 13 + 132 * 13))
    assert tail.plan(c["classic13_deltas"]) == ("staged", 128, 28656)
    assert tail.plan(c["kaldi_mfcc"]) == ("staged", 128, 4 * ((128 * 25 + 6 + 3) // 4 * 4 + 128 * 13))
    assert tail.plan(c["classic13_deltas"].replace(n_mels=150, n_ceps=140))[:2] == ("staged", 64)
    wide = c["classic13_deltas"].replace(n_mels=170, n_ceps=170, delta_window=8)
    assert tail.plan(wide) == ("split", 0, 0) and 4 * tail._floats(wide, 32) == 236256
    wider = c["classic13_deltas"].replace(n_mels=200, n_ceps=200, delta_window=40)
    assert tail.plan(wider) == ("split", 0, 0) and 4 * tail._floats(wider, 32) == 558400
    assert all(tail.tail_reason(x) is None for x in (wide, wider))


@pytest.mark.parametrize("cmvn", ["off", "utterance"])
def test_tail_on_rows_over_the_reference_block(cmvn):
    """15 s rows (1,499 frames) need three of the reference's frame blocks,
    where its tail refuses and quietly keeps the XLA epilogue; the port's
    tail computes them, within 5e-4 of the JAX jnp chain."""
    tcfg = T_CONFIGS["classic13_deltas"].replace(cmvn=cmvn)
    jcfg = J_CONFIGS["classic13_deltas"].replace(cmvn=cmvn)
    g = np.random.default_rng(4)
    n = 16000 * 15
    b = pad_batch([g.standard_normal(n) * 0.3, g.standard_normal(n - 16001) * 0.3], tcfg)
    F = tcfg.num_frames(b.audio.shape[1])
    assert F > 1024 and not jfrontend.fused_tail_active(jcfg, F)
    st = frontend.fused_logmel_stages(torch.as_tensor(b.audio), torch.as_tensor(b.lengths), tcfg,
                                      feature_tail=True)
    want, wmask = jchain.extract_batch(jnp.asarray(b.audio), jnp.asarray(b.lengths), jcfg,
                                       backend="jnp")
    np.testing.assert_array_equal(st["frame_mask"].numpy(), np.asarray(wmask))
    got = st["features_fused"].numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=testing.FEATURE_ATOL,
                               rtol=testing.FEATURE_RTOL)


@pytest.mark.parametrize("name", sorted(T_CONFIGS))
def test_tail_reason_agrees_with_the_reference(name):
    ours = tail.tail_reason(T_CONFIGS[name])
    theirs = jfrontend.fused_tail_reason(J_CONFIGS[name])
    assert (ours is None) == (theirs is None), (ours, theirs)


def test_short_drop_batch_gives_empty_features():
    """"drop" framing of rows shorter than a frame: F = 0, the tail returns
    the empty [B, 0, feat_dim]."""
    cfg = T_CONFIGS["kaldi_mfcc"].replace(deltas=2)
    st = frontend.fused_logmel_stages(torch.zeros((3, 399), dtype=torch.int16),
                                      torch.tensor([399, 1, 0]), cfg, feature_tail=True)
    assert tuple(st["features_fused"].shape) == (3, 0, cfg.feat_dim)
    assert tuple(st["frame_mask"].shape) == (3, 0) and st["num_frames"] == 0


def test_other_families_keep_the_prefix():
    """feature_tail=True on a config the tail does not take (logmel80) gives
    the prefix stage dict, as the reference's ineligible configs do, and
    features_from_logmel finishes it."""
    cfg = T_CONFIGS["logmel80"]
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 8000)).astype(np.float32))
    st = frontend.fused_logmel_stages(x, torch.tensor([8000, 5000]), cfg, feature_tail=True)
    assert "prefix" in st and "features_fused" not in st
    feat = tchain.features_from_logmel(st, cfg)
    want, _ = tchain.extract_batch(x, torch.tensor([8000, 5000]), cfg, device="cpu")
    torch.testing.assert_close(feat, want, atol=2e-5, rtol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    cfg = T_CONFIGS["classic13_deltas"]
    with pytest.raises(ValueError, match="runs on CUDA"):
        tail.feature_tail(torch.empty((1, 4, 27), device="meta"),
                          torch.empty(1, dtype=torch.int32, device="meta"), cfg)
    with pytest.raises(ValueError, match="not in"):
        frontend.fused_logmel_stages(torch.zeros((1, 800)), torch.tensor([800]), cfg,
                                     dft_passes="bf16x6")
    with pytest.raises(NotImplementedError, match="float32"):
        frontend.fused_logmel_stages(torch.zeros((1, 800)), torch.tensor([800]),
                                     cfg.replace(dtype="float64"))
    assert "mfcc" in tail.tail_reason(T_CONFIGS["kaldi_plp"])
    assert tail.tail_reason(cfg.replace(n_mels=200, n_ceps=200, delta_window=40)) is None


def test_a_tail_layout_over_the_block_is_refused_on_both_devices():
    """An mfcc config whose tiled tail with dct_aug staged needs more shared
    memory than a block has (170 cepstra at delta window 8; 200 at window
    40, whose staged rows and halo are over the block at any tile), refused
    before on both devices, is taken on both: `check_supported` passes, the
    tail takes the split, and the
    CPU chain's features ≡ `fused_logmel_stages(feature_tail=True)`'s (the
    tail's plain version on the CPU), masks equal."""
    for over, plan in ((dict(n_mels=170, n_ceps=170, delta_window=8), "split"),
                       (dict(n_mels=200, n_ceps=200, delta_window=40, cmvn="utterance"), "split")):
        cfg = T_CONFIGS["classic13_deltas"].replace(**over)
        assert frontend.layout_reason(cfg) is None and tchain.unsupported_reason(cfg) is None
        assert tail.plan(cfg)[0] == plan
        g = np.random.default_rng(cfg.n_ceps)
        x = torch.as_tensor(np.round(g.standard_normal((2, 24000)) * 3000).astype(np.float32))
        n = torch.tensor([24000, 9000])
        feat, mask = tchain.extract_batch(x, n, cfg, device="cpu")
        st = frontend.fused_logmel_stages(x, n, cfg, feature_tail=True)
        torch.testing.assert_close(st["features_fused"], feat, atol=2e-4, rtol=0)
        assert torch.equal(st["frame_mask"], mask) and bool((feat[mask == 0] == 0).all())
        assert tchain.unsupported_reason(cfg.replace(features="logmel")) is None


def test_extract_batch_cpu_is_the_plain_chain():
    """On the CPU extract_batch stays the plain chain, equal to the tail's
    plain version on the plain prefix."""
    cfg = T_CONFIGS["classic13_deltas"].replace(cmvn="utterance")
    g = np.random.default_rng(6)
    b = pad_batch([g.standard_normal(9000) * 0.3, g.standard_normal(3000) * 0.3], cfg)
    feat, mask = tchain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    st = frontend.fused_logmel_stages(torch.as_tensor(b.audio), torch.as_tensor(b.lengths), cfg,
                                      feature_tail=True)
    torch.testing.assert_close(st["features_fused"], feat, atol=2e-5, rtol=0)
    assert torch.equal(st["frame_mask"], mask)
