"""The port's feature tail (`mfcc_tpu_torch/kernels/tail.py`) ≡ the JAX
package's in-kernel cepstral tail and jnp chain.

On the CPU the wrapper takes its plain version (the prefix branch of
`chain.features_from_logmel`), so these tests hold:
  - `fused_logmel_stages(feature_tail=True)` against the JAX package's
    `fused_logmel_stages(..., interpret=True, feature_tail=True)` over the
    nine cases of tests/test_pallas_kernels.py::_TAIL_CASES, on the same
    signals, at that test's gate: max(2e-4, 2e-5·max|f|) absolute, masks
    equal, pad frames exactly 0;
  - a numpy mirror of csrc/tail.cu (tile by tile: the staged rows clamped to
    [0, n_valid - 1], base for the halo, D at clamped positions, ΔΔ, the mask,
    the CMVN kernel's two passes) against the plain version in float64, over
    n_valid ∈ {0, 1, 2, 3, 31, 32, 33, F} and F ∈ {1, 3, 31, 32, 33, 100}:
    1e-12 (the same arithmetic, only the order of sums differs);
  - rows longer than the reference's largest frame block (15 s), where the
    reference's tail refuses, against the JAX jnp chain at the 5e-4 cepstra
    gate;
  - `tail_reason` against `fused_tail_reason` on every named config, and a
    tail layout over the block refused on the CPU as on the card.
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

TILE = tail.TILE

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


def _emulate_tail(prefix, n_valid, cfg):
    """csrc/tail.cu in numpy (float64), tile by tile: the staged rows
    clamp(q, 0, last) for q in [f0 - h, f0 + 32 + h) (h = deltas·N), the
    energy lane logged and floored, base = x·dct_aug for every staged row,
    D at positions [f0 - e, f0 + 32 + e) (e = N for ΔΔ) read at clamp(p, 0,
    last), ΔΔ and the mask for the tile's rows; a tile wholly past n_valid
    stays 0. Then the CMVN kernel: per column, the mean over rows < n_valid
    (at least 1), the centred squares, the rows normalized in place."""
    aug = tconstants.chain_constants(cfg)["dct_aug"]
    B, F, M1 = prefix.shape
    C, N, nd = cfg.n_ceps, cfg.delta_window, cfg.deltas
    D = C * (nd + 1)
    h, e = nd * N, (N if nd >= 2 else 0)
    denom = 2.0 * sum(i * i for i in range(1, N + 1))
    out = np.zeros((B, F, D))
    for b in range(B):
        nv = min(max(int(n_valid[b]), 0), F)
        for f0 in range(0, F, TILE):
            if f0 >= nv:
                continue
            last = nv - 1
            x = prefix[b, np.clip(np.arange(f0 - h, f0 + TILE + h), 0, last)].copy()
            if cfg.append_energy:
                lane = x[:, M1 - 1]
                lane = np.log(np.where(lane <= 0, cfg.log_eps, lane))
                if cfg.energy_floor > 0:
                    lane = np.maximum(lane, np.log(cfg.energy_floor))
                x[:, M1 - 1] = lane
            base = x @ aug
            if nd >= 1:
                at = np.clip(np.arange(f0 - e, f0 + TILE + e), 0, last) - (f0 - h)
                d1 = sum(k * (base[at + k] - base[at - k]) for k in range(1, N + 1)) / denom
            for r in range(min(TILE, F - f0)):
                s = f0 + r
                if s >= nv:
                    continue
                parts = [base[r + h]]
                if nd >= 1:
                    parts.append(d1[r + e])
                if nd >= 2:
                    parts.append(sum(k * (d1[r + e + k] - d1[r + e - k]) for k in range(1, N + 1))
                                 / denom)
                out[b, s] = np.concatenate(parts)
        if cfg.cmvn == "utterance":
            v = out[b, :nv]
            n = max(nv, 1)
            mu = v.sum(axis=0) / n
            if cfg.cmvn_var_norm:
                sd = np.sqrt(((v - mu) ** 2).sum(axis=0) / n + cfg.cmvn_eps)
                out[b, :nv] = (v - mu) / sd
            else:
                out[b, :nv] = v - mu
    return out


MIRROR_CASES = {
    "deltas2": dict(name="classic13_deltas"),
    "deltas2_cmvn": dict(name="classic13_deltas", cmvn="utterance"),
    "deltas2_cmvn_mean": dict(name="classic13_deltas", cmvn="utterance", cmvn_var_norm=False),
    "deltas1_window3": dict(name="classic13", deltas=1, delta_window=3),
    "no_deltas_no_energy": dict(name="classic13", append_energy=False),
    "kaldi_floor_window1": dict(name="kaldi_mfcc", deltas=2, delta_window=1, energy_floor=1e-3),
}


@pytest.mark.parametrize("F", [1, 3, 31, 32, 33, 100])
@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_kernel_mirror_matches_plain_tail(case, F):
    kw = dict(MIRROR_CASES[case])
    cfg = T_CONFIGS[kw.pop("name")].replace(dtype="float64", **kw)
    nvs = sorted(v for v in {0, 1, 2, 3, 31, 32, 33, F} if v <= F)
    g = np.random.default_rng(F)
    prefix = g.standard_normal((len(nvs), F, cfg.n_mels + 1))
    prefix[..., -1] = np.abs(prefix[..., -1]) * 1e3 * (g.random((len(nvs), F)) > 0.1)  # some 0s
    want = tail.feature_tail_reference(torch.as_tensor(prefix), torch.tensor(nvs, dtype=torch.int32),
                                       cfg).numpy()
    got = _emulate_tail(prefix, nvs, cfg)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=1e-12)
    assert (got[np.arange(F)[None, :] >= np.asarray(nvs)[:, None]] == 0).all()


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
    assert "shared memory" in tail.tail_reason(cfg.replace(n_mels=200, n_ceps=200, delta_window=40))


def test_a_tail_layout_over_the_block_is_refused_on_both_devices():
    """An mfcc config whose tail block needs more shared memory than a block
    has (170 cepstra, delta window 8) is refused by `check_supported`, so the
    CPU chain refuses it as the card does; its front-end layout fits. The
    other families never take the tail, so its layout does not refuse them."""
    cfg = T_CONFIGS["classic13_deltas"].replace(n_mels=170, n_ceps=170, delta_window=8)
    assert frontend.layout_reason(cfg) is None
    assert "shared memory" in tail.layout_reason(cfg)
    assert "feature-tail layout" in tchain.unsupported_reason(cfg)
    x, n = torch.zeros((1, 800)), torch.tensor([800])
    with pytest.raises(NotImplementedError, match="feature-tail layout"):
        tchain.extract_batch(x, n, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="feature-tail layout"):
        frontend.fused_logmel_stages(x, n, cfg, feature_tail=True)
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
