"""The valid frame counts and the frame mask the front-end kernel writes
(`csrc/frontend.cu` valid_frames, `kernels/frontend.py` logmel_prefix_counts)
≡ the port's `chain.num_valid_frames` / `chain.frame_mask` ≡ the JAX
package's `mfcc_tpu/ops/chain.py::num_valid_frames`.

The kernel cannot run here, so a numpy mirror of its integer arithmetic
(64-bit, C's division that truncates toward zero, the fused resample's
output length ceil(n·up / down) = (n·up + down - 1) / down) is held against
both chains over every framing ("pad", "drop", "center", "center_reflect"),
with and without drop_last_frame, for rows at 16 kHz and resampled from 48
and 44.1 kHz, at edge lengths: 0, 1, a frame length and its neighbours,
hop and tile edges, negative lengths, and 44.1 kHz rows over 13.4 M samples
(where n·160 passes 2^31). Centered resampled rows take the split route
on the card, whose plain form counts from the output lengths resample.cu
writes by the same formula (in 64 bits, then int32: no clamp is reached
when down-sampling). Exact: they are integers. The CPU route of
`logmel_prefix_counts` and `fused_logmel_stages` returns the chain's counts;
tests/test_torch_gpu.py holds the kernel's own on a card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu.ops import resample as jresample
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.ops import resample as tresample

CSRC = Path(__file__).resolve().parents[1] / "mfcc_tpu_torch" / "kernels" / "csrc" / "frontend.cu"
RATES = (None, 48000, 44100)
# 13,421,773 = the first 44.1 kHz length whose n * 160 passes 2^31
BIG_44K = [13_421_772, 13_421_773, 13_421_774, 20_000_000, 441_000_000, 2**31 - 1]


def _cdiv(a: int, b: int) -> int:
    """C's integer division for b > 0: truncates toward zero."""
    q = abs(a) // b
    return q if a >= 0 else -q


def _output_length(n: int, up: int, down: int) -> int:
    """csrc/polyphase.cuh pp_output_length, in 64 bits."""
    v = n * up + down - 1
    assert -(2**63) <= v < 2**63
    return _cdiv(v, down)


def _valid_frames(n: int, cfg) -> int:
    """csrc/frontend.cu valid_frames: 0 for n <= 0; every numerator made
    non-negative before C's division."""
    if n <= 0:
        return 0
    L, S = cfg.frame_length, cfg.frame_step
    if cfg.frame_tail == "drop":
        v = 1 + _cdiv(n - L, S) if n >= L else 0
    elif cfg.frame_tail == "center":
        v = _cdiv(n + S // 2, S)
    elif cfg.frame_tail == "center_reflect":
        v = 1 + _cdiv(n + 2 * (L // 2) - L, S)
    else:
        v = 1 + _cdiv(max(n - L, 0) + S - 1, S)
    if cfg.drop_last_frame:
        v = max(v - 1, 0)
    return v


def kernel_counts(lengths, cfg) -> np.ndarray:
    """The kernel's n_valid for raw lengths (int32 values), as the mirror
    computes it: from the output length for resampling configs."""
    out = []
    for n in (int(x) for x in lengths):
        if tchain.resamples(cfg):
            up, down = tresample.ratio(cfg.input_sample_rate, cfg.sample_rate)
            n = _output_length(n, up, down)
        out.append(_valid_frames(n, cfg))
    return np.asarray(out, np.int64)


def _edge_lengths(cfg) -> list[int]:
    L, S = cfg.frame_length, cfg.frame_step
    at16 = [0, 1, 2, L - 1, L, L + 1, S - 1, S, S + 1, S // 2, 31 * S + L - 1, 31 * S + L,
            31 * S + L + 1, 160_000, 479_999, 480_000, 480_001, 2**30, 2**31 - 2 * S]
    if not tchain.resamples(cfg):
        return at16 + [-1, -S]
    up, down = tresample.ratio(cfg.input_sample_rate, cfg.sample_rate)
    # input lengths whose output lengths sit at those edges, and their neighbours
    near = sorted({max(0, -(-m * down // up)) + k for m in at16 if m < 2**28 for k in (-1, 0, 1)})
    return near + [-1, -down, 441_000, 480_000] + (BIG_44K if up > 1 else [])


def _cases():
    out = []
    for tail in frontend.FRAMINGS:
        for drop_last in (False, True):
            for rate in RATES:
                out.append(pytest.param(tail, drop_last, rate,
                                        id=f"{tail}-{'drop_last' if drop_last else 'all'}-{rate or 16000}"))
    return out


def _configs(tail, drop_last, rate):
    name = "kaldi_mfcc" if tail == "drop" else "classic13"
    kw = dict(frame_tail=tail, drop_last_frame=drop_last, input_sample_rate=rate)
    return T_CONFIGS[name].replace(**kw), J_CONFIGS[name].replace(**kw)


@pytest.mark.parametrize("tail,drop_last,rate", _cases())
def test_kernel_counts_match_both_chains(tail, drop_last, rate):
    tcfg, jcfg = _configs(tail, drop_last, rate)
    lens = np.asarray(_edge_lengths(tcfg), np.int64)
    assert lens.min() >= -(2**31) and lens.max() < 2**31
    want = kernel_counts(lens, tcfg)
    t_len = torch.as_tensor(lens.astype(np.int32))
    j_len = jnp.asarray(lens.astype(np.int32))
    if rate:
        t_len = tresample.output_lengths(t_len, rate, tcfg.sample_rate)
        j_len = jresample.output_lengths(j_len, rate, jcfg.sample_rate)
    got_t = tchain.num_valid_frames(t_len, tcfg)
    got_j = np.asarray(jchain.num_valid_frames(j_len, jcfg))
    assert got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(got_j, want)
    if rate == 44100:  # the rows over 13.4 M samples pass 2^31 in n * up, not in the result
        assert max(int(n) * 160 for n in BIG_44K) >= 2**31 and want.max() < 2**31


@pytest.mark.parametrize("tail,drop_last,rate", _cases())
def test_kernel_mask_matches_the_chains(tail, drop_last, rate):
    """Each block writes mask[b, f] = f < n_valid[b] for its own frames: the
    mirror over 32-frame tiles (and bf16x3's 64) of F frames ≡ chain.frame_mask."""
    tcfg, _ = _configs(tail, drop_last, rate)
    lens = np.asarray(_edge_lengths(tcfg)[:16], np.int64)
    nv = kernel_counts(lens, tcfg)
    F = 70
    for tile in (32, 64):
        mask = np.full((len(lens), F), np.nan, np.float32)
        for f0 in range(0, F, tile):
            f = np.arange(f0, min(f0 + tile, F))
            mask[:, f] = (f[None, :] < nv[:, None]).astype(np.float32)
        want = tchain.frame_mask(torch.as_tensor(nv.astype(np.int32)), F, torch.float32).numpy()
        np.testing.assert_array_equal(mask, want)


@pytest.mark.parametrize("name", ["classic13_deltas", "kaldi_mfcc", "whisper80", "mfcc39_48k", "mfcc39_44k"])
def test_cpu_route_returns_the_chains_counts(name):
    """On the CPU `logmel_prefix_counts` and `fused_logmel_stages` return
    the plain counts and mask (`frame_counts_reference`), which the mirror
    of the kernel's arithmetic reproduces at each row's length."""
    cfg = T_CONFIGS[name]
    rate = cfg.input_sample_rate or cfg.sample_rate
    T = rate // 2
    L_in = -(-cfg.frame_length * rate // cfg.sample_rate)
    lens = np.array([0, 1, L_in - 1, L_in, L_in + 1, T - 1, T], np.int32)
    audio = torch.as_tensor(np.random.default_rng(3).standard_normal((len(lens), T)).astype(np.float32))
    prefix, nv, mask = frontend.logmel_prefix_counts(audio, torch.as_tensor(lens), cfg)
    F = prefix.shape[1]
    assert nv.dtype == torch.int32 and mask.dtype == torch.float32 and tuple(mask.shape) == (len(lens), F)
    np.testing.assert_array_equal(nv.numpy(), kernel_counts(lens, cfg))
    assert torch.equal(mask, tchain.frame_mask(nv, F, torch.float32))
    st = frontend.fused_logmel_stages(audio, torch.as_tensor(lens), cfg, feature_tail=True)
    assert torch.equal(st["n_valid"], nv) and torch.equal(st["frame_mask"], mask)
    assert torch.equal(frontend.logmel_prefix(audio, torch.as_tensor(lens), cfg), prefix)


def test_framing_codes_match_the_kernel_source():
    """FRAMINGS' order is csrc/frontend.cu's framing enum."""
    enum = re.search(r"enum \{ (kFramePad = 0, [^}]*)\};", CSRC.read_text()).group(1)
    codes = [int(v) for v in re.findall(r"= (\d+)", enum)]
    assert codes == list(range(len(frontend.FRAMINGS)))
    names = re.findall(r"kFrame(\w+) =", enum)
    assert [n.lower() for n in names] == [f.replace("_", "") for f in frontend.FRAMINGS]
