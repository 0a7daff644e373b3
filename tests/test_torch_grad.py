"""The training path of the port: gradients of the features with respect to
the raw audio, on the CPU, against the JAX package.

- the reference's four tests (tests/test_grad.py) on the port: finite
  gradients through the mfcc, logmel and ssc families that agree with a
  float64 central difference along a random direction within 1e-5; zero
  gradient across rows and past each row's length; `extract_batch_diff`'s
  forward bitwise `extract_batch`'s and its gradient the plain chain's;
  int16 and 3-D input refused;
- the port's `extract_batch_diff` on CPU tensors against `jax.grad` of
  `mfcc_tpu.ops.chain.extract_batch_diff` (its Pallas forward in interpret
  mode, as the reference's own test runs it): relative max diff < 1e-4;
- the plain chain's gradient against `jax.grad` of the jnp chain for the
  mfcc, logmel, ssc, PLP, spectrogram and whisper80 families and a 48 kHz
  config: relative max diff < 1e-4; the float64 directional derivative of
  PLP, spectrogram, whisper80 and the 48 kHz config at 1e-5 too.
The loss is (features**2).sum() throughout, on rows of 4,000 samples made
from a numpy seed.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfcc_tpu.config import named_config as jnamed_config
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu.pipeline import pad_batch as jpad_batch
from mfcc_tpu_torch.config import FrontendConfig, named_config
from mfcc_tpu_torch.ops import chain
from mfcc_tpu_torch.pipeline import pad_batch

RNG = np.random.default_rng(53)
GRAD_RTOL = 1e-4  # relative max diff of two gradients (largest |g| the scale)
DIRECTIONAL_RTOL = 1e-5


def _grad(audio: np.ndarray, lengths, cfg, fn=chain.extract_batch, loss_rows=slice(None)) -> np.ndarray:
    """d (feat[loss_rows]**2).sum() / d audio of the port's fn on the CPU."""
    a = torch.tensor(audio, requires_grad=True)
    n = torch.as_tensor(np.asarray(lengths))
    if fn is chain.extract_batch:
        feat, _ = fn(a, n, cfg, device="cpu")
    else:
        feat, _ = fn(a, n, cfg)
    (feat[loss_rows] ** 2).sum().backward()
    return a.grad.numpy()


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def _rows(cfg, n: int = 4000, rows: int = 2):
    sr = cfg.input_sample_rate or cfg.sample_rate
    xs = [RNG.standard_normal(n * sr // 16000) * 1000 + 50 for _ in range(rows)]
    return pad_batch(xs, cfg)


def _directional(cfg, b) -> tuple[float, float]:
    """(<grad, v>, the central difference along v) of the float64 plain
    chain's loss at b's rows."""
    cfg64 = cfg.replace(dtype="float64")
    lengths = torch.as_tensor(b.lengths)

    def loss(a):
        feat, _ = chain.extract_batch(a, lengths, cfg64, device="cpu")
        return (feat**2).sum()

    a64 = torch.tensor(b.audio, dtype=torch.float64, requires_grad=True)
    loss(a64).backward()
    v = torch.as_tensor(RNG.standard_normal(b.audio.shape))
    got = float((a64.grad * v).sum())
    # ssc's loss is O(kHz^2): eps 1e-4 is cancellation-limited in the central
    # difference; 1e-3 suits every family (the reference's choice)
    eps = 1e-3
    with torch.no_grad():
        a = a64.detach()
        num = float((loss(a + eps * v) - loss(a - eps * v)) / (2 * eps))
    return got, num


@pytest.mark.parametrize("features", ["mfcc", "logmel", "ssc"])
def test_grads_finite_and_match_directional(features):
    cfg = FrontendConfig(features=features, deltas=1)
    b = _rows(cfg)
    g = _grad(b.audio, b.lengths, cfg)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0  # not trivially zero
    got, num = _directional(cfg, b)
    assert num != 0
    assert abs(got - num) / abs(num) < DIRECTIONAL_RTOL, (got, num)


@pytest.mark.parametrize("name", ["kaldi_plp", "kaldi_spectrogram", "whisper80", "mfcc39_48k"])
def test_float64_directional_derivative_of_more_families(name):
    cfg = named_config(name)
    b = _rows(cfg)
    got, num = _directional(cfg, b)
    assert num != 0 and np.isfinite(got)
    assert abs(got - num) / abs(num) < DIRECTIONAL_RTOL, (got, num)


def test_grad_respects_batch_and_length_boundaries():
    """d loss(utterance 0) / d audio of utterance 1 is exactly zero, and so
    is the gradient past utterance 0's length, through the plain chain and
    through extract_batch_diff."""
    cfg = FrontendConfig(deltas=2)
    b = pad_batch([RNG.standard_normal(3000) * 500, RNG.standard_normal(5000) * 500], cfg)
    for fn in (chain.extract_batch, chain.extract_batch_diff):
        g = _grad(b.audio, b.lengths, cfg, fn, loss_rows=0)
        assert np.abs(g[1]).max() == 0.0  # the other utterance untouched
        assert np.abs(g[0, :3000]).max() > 0
        assert np.abs(g[0, 3000:]).max() == 0.0  # padding cannot move row 0


def test_diff_forward_is_extract_batch_and_grad_is_the_plain_chain():
    """extract_batch_diff: the forward bitwise extract_batch's (on the CPU
    the plain chain; on the card the kernels, tests/test_torch_gpu.py), the
    gradient the plain chain's, the mask without a gradient."""
    cfg = named_config("classic13_deltas")
    b = _rows(cfg)
    a = torch.tensor(b.audio, requires_grad=True)
    feat, mask = chain.extract_batch_diff(a, b.lengths, cfg)
    want, want_mask = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    assert torch.equal(feat, want) and torch.equal(mask, want_mask)
    assert feat.requires_grad and not mask.requires_grad
    (feat**2).sum().backward()
    gp = _grad(b.audio, b.lengths, cfg)
    assert np.isfinite(a.grad.numpy()).all() and np.abs(gp).max() > 0
    np.testing.assert_array_equal(a.grad.numpy(), gp)


def test_diff_rejects_non_flat_input():
    cfg = named_config("classic13")
    flat = pad_batch([RNG.standard_normal(16000).astype(np.float32)], cfg)
    with pytest.raises(ValueError, match="flat float audio"):
        chain.extract_batch_diff(torch.as_tensor(flat.audio)[:, None, :], flat.lengths, cfg)
    with pytest.raises(ValueError, match="flat float audio"):
        chain.extract_batch_diff(torch.as_tensor(np.asarray(flat.audio, np.int16)), flat.lengths, cfg)


def test_diff_takes_host_arrays_to_the_card():
    """A CPU tensor runs the plain chain where it lies; a host array goes to
    the card as in extract_batch, so without one it raises (after the
    input's own checks) instead of running on the CPU."""
    cfg = named_config("classic13")
    b = pad_batch([RNG.standard_normal(4000).astype(np.float32)], cfg)
    feat, _ = chain.extract_batch_diff(torch.as_tensor(b.audio), b.lengths, cfg)
    assert feat.device.type == "cpu"
    for host in (b.audio, b.audio.tolist()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            chain.extract_batch_diff(host, b.lengths, cfg)
    with pytest.raises(ValueError, match="flat float audio"):
        chain.extract_batch_diff(np.asarray(b.audio, np.int16), b.lengths, cfg)


@pytest.mark.parametrize("name, over", [("classic13_deltas", {}), ("logmel80", {}), ("kaldi_mfcc", {"dither": 1.0})],
                         ids=["classic13_deltas", "logmel80", "kaldi_mfcc_dither"])
def test_diff_grad_matches_jax_extract_batch_diff(name, over):
    """The port's extract_batch_diff on CPU tensors against jax.grad of the
    JAX package's extract_batch_diff (Pallas forward, jnp-twin backward) on
    the same rows; with dither the contract noise is in both forwards and
    both backwards."""
    jcfg, cfg = jnamed_config(name).replace(**over), named_config(name).replace(**over)
    xs = [RNG.standard_normal(4000) * 1000 + 50 for _ in range(2)]
    jb, b = jpad_batch(xs, jcfg), pad_batch(xs, cfg)
    np.testing.assert_array_equal(jb.audio, b.audio)
    lengths = jnp.asarray(jb.lengths)
    want = np.asarray(jax.grad(lambda x: (jchain.extract_batch_diff(x, lengths, jcfg)[0] ** 2).sum())(
        jnp.asarray(jb.audio)))
    got = _grad(b.audio, b.lengths, cfg, chain.extract_batch_diff)
    assert np.isfinite(got).all()
    assert _rel(got, want) < GRAD_RTOL, _rel(got, want)


def test_diff_grad_of_whisper80_fed_48k_matches_jax():
    """extract_batch_diff on whisper80 fed 48 kHz (centered framing of
    resampled rows, which the port refused before): two rows of 0.25 s at
    48 kHz, no padding (the reference's gradient reaches padding, ROADMAP
    queue 3), against `jax.grad` of the JAX package's extract_batch_diff
    (its resample, then its Pallas forward in interpret mode; the jnp twin's
    backward) within 1e-4; its forward the port's extract_batch, bitwise,
    and a float64 directional derivative within 1e-5."""
    name, over = "whisper80", {"input_sample_rate": 48000}
    jcfg, cfg = jnamed_config(name).replace(**over), named_config(name).replace(**over)
    b = types.SimpleNamespace(audio=(RNG.standard_normal((2, 12000)) * 1000 + 50).astype(np.float32),
                              lengths=np.array([12000, 12000], np.int32))
    lengths = jnp.asarray(b.lengths)
    want = np.asarray(jax.grad(lambda x: (jchain.extract_batch_diff(x, lengths, jcfg)[0] ** 2).sum())(
        jnp.asarray(b.audio)))
    got = _grad(b.audio, b.lengths, cfg, chain.extract_batch_diff)
    assert np.isfinite(got).all()
    assert _rel(got, want) < GRAD_RTOL, _rel(got, want)
    feat, _ = chain.extract_batch_diff(torch.as_tensor(b.audio), b.lengths, cfg)
    plain, _ = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    assert torch.equal(feat, plain)
    g, num = _directional(cfg, b)
    assert abs(g - num) <= DIRECTIONAL_RTOL * abs(num), (g, num)


def _jnp_grad(b, jcfg) -> np.ndarray:
    lengths = jnp.asarray(b.lengths)

    def loss(a):
        feat, _ = jchain.extract_batch(a, lengths, jcfg, backend="jnp")
        return (feat**2).sum()

    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(b.audio)))


RAGGED = ("classic13_deltas", "logmel80", "ssc26", "kaldi_plp", "kaldi_spectrogram", "whisper80", "mfcc39_48k")


@functools.lru_cache(maxsize=None)
def _ragged(name: str):
    """(batch, the JAX package's jnp-chain gradient) of three rows of
    `name`, the second 700 samples short and zero past its length; made
    once a module (kaldi_plp's gradient takes JAX ~11 s to compile)."""
    cfg = named_config(name)
    g = np.random.default_rng(RAGGED.index(name))
    sr = cfg.input_sample_rate or cfg.sample_rate
    b = pad_batch([g.standard_normal(4000 * sr // 16000) * 1000 + 50 for _ in range(3)], cfg)
    b.lengths[1] -= 700
    b.audio[_past_lengths(b)] = 0
    return b, _jnp_grad(b, jnamed_config(name))


def _past_lengths(b) -> np.ndarray:
    return np.arange(b.audio.shape[1])[None, :] >= b.lengths[:, None]


@pytest.mark.parametrize("name", RAGGED)
def test_plain_chain_grad_matches_jax_jnp_grad(name):
    """The mfcc, logmel, ssc, PLP, spectrogram and whisper80 families and a
    48 kHz config on a ragged batch: the port's gradient is finite, exactly
    zero past each length, and agrees with the JAX package's wherever that
    is finite (`test_plp_gradient_is_finite_at_a_pad_frame`)."""
    cfg = named_config(name)
    assert cfg.config_hash() == jnamed_config(name).config_hash()
    b, want = _ragged(name)
    got = _grad(b.audio, b.lengths, cfg)
    past = _past_lengths(b)
    assert np.isfinite(got).all() and np.nanmax(np.abs(want)) > 0
    assert not got[past].any()
    # past the lengths the JAX package's gradient of a resampling config is
    # not 0 (test_resampled_gradient_is_zero_past_the_length)
    keep = np.isfinite(want) & ~past
    assert keep[0, : b.lengths[0]].all()
    assert _rel(np.where(keep, got, 0), np.where(keep, want, 0)) < GRAD_RTOL


def test_plp_gradient_is_finite_at_a_pad_frame():
    """PLP's power law x**(1/3) has an infinite derivative at 0, the mel
    energy of a pad frame, whose upstream gradient (the mask's) is 0: the
    JAX package's `plp_base` gives 0·inf = NaN there when differentiated op
    by op (a fault of the reference, ROADMAP queue 3; its jitted chain
    happens to give a finite gradient); under autograd the port's
    `plp_base` takes the power of 1 there and puts the 0 back, so its
    gradient is finite and its values are those of extraction's plain
    power. (The ragged kaldi_plp batch of
    `test_plain_chain_grad_matches_jax_jnp_grad` has such pad frames.)"""
    cfg = named_config("kaldi_plp")
    mel = RNG.uniform(1.0, 1e4, (2, cfg.n_mels))
    mel[1] = 0.0  # a pad frame
    energy = np.array([1e4, cfg.log_eps])

    def jloss(m):
        return (jchain.plp_base(m, jnp.asarray(energy, jnp.float32), jnamed_config("kaldi_plp"))[0] ** 2).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(mel, jnp.float32)))
    m = torch.tensor(mel, dtype=torch.float32, requires_grad=True)
    base = chain.plp_base(m, torch.as_tensor(energy, dtype=torch.float32), cfg)
    (base[0] ** 2).sum().backward()
    # the safe power under autograd gives extraction's values bit for bit
    assert torch.equal(base.detach(), chain.plp_base(m.detach(), torch.as_tensor(energy, dtype=torch.float32), cfg))
    assert np.isnan(want[1]).any()  # the reference's
    assert torch.isfinite(m.grad).all() and not m.grad[1].any()
    assert _rel(m.grad[0].numpy(), want[0]) < GRAD_RTOL
    jbase = jchain.plp_base(jnp.asarray(mel, jnp.float32), jnp.asarray(energy, jnp.float32),
                            jnamed_config("kaldi_plp"))
    np.testing.assert_allclose(base.detach().numpy(), np.asarray(jbase), rtol=1e-5, atol=1e-5)


def test_resampled_gradient_is_zero_past_the_length():
    """mfcc39_48k: the port zeroes each row past its length before it
    resamples, so neither the features nor their gradient depend on the
    padding; the JAX package's jnp chain resamples the padded row, and its
    gradient reaches the padding (a fault of the reference, ROADMAP queue 3;
    its features still agree, since the padding is zeros)."""
    jcfg, cfg = jnamed_config("mfcc39_48k"), named_config("mfcc39_48k")
    b = _rows(cfg)
    want = _jnp_grad(b, jcfg)
    got = _grad(b.audio, b.lengths, cfg)
    past = _past_lengths(b)
    assert not got[past].any()
    assert np.abs(want[past]).max() > 1e-2 * np.abs(want).max()  # the reference's leak
