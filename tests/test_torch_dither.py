"""The port's dither contract (`mfcc_tpu_torch/ops/dither.py`) ≡ the JAX
package's (`mfcc_tpu/ops/dither.py`).

Bitwise: the host seed premix `_fmix32_int`, the murmur3 finalizer (the port
hashes in int64 masked to 32 bits), the two 16-bit uniforms, `_cos2pi`
(exact float ops in one Horner order) and the numpy twins. Within 1e-6
absolute: the noise itself, where only ln and sqrt may differ by ulps. The
statistics, seed and no-row-shift tests are ports of
tests/test_kaldi_conventions.py:278-322. The CUDA kernel's copy of the cos
coefficients is held to the Python table by parsing its source.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfcc_tpu.ops import dither as jdither
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.ops import dither as tdither

NOISE_ATOL = 1e-6  # ulps of ln/sqrt on |z| < 4.9
SEEDS = (0, 3, 42, 0x9E3779B9, 2**32 - 1)
CSRC = pathlib.Path(tdither.__file__).resolve().parents[1] / "kernels" / "csrc" / "frontend.cu"


def _u32(n, seed=0):
    g = np.random.default_rng(seed)
    x = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([x, np.array([0, 1, 0xFFFF, 0x10000, 2**31, 2**32 - 1], np.uint32)])


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_premix_matches_jax(seed):
    assert tdither._fmix32_int(seed) == jdither._fmix32_int(seed)
    assert 0 <= tdither._fmix32_int(seed) < 2**32


def test_fmix32_matches_jax_bitwise():
    x = _u32(20000)
    got = tdither._fmix32(torch.as_tensor(x.astype(np.int64))).numpy()
    assert got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), jdither._fmix32_np(x))
    np.testing.assert_array_equal(got.astype(np.uint32), np.asarray(jdither._fmix32(jnp.asarray(x))))
    np.testing.assert_array_equal(tdither._fmix32_np(x), jdither._fmix32_np(x))


@pytest.mark.parametrize("m", [tdither._GOLDEN, tdither._M1, tdither._M2, 0xFFFFFFFF, 3])
def test_mul32_is_uint32_product(m):
    x = _u32(5000, seed=m & 0xFF)
    got = tdither._mul32(torch.as_tensor(x.astype(np.int64)), m).numpy()
    want = (x.astype(np.uint64) * np.uint64(m)) & np.uint64(0xFFFFFFFF)
    np.testing.assert_array_equal(got.astype(np.uint64), want)


def _hash_np(seed, rows, lanes):
    """The contract's hash h at (row, lane), from the JAX package's numpy twin."""
    with np.errstate(over="ignore"):
        kr = jdither._fmix32_np(
            (rows.astype(np.uint32) * np.uint32(jdither._GOLDEN)) ^ np.uint32(jdither._fmix32_int(seed))
        )
        return jdither._fmix32_np(kr + lanes.astype(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_and_uniforms_match_jax_bitwise(seed):
    rows = np.arange(0, 4000, 7, dtype=np.int64)[:, None]
    lanes = np.arange(160, dtype=np.int64)[None, :]
    want = _hash_np(seed, rows, lanes)
    row = torch.as_tensor(rows) & tdither._MASK
    kr = tdither._fmix32(tdither._mul32(row, tdither._GOLDEN) ^ tdither._fmix32_int(seed))
    h = tdither._fmix32((kr + torch.as_tensor(lanes)) & tdither._MASK).numpy()
    np.testing.assert_array_equal(h.astype(np.uint32), want)
    k = np.float32(1.0 / 65536.0)
    for got, half in (
        (tdither._u16_to_unit(torch.as_tensor(h >> 16)), want >> np.uint32(16)),
        (tdither._u16_to_unit(torch.as_tensor(h & 0xFFFF)), want & np.uint32(0xFFFF)),
    ):
        u = (half.astype(np.float32) + np.float32(0.5)) * k
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), u)
        assert float(u.min()) > 0.0 and float(u.max()) < 1.0


def test_cos2pi_matches_jax_bitwise():
    u = np.concatenate([
        (np.arange(65536, dtype=np.float32) + np.float32(0.5)) * np.float32(1.0 / 65536.0),
        np.array([0.0, 0.125, 0.25, 0.25000003, 0.5, 0.75, 0.99999994], np.float32),
    ])
    got = tdither._cos2pi(torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdither._cos2pi(jnp.asarray(u))))
    np.testing.assert_array_equal(got, jdither._cos2pi_np(u))
    np.testing.assert_array_equal(tdither._cos2pi_np(u), jdither._cos2pi_np(u))
    np.testing.assert_allclose(got, np.cos(2 * np.pi * u.astype(np.float64)), atol=2e-7)


def test_kernel_cos_coefficients_are_the_contract_table():
    """csrc/frontend.cu writes the float32 coefficients as hex literals."""
    src = CSRC.read_text()
    found = dict(
        (int(k), float.fromhex(v))
        for v, k in re.findall(r"(-?0x[0-9a-f.]+p[+-]\d+)f[;)].*// C2PI\[(\d)\]", src)
    )
    assert sorted(found) == list(range(7))
    for k, c in enumerate(tdither._C2PI_F32):
        assert found[k] == c, (k, found[k], c)
    np.testing.assert_array_equal(np.float32(tdither._C2PI), np.float32(jdither._C2PI))


@pytest.mark.parametrize("seed,step", [(0, 160), (42, 160), (7, 1), (2**32 - 1, 441), (3, 100)])
def test_signal_noise_matches_jax(seed, step):
    n = 30011
    got = tdither.signal_noise(seed, n, step).numpy()
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jdither.signal_noise_np(seed, n, step), rtol=0, atol=NOISE_ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jdither.signal_noise(seed, n, step)), rtol=0, atol=NOISE_ATOL
    )
    np.testing.assert_array_equal(
        tdither.signal_noise_np(seed, n, step), jdither.signal_noise_np(seed, n, step)
    )


def test_dither_field_broadcasts_like_jax():
    rows = torch.arange(37)[:, None]
    lanes = torch.arange(160)[None, :]
    got = tdither.dither_field(5, rows, lanes)
    want = np.asarray(jdither.dither_field(5, jnp.arange(37)[:, None], jnp.arange(160)[None, :]))
    assert tuple(got.shape) == (37, 160)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NOISE_ATOL)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), tdither.signal_noise(5, 37 * 160, 160).numpy())


def test_add_signal_dither_has_no_batch_term():
    cfg = T_CONFIGS["kaldi_mfcc"].replace(dither=1.0, dither_seed=9)
    g = np.random.default_rng(1)
    audio = torch.as_tensor(g.standard_normal((3, 1000)).astype(np.float32))
    out, noise = tdither.add_signal_dither(audio, cfg)
    assert noise.shape == audio.shape and noise.dtype == audio.dtype
    for i in range(3):
        assert torch.equal(noise[i], noise[0])
    assert torch.equal(out, audio + cfg.dither * noise)
    jout, jnoise = jdither.add_signal_dither(jnp.asarray(audio.numpy()), cfg)
    np.testing.assert_allclose(noise.numpy(), np.asarray(jnoise), rtol=0, atol=NOISE_ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=2 * NOISE_ATOL)


def test_dither_statistics_and_determinism():
    """Unit gaussian scaled by cfg.dither, one draw per seed (model:
    test_kaldi_conventions.py::test_dither_statistics_and_determinism)."""
    n = 16000
    z = tdither.signal_noise(7, n, 160).double().numpy()
    assert abs(z.std() - 1.0) < 0.02 and abs(z.mean()) < 0.02
    assert np.abs(z).max() < np.sqrt(-2.0 * np.log(2.0**-17)) + 1e-6  # BoxMuller16 truncation
    cfg = T_CONFIGS["kaldi_mfcc"].replace(dither=2.5, dither_seed=7)
    x = torch.zeros((1, n))
    d, _ = tdither.add_signal_dither(x, cfg)
    assert abs(float(d.std()) - 2.5) < 0.05 and abs(float(d.mean())) < 0.05
    assert torch.equal(d, tdither.add_signal_dither(x, cfg)[0])
    assert not torch.equal(d, tdither.add_signal_dither(x, cfg.replace(dither_seed=8))[0])


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_seed_golden_increment_no_row_shift(seed):
    s, t = 160, 160 * 64
    a = tdither.signal_noise(seed, t, s).numpy().reshape(-1, s)
    b = tdither.signal_noise((seed + tdither._GOLDEN) & 0xFFFFFFFF, t, s).numpy().reshape(-1, s)
    assert not np.array_equal(a, b)
    assert not np.array_equal(a[1:], b[:-1])
    assert not np.array_equal(b[1:], a[:-1])


def test_noise_is_the_transform_of_the_hash():
    """The noise is sqrt(-2 ln u1) cos(2 pi u2) of the hash's two uniforms,
    within float32 rounding of the same transform in float64."""
    seed, s, n = 11, 160, 160 * 300
    rows = np.arange(n // s, dtype=np.int64)[:, None]
    h = _hash_np(seed, rows, np.arange(s, dtype=np.int64)[None, :]).reshape(-1)
    u1 = (h >> np.uint32(16)).astype(np.float64) + 0.5
    u2 = (h & np.uint32(0xFFFF)).astype(np.float64) + 0.5
    want = np.sqrt(-2.0 * np.log(u1 / 65536.0)) * np.cos(2 * np.pi * u2 / 65536.0)
    np.testing.assert_allclose(tdither.signal_noise(seed, n, s).numpy(), want, rtol=0, atol=2e-6)
