"""Tolerance gates of the port, shared by its tests and `chip_smoke.py`.

Kernel ≡ plain version on the [log-mel | energy] prefix: both fp32, only the
summation order differs, so the gates are those of
tests/test_pallas_kernels.py::test_kernel_matches_jnp_twin — log-mel within
2e-5 on loud bins (within 40 dB of the row max), linear-domain 1e-5 of the
row max on every bin, energy within 1e-5 relative. Features: lifted cepstra
within 5e-4 absolute plus 1e-5 relative (the ×12 lifter amplifies fp32
roundoff; docs/ACCURACY.md).
"""

from __future__ import annotations

import numpy as np

LOGMEL_LOUD_ATOL = 2e-5
LOUD_REL = 1e-4  # a bin is loud above this fraction of its row's max
LINEAR_REL_ROWMAX = 1e-5
ENERGY_RTOL = 1e-5
FEATURE_ATOL = 5e-4
FEATURE_RTOL = 1e-5


def _f64(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        x = x.detach().double().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def prefix_errors(got, want, n_mels: int) -> dict[str, float]:
    """Measured errors of a [..., n_mels+1] prefix against a reference."""
    got, want = _f64(got), _f64(want)
    lm_g, lm_w = got[..., :n_mels], want[..., :n_mels]
    lin_g, lin_w = np.exp(lm_g), np.exp(lm_w)
    rowmax = lin_w.max(axis=-1, keepdims=True) + 1e-300
    loud = lin_w > rowmax * LOUD_REL
    e_g, e_w = got[..., n_mels], want[..., n_mels]
    return {
        "logmel_max_abs": float(np.abs(lm_g - lm_w).max()),
        "logmel_loud_max_abs": float((np.abs(lm_g - lm_w) * loud).max()),
        "linear_rel_rowmax": float((np.abs(lin_g - lin_w) / rowmax).max()),
        "energy_max_rel": float(
            (np.abs(e_g - e_w) / np.maximum(np.abs(e_w), 1e-12)).max()
        ),
    }


def prefix_failures(errs: dict[str, float]) -> list[str]:
    """The gates `errs` (from prefix_errors) breaks; empty when it passes."""
    gates = (
        ("logmel_loud_max_abs", LOGMEL_LOUD_ATOL),
        ("linear_rel_rowmax", LINEAR_REL_ROWMAX),
        ("energy_max_rel", ENERGY_RTOL),
    )
    return [f"{k} {errs[k]:.3e} >= {gate}" for k, gate in gates if not errs[k] < gate]


def assert_prefix_close(got, want, n_mels: int) -> None:
    failures = prefix_failures(prefix_errors(got, want, n_mels))
    if failures:
        raise AssertionError("prefix outside the gates: " + "; ".join(failures))


def assert_features_close(got, want) -> None:
    np.testing.assert_allclose(
        _f64(got), _f64(want), atol=FEATURE_ATOL, rtol=FEATURE_RTOL
    )
