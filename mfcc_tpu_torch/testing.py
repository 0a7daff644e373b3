"""Tolerance gates of the port, shared by its tests and `chip_smoke.py`.

Kernel ≡ plain version on the [log-mel | energy] prefix: both fp32, only the
summation order differs, so the gates are those of
tests/test_pallas_kernels.py::test_kernel_matches_jnp_twin — log-mel within
2e-5 on loud bins (within 40 dB of the row max), linear-domain 1e-5 of the
row max on every bin, energy within 1e-5 relative. Features: lifted cepstra
within 5e-4 absolute plus 1e-5 relative (the ×12 lifter amplifies fp32
roundoff; docs/ACCURACY.md). Each log-mel lane is taken to a natural log
before the gates (`log_kind`: "db" is x·ln10/10, "log10_floor" x·ln10;
"ln", "ln_stab" and "ln_floor" are natural logs already), so the gates mean
the same for every epilogue of the kernel.

Kaldi family (kaldi_mfcc, kaldi_fbank; docs/ACCURACY.md finding 5): the
`ln_floor` log of quiet bins near the float32-eps floor is fp32-order noise
that no fp32 implementation controls, so features are gated on
well-conditioned signals only, at 5e-4 (mfcc cepstra) or 1e-4 (fbank
log-mel), rtol 1e-5 (tests/test_kaldi_conventions.py::test_kaldi_fp32_gate),
and quiet bins take the two-regime log-mel gate of
tests/test_jnp_chain.py::assert_logmel_close: 1e-4 on bins within 40 dB of
the row max, linear-domain 1e-5 of the row max below that. logmel80's
`ln_stab` features take the same two-regime gate (finding 4).

Resampling (ops/resample.py, kernels/resample.py):
  - float64 vs scipy resample_poly and vs the JAX package under x64: 1e-12
    (only roundoff of the same taps remains);
  - float32 vs scipy at unit-normal scale: 1e-5 (tests/test_resample.py);
  - the polyphase kernel vs its plain version: 1e-5 of the row's max |x|
    (both fp32; only the order of the ~60-tap sums differs).
Narrow filters: a filter with at most NARROW_WEIGHTS nonzero weights sums
one or two power bins, so its log lane carries a single bin's fp32 roundoff,
as a spectrogram's lane does. whisper80's Slaney filters at n_fft 400 are
narrow on 34 of 80 lanes: on the H100 the kernel read 2.11e-5 from the
float64 plain version on such a loud lane at b16 × 30 s (the fp32 plain
version 2.5e-5 from the kernel), over the 2e-5 of a filter sum. Where a
caller passes the narrow lanes (`narrow_lanes`), they take the
spectrogram's per-bin gate, 1e-4 on loud bins ("narrow_loud_max_abs"),
and every other lane keeps 2e-5; the linear-domain gate holds on all.
The fused resample of the front-end kernel is held to the prefix gates
above. Resampled features (mfcc39_48k, mfcc39_44k) vs the goldens, the JAX
package and across devices: atol 8e-4, rtol 2e-5, the JAX package's
re-scoped gate for this family (fp32 resample sums move its CPU floor from
4.1e-4 to 6.8e-4; tests/test_resample.py::test_mfcc39_48k_end_to_end,
docs/ACCURACY.md). The float64 chain vs the JAX package under x64: 1e-10.

The PLP, spectrogram and SSC families (`features`), gated as the JAX
package's tests gate them:
  - prefix: PLP's raw mel lanes in the linear domain, 1e-5 of the row max,
    lane M as energy; the spectrogram's log power lanes (`ln_floor`) under
    the two-regime gate, 1e-4 on bins within 40 dB of the row max and 1e-5
    of the row max in the linear domain (a single bin has no filter's sum
    to average its fp32 roundoff: the plain version and the Pallas kernel
    differ by 2.8e-5 on loud bins of the golden signals); SSC centroids (Hz)
    within rtol 1e-4, atol 5e-3 (tests/test_ssc.py, kernel vs twin), lane M
    (0) as energy;
  - kaldi_plp features: rtol 1e-4, atol 2e-4 between fp32 chains, 2e-3 /
    1e-3 on the goldens, whose tones leave Durbin ill-conditioned
    (tests/test_plp.py); fp32 vs the float64 oracle 5e-4 / 1e-4;
  - kaldi_spectrogram features: lane 0 (the log frame energy) 2e-3 / 2e-3
    between fp32 chains (kernel vs twin), 2e-4 / 1e-3 against the float64
    oracle; the log power lanes under the two-regime gate, since a bin
    1e-10 below its row's max is fp32 noise in any implementation (the CPU
    fp32 chain is 4.0e-3 from float64 on one such bin of 4.1 M, white noise
    at b16 × 10 s); the goldens, all lanes at 2e-4 / 1e-3
    (tests/test_spectrogram.py);
  - ssc26 features: rtol 1e-4, atol 5e-3 between fp32 chains; rtol 2e-5,
    atol 2e-2 against the float64 oracle and the goldens.

The feature tail (kernels/tail.py) against its plain version:
max(2e-4, 2e-5·max|f|) absolute (tests/test_pallas_kernels.py::
test_fused_tail_matches_twin), masks equal, pad rows exactly 0. Utterance
CMVN with variance normalization divides each column by sd = √(var + eps)
(eps 1e-8): in a column that is constant or nearly so over an utterance (a
zero row, a tone whose period divides the hop) the fp32 rounding of the mean,
which differs between the kernel's and torch's order of sums, is amplified by
up to 1/√eps = 1e4. There the difference is multiplied by min(1, sd) of the
plain version's column (`cmvn_column_scale`) before the same gate: it is held
in the units of the features before the division.

The bf16x3 DFT route (three bf16 products, an opt-in of its own accuracy
class): its kernel against its plain version and both against float64 on
loud log-mel bins, 1e-3 (BF16X3_LOUD_ATOL; the reference's class,
tests/test_pallas_kernels.py::test_bf16x3_path_runs_and_is_close): a sample
that the two compute an ulp apart (a conditioned or dithered frame) can
round to another bf16 hi, so the two sums differ at the route's 2^-16 class
and not at fp32's; the linear-domain and energy gates stay as above.

whisper80 (tests/test_librosa_whisper.py): features are (log10 + 4) / 4
after the max-8 clamp, so 1e-5 is ~4e-5 log10 units. fp32 against the
float64 oracle on short signals: 1e-5 (:150-168); fp32 against fp32 (the
kernel against the plain chain, the Pallas kernel against the jnp twin)
and against the goldens: 5e-5 (:222-235, :299-316: a quiet bin at the
clamp boundary lands on either side by fp32 rounding, and the clamp bounds
the error). Both rtol 0. A bin far below its utterance's max is fp32
noise in any implementation: on the chirp golden, filter 0 of frame 4 lies
7.8 decades below the max, where torch's CPU float32 rfft is 5e-4 off in
power (the JAX package's 2e-6), so it reads 5.6e-5. Such signals take the
two-regime whisper gate (`whisper_feature_errors`): 5e-5 on bins within 40 dB
of the utterance's max, and every bin's power within 1e-5 of that max.
"""

from __future__ import annotations

import numpy as np

LOGMEL_LOUD_ATOL = 2e-5
LOUD_REL = 1e-4  # a bin is loud above this fraction of its row's max
LINEAR_REL_ROWMAX = 1e-5
ENERGY_RTOL = 1e-5
FEATURE_ATOL = 5e-4
FEATURE_RTOL = 1e-5
FEATURE_F64_ATOL = 1e-10
RESAMPLE_F64_ATOL = 1e-12
RESAMPLE_F32_ATOL = 1e-5
RESAMPLE_KERNEL_REL_ROWMAX = 1e-5
RESAMPLED_FEATURE_ATOL = 8e-4
RESAMPLED_FEATURE_RTOL = 2e-5
KALDI_MFCC_ATOL = 5e-4
KALDI_FBANK_ATOL = 1e-4
KALDI_RTOL = 1e-5
NARROW_WEIGHTS = 2  # a filter with at most this many nonzero weights is narrow
LOGMEL_ATOL = 1e-4  # two-regime log-mel gate: loud bins ...
LOUD_DB = 40.0  # ... within 40 dB of the row max
QUIET_REL_ROWMAX = 1e-5  # ... and every bin in the linear domain
SSC_ATOL, SSC_RTOL = 5e-3, 1e-4  # centroids (Hz), fp32 vs fp32
SSC_ORACLE_ATOL, SSC_ORACLE_RTOL = 2e-2, 2e-5  # centroids vs float64 and the goldens
WHISPER_ORACLE_ATOL = 1e-5  # whisper80 features, fp32 vs float64
WHISPER_ATOL = 5e-5  # whisper80 features, fp32 vs fp32 and vs the goldens
TAIL_ATOL, TAIL_REL = 2e-4, 2e-5  # the feature tail vs its plain version: max(atol, rel·max|f|)
BF16X3_LOUD_ATOL = 1e-3  # the bf16x3 route's loud log-mel bins
# features: (atol, rtol) between fp32 chains, against the goldens, and fp32
# against float64 (mfcc_tpu_torch/testing.py docstring)
FAMILY_GATES = {
    "plp": {"fp32": (2e-4, 1e-4), "golden": (2e-3, 1e-3), "float64": (5e-4, 1e-4)},
    "spectrogram": {"fp32": (2e-3, 2e-3), "golden": (2e-4, 1e-3), "float64": (2e-4, 1e-3)},
    "ssc": {"fp32": (SSC_ATOL, SSC_RTOL), "golden": (SSC_ORACLE_ATOL, SSC_ORACLE_RTOL),
            "float64": (SSC_ORACLE_ATOL, SSC_ORACLE_RTOL)},
}


def _f64(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        x = x.detach().double().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def natural_log(x, log_kind: str) -> np.ndarray:
    """Log-mel lanes of the kernel's `log_kind` as natural logs."""
    x = _f64(x)
    if log_kind == "db":
        return x * (np.log(10.0) / 10.0)
    if log_kind == "log10_floor":
        return x * np.log(10.0)
    if log_kind in ("ln", "ln_stab", "ln_floor"):
        return x
    raise ValueError(f"no prefix gate for log_kind={log_kind!r}")


def narrow_lanes(mel) -> np.ndarray:
    """[M] bool: the filters of mel [n_bins, M] with at most NARROW_WEIGHTS
    nonzero weights."""
    return (_f64(mel) != 0).sum(axis=0) <= NARROW_WEIGHTS


def prefix_errors(
    got, want, n_mels: int, log_kind: str = "ln", features: str = "logmel", narrow=None
) -> dict[str, float]:
    """Measured errors of a [..., n_mels+1] prefix against a reference, by
    feature family: log lanes (mfcc, logmel, spectrogram) taken to natural
    logs first, PLP's raw mel lanes in the linear domain, SSC centroids in
    Hz. "max_abs" is the largest |got - want| over lanes [0, n_mels), in
    natural-log units for the log families. `narrow` ([n_mels] bool, from
    `narrow_lanes`) reports the loud-bin error of those lanes apart, as
    "narrow_loud_max_abs"."""
    got, want = _f64(got), _f64(want)
    e_g, e_w = got[..., n_mels], want[..., n_mels]
    energy = float((np.abs(e_g - e_w) / np.maximum(np.abs(e_w), 1e-12)).max(initial=0.0))
    g, w = got[..., :n_mels], want[..., :n_mels]
    if features == "ssc":
        d = np.abs(g - w)
        return {
            "max_abs": float(d.max(initial=0.0)),
            "centroid_excess": float((d - SSC_RTOL * np.abs(w)).max(initial=0.0)),
            "energy_max_rel": energy,
        }
    if features == "plp":
        lin_g, lin_w = g, w
        lanes_g, lanes_w = g, w
    else:
        lanes_g, lanes_w = natural_log(g, log_kind), natural_log(w, log_kind)
        lin_g, lin_w = np.exp(lanes_g), np.exp(lanes_w)
    rowmax = np.abs(lin_w).max(axis=-1, keepdims=True, initial=0.0) + 1e-300
    errs = {
        "max_abs": float(np.abs(lanes_g - lanes_w).max(initial=0.0)),
        "linear_rel_rowmax": float((np.abs(lin_g - lin_w) / rowmax).max(initial=0.0)),
        "energy_max_rel": energy,
    }
    if features != "plp":
        loud = np.abs(lanes_g - lanes_w) * (lin_w > rowmax * LOUD_REL)
        key = "log_pspec_loud_max_abs" if features == "spectrogram" else "logmel_loud_max_abs"
        if narrow is not None and features != "spectrogram":
            narrow = np.asarray(narrow, bool)
            errs["narrow_loud_max_abs"] = float(loud[..., narrow].max(initial=0.0))
            loud = loud[..., ~narrow]
        errs[key] = float(loud.max(initial=0.0))
    return errs


PREFIX_GATES = {
    "logmel_loud_max_abs": LOGMEL_LOUD_ATOL,
    "log_pspec_loud_max_abs": LOGMEL_ATOL,
    "narrow_loud_max_abs": LOGMEL_ATOL,
    "linear_rel_rowmax": LINEAR_REL_ROWMAX,
    "energy_max_rel": ENERGY_RTOL,
    "centroid_excess": SSC_ATOL,
}


def prefix_failures(errs: dict[str, float], loud_atol: float | None = None) -> list[str]:
    """The gates `errs` (from prefix_errors) breaks; empty when it passes.
    `loud_atol` replaces the loud log-mel gate (BF16X3_LOUD_ATOL for the
    bf16x3 route)."""
    gates = dict(PREFIX_GATES)
    if loud_atol is not None:
        gates["logmel_loud_max_abs"] = loud_atol
    return [f"{k} {errs[k]:.3e} >= {gate}" for k, gate in gates.items()
            if k in errs and not errs[k] < gate]


def assert_prefix_close(
    got, want, n_mels: int, log_kind: str = "ln", features: str = "logmel", narrow=None
) -> None:
    failures = prefix_failures(prefix_errors(got, want, n_mels, log_kind, features, narrow))
    if failures:
        raise AssertionError("prefix outside the gates: " + "; ".join(failures))


def logmel_errors(got, want, log_kind: str = "ln") -> dict[str, float]:
    """Measured errors of log-mel features [..., M] under the two-regime
    gate: the loud-bin log error and the linear error relative to the row
    max, both after taking the lanes to natural logs."""
    lm_g, lm_w = natural_log(got, log_kind), natural_log(want, log_kind)
    lin_g, lin_w = np.exp(lm_g), np.exp(lm_w)
    rowmax = lin_w.max(axis=-1, keepdims=True, initial=0.0) + 1e-300
    loud = lin_w > rowmax * 10 ** (-LOUD_DB / 10.0)
    return {
        "logmel_loud_max_abs": float((np.abs(lm_g - lm_w) * loud).max(initial=0.0)),
        "linear_rel_rowmax": float((np.abs(lin_g - lin_w) / rowmax).max(initial=0.0)),
    }


def logmel_failures(errs: dict[str, float]) -> list[str]:
    gates = (("logmel_loud_max_abs", LOGMEL_ATOL), ("linear_rel_rowmax", QUIET_REL_ROWMAX))
    return [f"{k} {errs[k]:.3e} > {gate}" for k, gate in gates if not errs[k] <= gate]


def assert_logmel_close(got, want, log_kind: str = "ln") -> None:
    """The two-regime log-mel gate (logmel80, kaldi_fbank quiet bins)."""
    failures = logmel_failures(logmel_errors(got, want, log_kind))
    if failures:
        raise AssertionError("log-mel outside the gates: " + "; ".join(failures))


def kaldi_feature_atol(cfg) -> float:
    """The Kaldi family's feature gate: 5e-4 for cepstra, 1e-4 for fbank."""
    return KALDI_FBANK_ATOL if cfg.features == "logmel" else KALDI_MFCC_ATOL


def assert_kaldi_features_close(got, want, cfg) -> None:
    """Kaldi features on a well-conditioned signal (finding 5)."""
    np.testing.assert_allclose(
        _f64(got), _f64(want), atol=kaldi_feature_atol(cfg), rtol=KALDI_RTOL
    )


def assert_features_close(got, want) -> None:
    np.testing.assert_allclose(
        _f64(got), _f64(want), atol=FEATURE_ATOL, rtol=FEATURE_RTOL
    )


def resample_error(got, want, x) -> float:
    """max |got - want| over each row, relative to the row's max |x| (the
    resampler's input); the kernel-vs-plain measure."""
    got, want, x = _f64(got), _f64(want), _f64(x)
    rowmax = np.abs(x).reshape(-1, x.shape[-1]).max(axis=-1) + 1e-300
    err = np.abs(got - want).reshape(-1, got.shape[-1]).max(axis=-1, initial=0.0)
    return float((err / rowmax).max(initial=0.0))


def family_feature_errors(got, want, features: str, against: str = "fp32") -> dict[str, float]:
    """Measured errors of PLP, spectrogram or SSC features against a
    reference (`against` one of "fp32", "golden", "float64"):
    "excess" = max(|got - want| - rtol·|want|), to hold to FAMILY_GATES'
    atol; for a spectrogram outside the goldens, lane 0 only, its log power
    lanes under the two-regime log-mel gate."""
    _, rtol = FAMILY_GATES[features][against]
    g, w = _f64(got), _f64(want)
    errs = {}
    if features == "spectrogram" and against != "golden":
        errs = logmel_errors(g[..., 1:], w[..., 1:], "ln_floor")
        g, w = g[..., :1], w[..., :1]
    d = np.abs(g - w)
    errs["max_abs"] = float(d.max(initial=0.0))
    errs["excess"] = float((d - rtol * np.abs(w)).max(initial=0.0))
    return errs


def family_feature_failures(errs: dict[str, float], features: str, against: str = "fp32") -> list[str]:
    atol, rtol = FAMILY_GATES[features][against]
    fails = [] if errs["excess"] <= atol else [
        f"max(|diff| - {rtol}|want|) {errs['excess']:.3e} > {atol}"]
    return fails + (logmel_failures(errs) if "logmel_loud_max_abs" in errs else [])


def assert_family_features_close(got, want, features: str, against: str = "fp32") -> None:
    """PLP, spectrogram or SSC features within the family's gate."""
    failures = family_feature_failures(family_feature_errors(got, want, features, against),
                                       features, against)
    if failures:
        raise AssertionError(f"{features} features outside the gates: " + "; ".join(failures))


def whisper_feature_errors(got, want) -> dict[str, float]:
    """Measured errors of whisper80 features [..., F, M] under the two-regime
    gate: the largest error on bins within LOUD_DB of the utterance's max,
    and the power error (10^(4x - 4)) relative to that max on every bin."""
    g, w = _f64(got), _f64(want)
    d = np.abs(g - w)
    lw = 4.0 * w - 4.0  # log10 power above the norm's clamp
    mx = lw.max(axis=(-2, -1), keepdims=True, initial=-np.inf)
    loud = lw > mx - LOUD_DB / 10.0
    lin = np.abs(10.0 ** (4.0 * g - 4.0 - mx) - 10.0 ** (lw - mx))
    return {
        "max_abs": float(d.max(initial=0.0)),
        "loud_max_abs": float((d * loud).max(initial=0.0)),
        "linear_rel_max": float(lin.max(initial=0.0)),
    }


def whisper_feature_failures(errs: dict[str, float]) -> list[str]:
    gates = (("loud_max_abs", WHISPER_ATOL), ("linear_rel_max", QUIET_REL_ROWMAX))
    return [f"{k} {errs[k]:.3e} > {gate}" for k, gate in gates if not errs[k] <= gate]


def assert_whisper_features_close(got, want, atol: float = WHISPER_ATOL) -> None:
    """whisper80 features within `atol` (WHISPER_ATOL between fp32 chains
    and against the goldens, WHISPER_ORACLE_ATOL against float64), rtol 0."""
    np.testing.assert_allclose(_f64(got), _f64(want), atol=atol, rtol=0)


def assert_resampled_features_close(got, want) -> None:
    np.testing.assert_allclose(
        _f64(got), _f64(want), atol=RESAMPLED_FEATURE_ATOL, rtol=RESAMPLED_FEATURE_RTOL
    )


def cmvn_column_scale(pre, n_valid, eps: float) -> np.ndarray:
    """[B, 1, D] min(1, √(var + eps)) of each column over each utterance's
    valid rows of the features before CMVN, pre [B, F, D] (the divisor of
    variance normalization, capped at 1)."""
    pre = _f64(pre)
    nv = np.asarray(_f64(n_valid), dtype=np.int64)
    m = (np.arange(pre.shape[1])[None, :] < nv[:, None])[..., None]
    n = np.maximum(m.sum(axis=1, keepdims=True), 1)
    mu = (pre * m).sum(axis=1, keepdims=True) / n
    var = (((pre - mu) ** 2) * m).sum(axis=1, keepdims=True) / n
    return np.minimum(1.0, np.sqrt(var + eps))


def tail_errors(got, want, scale=None) -> dict[str, float]:
    """The feature tail's errors: "max_abs" |got - want|, "held" the same
    after multiplying by `scale` (cmvn_column_scale, or 1), and "gate"
    max(TAIL_ATOL, TAIL_REL·max|want|)."""
    g, w = _f64(got), _f64(want)
    d = np.abs(g - w)
    held = d if scale is None else d * np.asarray(scale)
    return {
        "max_abs": float(d.max(initial=0.0)),
        "held": float(held.max(initial=0.0)),
        "gate": max(TAIL_ATOL, TAIL_REL * float(np.abs(w).max(initial=0.0))),
    }


def tail_failures(errs: dict[str, float]) -> list[str]:
    return [] if errs["held"] <= errs["gate"] else [
        f"tail difference {errs['held']:.3e} > {errs['gate']:.3e}"]
