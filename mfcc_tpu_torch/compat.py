"""Drop-in compatibility surface for the tutorial-lineage API: the port of
`mfcc_tpu/compat.py`.

The reference (Robomate/mfcc) belongs to the classic tutorial-MFCC family
whose canonical public API is James Lyons' ``python_speech_features``
(``mfcc`` / ``fbank`` / ``logfbank`` / ``ssc`` / ``delta`` plus the
``sigproc`` helpers). A user switching from it finds the entry points they
know here, with the same numerics as the JAX package's module, bit for bit.

Everything here is a thin composition of the port's float64 oracle stages
(``ops/reference_numpy.py``) and host constants (``ops/constants.py``); there
is no second implementation of the chain. The functions run in float64
numpy, on the host, per utterance.

For throughput (batched, length-masked, the CUDA kernels, data parallel)
use :func:`mfcc_tpu_torch.extract`, ``ops.chain.extract_batch`` or the CLI.
:func:`as_config` and :func:`as_kaldi_config` map keyword arguments onto the
port's :class:`~mfcc_tpu_torch.config.FrontendConfig` (the same
``config_hash`` as the JAX package's), so a compat call site moves to the
card mechanically. The package learns no weights: its constants and configs
are what carries across, and both stay identical by hash.
"""

from __future__ import annotations

import numpy as np

from mfcc_tpu_torch.config import FrontendConfig
from mfcc_tpu_torch.ops import constants as C
from mfcc_tpu_torch.ops import reference_numpy as R

__all__ = [
    "mfcc", "fbank", "logfbank", "ssc", "delta", "lifter",
    "hz2mel", "mel2hz", "get_filterbanks", "as_config", "as_kaldi_config",
    "preemphasis", "framesig", "deframesig", "magspec", "powspec",
    "logpowspec",
]

_EPS = float(np.finfo(np.float64).eps)


def _ones(n: int) -> np.ndarray:
    return np.ones((n,), dtype=np.float64)


def _frame_len_step(samplerate, winlen, winstep) -> tuple[int, int]:
    # round-half-up, matching the lineage's decimal rounding (banker's
    # rounding would differ on exact .5 sample counts)
    return (int(np.floor(winlen * samplerate + 0.5)),
            int(np.floor(winstep * samplerate + 0.5)))


# ---------------------------------------------------------------------------
# Mel scale + filterbank (lineage orientation: [nfilt, nfft//2+1])
# ---------------------------------------------------------------------------


def hz2mel(hz):
    """HTK mel scale, m = 2595 log10(1 + f/700)."""
    return C.hz_to_mel(hz)


def mel2hz(mel):
    """Inverse HTK mel scale."""
    return C.mel_to_hz(mel)


def get_filterbanks(nfilt=20, nfft=512, samplerate=16000, lowfreq=0,
                    highfreq=None):
    """Bin-quantized triangular mel filterbank, shape [nfilt, nfft//2+1].

    Same matrix as ``ops.constants.mel_filterbank_psf`` (SURVEY.md Appendix
    B #6, psf variant), transposed to the lineage's row-per-filter
    orientation so ``pspec @ fb.T`` applies it.
    """
    highfreq = samplerate / 2.0 if highfreq is None else highfreq
    return C.mel_filterbank_psf(nfilt, nfft, samplerate, lowfreq, highfreq).T


# ---------------------------------------------------------------------------
# sigproc-style helpers
# ---------------------------------------------------------------------------


def preemphasis(signal, coeff=0.95):
    """y[0] = x[0]; y[t] = x[t] - coeff*x[t-1] (oracle stage 1).

    Note the lineage's *sigproc* default is 0.95 while the feature
    functions below default to 0.97 (the reference's value, BASELINE.json).
    """
    return R.preemphasis(signal, coeff)


def framesig(sig, frame_len, frame_step, winfunc=_ones):
    """Slice a 1-D signal into overlapping frames, zero-padded ceil tail
    (oracle stage 2, ``frame_tail="pad"``), each multiplied by
    ``winfunc(frame_len)``."""
    frame_len, frame_step = int(round(frame_len)), int(round(frame_step))
    frames = R.frame_signal(sig, frame_len, frame_step, tail="pad")
    return frames * np.asarray(winfunc(frame_len), dtype=np.float64)[None, :]


def deframesig(frames, siglen, frame_len, frame_step, winfunc=_ones):
    """Overlap-add inverse of :func:`framesig`.

    Each frame is weighted by the window again and the accumulated window
    energy is divided out, so for any non-vanishing window
    ``deframesig(framesig(x, L, S, w), len(x), L, S, w) == x`` up to
    roundoff. ``siglen <= 0`` keeps the full padded length. This
    reconstruction path is new capability relative to the forward-only
    reference chain but part of the lineage API.
    """
    frames = np.asarray(frames, dtype=np.float64)
    frame_len, frame_step = int(round(frame_len)), int(round(frame_step))
    nframes = frames.shape[0]
    padlen = (nframes - 1) * frame_step + frame_len
    win = np.asarray(winfunc(frame_len), dtype=np.float64)
    rec = np.zeros(padlen)
    norm = np.zeros(padlen)
    for f in range(nframes):
        sl = slice(f * frame_step, f * frame_step + frame_len)
        rec[sl] += frames[f] * win
        norm[sl] += win * win
    rec = rec / np.where(norm == 0.0, 1.0, norm)
    return rec[:siglen] if siglen > 0 else rec


def magspec(frames, NFFT):
    """|rfft(frames, NFFT)| — magnitude spectrum, [F, NFFT//2+1]."""
    return np.abs(np.fft.rfft(np.asarray(frames, dtype=np.float64), int(NFFT)))


def powspec(frames, NFFT):
    """|rfft|^2 / NFFT — the lineage's scaled power spectrum (oracle
    stages 4-5 with ``power_scale_nfft=True``)."""
    return R.power_spectrum(frames, int(NFFT), scale_nfft=True)


def logpowspec(frames, NFFT, norm=1):
    """10*log10(powspec), floored at 1e-30; ``norm`` subtracts the max so
    the peak sits at 0 dB."""
    ps = np.maximum(powspec(frames, NFFT), 1e-30)
    lps = 10.0 * np.log10(ps)
    return lps - np.max(lps) if norm else lps


# ---------------------------------------------------------------------------
# Feature functions
# ---------------------------------------------------------------------------


def fbank(signal, samplerate=16000, winlen=0.025, winstep=0.01, nfilt=26,
          nfft=512, lowfreq=0, highfreq=None, preemph=0.97, winfunc=_ones):
    """Mel-filterbank energies.

    Returns ``(feat, energy)``: ``feat`` [F, nfilt] linear (not log) mel
    energies, zero-clamped to float64 eps; ``energy`` [F] total frame
    energy of the scaled power spectrum, identically clamped (oracle
    stage 5).
    """
    frame_len, frame_step = _frame_len_step(samplerate, winlen, winstep)
    frames = framesig(R.preemphasis(signal, preemph), frame_len, frame_step,
                      winfunc)
    pspec = powspec(frames, nfft)
    energy = R.frame_energy(pspec, _EPS)
    fb = get_filterbanks(nfilt, nfft, samplerate, lowfreq, highfreq)
    feat = pspec @ fb.T
    return np.where(feat <= 0, _EPS, feat), energy


def logfbank(signal, samplerate=16000, winlen=0.025, winstep=0.01, nfilt=26,
             nfft=512, lowfreq=0, highfreq=None, preemph=0.97,
             winfunc=_ones):
    """Natural-log mel-filterbank energies, [F, nfilt] (oracle stage 7)."""
    feat, _ = fbank(signal, samplerate, winlen, winstep, nfilt, nfft,
                    lowfreq, highfreq, preemph, winfunc)
    return np.log(feat)


def mfcc(signal, samplerate=16000, winlen=0.025, winstep=0.01, numcep=13,
         nfilt=26, nfft=512, lowfreq=0, highfreq=None, preemph=0.97,
         ceplifter=22, appendEnergy=True, winfunc=_ones):
    """13 MFCCs per frame — the reference's headline output.

    Chain: fbank -> ln -> ortho DCT-II slice to ``numcep`` -> sinusoidal
    lifter -> (optionally) c0 replaced by ln(total frame energy). Exactly
    oracle stages 7-9 (SURVEY.md Appendix B); held bitwise to the JAX
    package's by tests/test_torch_compat.py.
    """
    feat, energy = fbank(signal, samplerate, winlen, winstep, nfilt, nfft,
                         lowfreq, highfreq, preemph, winfunc)
    ceps = np.log(feat) @ C.dct_matrix(nfilt, numcep, "ortho")
    ceps = lifter(ceps, ceplifter)
    if appendEnergy:
        ceps[:, 0] = np.log(energy)
    return ceps


def ssc(signal, samplerate=16000, winlen=0.025, winstep=0.01, nfilt=26,
        nfft=512, lowfreq=0, highfreq=None, preemph=0.97, winfunc=_ones):
    """Spectral subband centroids, [F, nfilt].

    Per filter: the power-weighted mean frequency of its band,
    ``(pspec * f) @ fb.T / (pspec @ fb.T)`` with the lineage's frequency
    grid ``linspace(1, samplerate/2, nfft//2+1)``.
    """
    frame_len, frame_step = _frame_len_step(samplerate, winlen, winstep)
    frames = framesig(R.preemphasis(signal, preemph), frame_len, frame_step,
                      winfunc)
    pspec = powspec(frames, nfft)
    pspec = np.where(pspec <= 0, _EPS, pspec)
    fb = get_filterbanks(nfilt, nfft, samplerate, lowfreq, highfreq)
    freqs = np.linspace(1.0, samplerate / 2.0, pspec.shape[1])
    return (pspec * freqs[None, :]) @ fb.T / (pspec @ fb.T)


def delta(feat, N):
    """Regression delta over a +/-N frame window, edge-replicated
    (oracle stage 10)."""
    if N < 1:
        raise ValueError("N must be >= 1")
    return R.delta(np.asarray(feat, dtype=np.float64), int(N))


def lifter(cepstra, L=22):
    """Sinusoidal cepstral lifter, 1 + (L/2) sin(pi n / L); identity for
    L <= 0 (oracle stage 9)."""
    cepstra = np.array(cepstra, dtype=np.float64)
    return cepstra * C.lifter_vector(cepstra.shape[-1], L)[None, :]


# ---------------------------------------------------------------------------
# Migration helper: compat kwargs -> FrontendConfig (the batched path)
# ---------------------------------------------------------------------------

_KNOWN_WINDOWS = ("rect", "hamming_sym", "hann_sym", "hamming_periodic",
                  "hann_periodic", "blackman_sym", "blackman_periodic",
                  "povey")


def as_config(samplerate=16000, winlen=0.025, winstep=0.01, numcep=13,
              nfilt=26, nfft=512, lowfreq=0, highfreq=None, preemph=0.97,
              ceplifter=22, appendEnergy=True, winfunc=_ones,
              features="mfcc", deltas=0, cmvn="off") -> FrontendConfig:
    """Map compat keyword arguments onto a :class:`FrontendConfig`.

    ``mfcc_tpu_torch.extract(x, as_config(**kw))`` then computes the same
    features on the card. ``winfunc`` must be resolvable to
    one of the framework's window enums (it is evaluated once and compared
    against the known vectors); arbitrary callables raise ValueError —
    stay on the numpy compat functions for those.
    """
    frame_len = int(np.floor(winlen * samplerate + 0.5))
    wvec = np.asarray(winfunc(frame_len), dtype=np.float64)
    for kind in _KNOWN_WINDOWS:
        if np.allclose(wvec, C.window_vector(kind, frame_len), atol=1e-12):
            window = kind
            break
    else:
        raise ValueError(
            "winfunc does not match any framework window enum "
            f"{_KNOWN_WINDOWS}; use the numpy compat functions instead")
    return FrontendConfig(
        sample_rate=int(samplerate), win_len_s=float(winlen),
        hop_s=float(winstep), n_fft=int(nfft), window=window,
        preemph=float(preemph), n_mels=int(nfilt),
        mel_low_hz=float(lowfreq),
        mel_high_hz=None if highfreq is None else float(highfreq),
        features=features, n_ceps=int(numcep), lifter=int(ceplifter),
        append_energy=bool(appendEnergy), deltas=int(deltas), cmvn=cmvn,
    )


_KALDI_WINDOWS = {
    "povey": "povey",
    "hamming": "hamming_sym",
    "hanning": "hann_sym",
    "rectangular": "rect",
    "blackman": "blackman_sym",
}


def as_kaldi_config(
    feature_type: str = "mfcc",
    *,
    sample_frequency: float = 16000.0,
    frame_length: float = 25.0,   # milliseconds (Kaldi/torchaudio units)
    frame_shift: float = 10.0,
    window_type: str = "povey",
    blackman_coeff: float = 0.42,
    round_to_power_of_two: bool = True,
    snip_edges: bool = True,
    preemphasis_coefficient: float = 0.97,
    remove_dc_offset: bool = True,
    dither: float = 1.0,
    num_mel_bins: int = 23,
    low_freq: float = 20.0,
    high_freq: float = 0.0,       # <= 0: nyquist + high_freq (Kaldi)
    vtln_warp: float = 1.0,
    vtln_low: float = 100.0,
    vtln_high: float = -500.0,
    num_ceps: int = 13,
    cepstral_lifter: float = 22.0,
    use_energy: bool = True,
    raw_energy: bool = True,
    energy_floor: float = 0.0,
    subtract_mean: bool = False,
    htk_compat: bool = False,
    channel: int = -1,
    deltas: int = 0,
) -> FrontendConfig:
    """Map Kaldi `compute-{mfcc,fbank,plp}-feats` / `torchaudio.compliance
    .kaldi` flag names onto a :class:`FrontendConfig` (the migration bridge
    for the Kaldi convention lineage; the JAX package certifies its
    semantics in tests/test_kaldi_conventions.py and tests/test_plp.py).

    Defaults are the KALDI BINARY defaults (note `use_energy=True` and
    `dither=1.0` — torchaudio's wrappers default some of these
    differently; pass your call site's values explicitly when migrating
    from torchaudio). `subtract_mean=True` maps to mean-only utterance
    CMVN. Unsupported-by-design flags raise: `htk_compat` (reorders and
    rescales the energy coefficient) and non-default `blackman_coeff`
    (the framework ships the standard 0.42 Blackman only).
    """
    if feature_type not in ("mfcc", "fbank", "plp"):
        raise ValueError(f"feature_type {feature_type!r}")
    if htk_compat:
        raise ValueError("htk_compat=True is not supported")
    if window_type not in _KALDI_WINDOWS:
        raise ValueError(
            f"window_type {window_type!r}; known: {sorted(_KALDI_WINDOWS)}"
        )
    if window_type == "blackman" and abs(blackman_coeff - 0.42) > 1e-12:
        raise ValueError("only the standard blackman_coeff=0.42 is supported")
    if channel not in (-1, 0):
        raise ValueError(
            "channel selection happens at decode time (downmix='first'); "
            "only channel in (-1, 0) maps"
        )
    sr = int(sample_frequency)
    # Kaldi TRUNCATES when converting ms to samples (FrameExtractionOptions
    # ::WindowSize/WindowShift: static_cast<int32>(samp_freq * 0.001 * ms)).
    # FrontendConfig rounds win_len_s*sr, so derive the second-unit values
    # FROM the truncated sample counts — at e.g. 11025 Hz / 25 ms Kaldi
    # uses 275 samples where naive rounding gives 276.
    frame_samples = int(sr * 0.001 * frame_length)
    hop_samples = int(sr * 0.001 * frame_shift)
    if frame_samples < 1 or hop_samples < 1:
        raise ValueError("frame_length/frame_shift too small for this rate")
    if round_to_power_of_two:
        n_fft = 1
        while n_fft < frame_samples:
            n_fft *= 2
    else:
        n_fft = frame_samples
    kw = dict(
        sample_rate=sr,
        win_len_s=frame_samples / sr,
        hop_s=hop_samples / sr,
        n_fft=int(n_fft),
        window=_KALDI_WINDOWS[window_type],
        frame_tail="drop" if snip_edges else "center",
        preemph=float(preemphasis_coefficient),
        preemph_mode="frame",
        remove_dc_offset=bool(remove_dc_offset),
        dither=float(dither),
        n_mels=int(num_mel_bins),
        mel_variant="tf_continuous",
        mel_low_hz=float(low_freq),
        mel_high_hz=(
            None if high_freq == 0.0
            else (sr / 2.0 + high_freq if high_freq < 0 else float(high_freq))
        ),
        vtln_warp=float(vtln_warp),
        vtln_low_hz=float(vtln_low),
        vtln_high_hz=float(vtln_high),
        power_scale_nfft=False,
        log_eps=1.1920928955078125e-07,  # FLT_EPSILON (Kaldi's floor)
        energy_floor=float(energy_floor),
        deltas=int(deltas),
        cmvn="utterance" if subtract_mean else "off",
    )
    if subtract_mean:
        kw["cmvn_var_norm"] = False  # Kaldi subtract_mean is mean-only
    if feature_type == "mfcc":
        kw.update(
            features="mfcc",
            log_kind="ln_floor",
            n_ceps=int(num_ceps),
            lifter=int(cepstral_lifter),
            append_energy=bool(use_energy),
            energy_source="raw_frame" if raw_energy else "windowed_frame",
        )
    elif feature_type == "plp":
        kw.update(
            features="plp",
            n_ceps=int(num_ceps),
            lifter=int(cepstral_lifter),
            append_energy=bool(use_energy),
            energy_source="raw_frame" if raw_energy else "windowed_frame",
        )
    else:  # fbank
        kw.update(
            features="logmel",
            log_kind="ln_floor",
            append_energy=False,
            lifter=0,
        )
        if use_energy:
            raise ValueError(
                "fbank use_energy=True (energy column prepended to the "
                "bins) is not mapped; extract mfcc with use_energy or "
                "post-process"
            )
    return FrontendConfig(**kw)
