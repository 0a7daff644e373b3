"""FrontendConfig — the single frozen config object for the whole chain.

The port's own copy of `mfcc_tpu/config.py`: the same fields, defaults and
named configs, so `config_hash()` gives the same hex for the same config
(held against the JAX package in tests/test_torch_config.py).

Every knob in SURVEY.md Appendix C (the convention matrix) is an explicit
enum here, because the 1e-4 acceptance gate lives or dies on these
conventions (e.g. the psf-quantized vs TF-continuous mel matrices differ by
0.24 elementwise — SURVEY.md Appendix A).

The config is hashable and is passed as a static argument to jitted
functions; all derived constants (frame length, filterbank matrix, DCT
matrix, window, lifter) are computed on host in float64 and cast once.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from dataclasses import dataclass
from typing import Optional

# ---------------------------------------------------------------------------
# Enum values (strings keep the dataclass trivially hashable/serializable).
# ---------------------------------------------------------------------------

WINDOWS = ("hamming_sym", "hamming_periodic", "hann_sym", "hann_periodic",
           "blackman_sym", "blackman_periodic", "povey", "rect")
MEL_VARIANTS = ("psf_quantized", "tf_continuous", "librosa_hz")
MEL_SCALES = ("htk", "slaney")  # htk ~ kaldi: 2595*log10 vs 1127*ln, ~9e-6 rel
MEL_NORMS = ("none", "slaney")  # slaney: 2/bandwidth area normalization
LOG_KINDS = ("ln", "ln_stab", "db", "ln_floor", "log10_floor")
LOGMEL_NORMS = ("none", "whisper")  # whisper: max-8 clamp then (x+4)/4
DCT_NORMS = ("ortho", "htk")
FRAME_TAILS = ("pad", "drop", "center", "center_reflect")
CMVN_MODES = ("off", "utterance", "global", "speaker")
FEATURES = ("mfcc", "logmel", "ssc", "plp", "spectrogram")
PREEMPH_MODES = ("signal", "frame")
ENERGY_SOURCES = ("pspec", "raw_frame", "windowed_frame")


@dataclass(frozen=True)
class FrontendConfig:
    """Complete specification of one feature-extraction chain.

    Defaults are the psf/tutorial lineage the reference belongs to
    (SURVEY.md Appendix C, column 2): 16 kHz, 25 ms / 10 ms frames, 512-pt
    FFT, 26 mel bins, 13 cepstra, preemph 0.97, symmetric Hamming window,
    bin-quantized mel triangles, natural log, ortho DCT, lifter 22, c0
    replaced by log frame energy.
    """

    # signal
    sample_rate: int = 16000
    input_sample_rate: Optional[int] = None  # if set != sample_rate: resample
    input_scale: float = 1.0  # gain applied to the audio before any stage.
    # The framework's canonical scale is RAW int16 (float wavs are scaled
    # x32768 by the decoder — the psf/Kaldi convention); lineages that
    # define features on [-1, 1) audio (librosa/Whisper) set 1/32768 so
    # file-based extraction matches their pipelines bit-for-bit. Array
    # inputs are expected in int16 scale under such configs.
    # framing
    win_len_s: float = 0.025
    hop_s: float = 0.010
    frame_tail: str = "pad"  # "pad": F = 1+ceil((N-L)/S), zero-pad;
    # "drop": 1+(N-L)//S (Kaldi snip_edges=true); "center": F = (N+S//2)//S,
    # frame f centered at f*S + S/2 with edge reflection (snip_edges=false);
    # "center_reflect": F = 1 + N//S, frame f centered at f*S, numpy-style
    # reflect padding excluding the edge sample (librosa/torch.stft
    # center=True pad_mode="reflect" — the Whisper front-end convention)
    drop_last_frame: bool = False  # drop the final frame (F -= 1) AFTER the
    # frame_tail count — the HF/OpenAI Whisper log_spec[:, :-1] quirk
    # spectrum
    n_fft: int = 512
    power_scale_nfft: bool = True  # True: |X|^2/NFFT (psf); False: |X|^2 (TF kernel)
    window: str = "hamming_sym"
    preemph: float = 0.97
    preemph_mode: str = "signal"  # "signal": y[t]=x[t]-c*x[t-1] on the whole
    # signal before framing (psf lineage); "frame": per extracted frame,
    # w[0] *= (1-c) (Kaldi feature-window ProcessWindow order)
    # frame-first conditioning (Kaldi feature-window lineage; all default off)
    dither: float = 0.0  # gaussian noise stddev, SIGNAL-level: one draw per
    # absolute sample position (shared across overlapping frames) — a
    # deliberate deviation from Kaldi's per-frame redraw; see ops/dither.py
    dither_seed: int = 0  # PRNG seed for on-device dither (deterministic)
    remove_dc_offset: bool = False  # subtract each frame's mean (post-dither)
    # mel
    n_mels: int = 26
    mel_variant: str = "psf_quantized"  # triangle construction: psf
    # bin-quantized; "tf_continuous": mel-domain slopes, DC excluded (TF /
    # Kaldi); "librosa_hz": Hz-domain slopes on the linspace bin grid
    # (librosa / HF transformers / torchaudio lineage)
    mel_scale: str = "htk"  # "htk": 2595*log10(1+f/700) (~ Kaldi's 1127*ln);
    # "slaney": linear below 1 kHz, log above (librosa/Slaney default)
    mel_norm: str = "none"  # "slaney": scale each triangle by 2/bandwidth
    # (approx. constant energy per channel — librosa norm="slaney")
    mel_low_hz: float = 0.0
    mel_high_hz: Optional[float] = None  # None -> sample_rate / 2
    # VTLN (vocal tract length normalization) — Kaldi-style piecewise-linear
    # frequency warp of the continuous-triangle filterbank edges; 1.0 = off.
    # Only meaningful with mel_variant="tf_continuous" (the Kaldi mel-bank
    # algebra; see ops/constants.py vtln_warp_freq).
    vtln_warp: float = 1.0
    vtln_low_hz: float = 100.0
    vtln_high_hz: float = -500.0  # <= 0 means nyquist + vtln_high_hz (Kaldi)
    # log
    log_kind: str = "ln"  # "ln": ln(max(x, eps)); "ln_stab": ln(x + 1e-6);
    # "db": 10*log10; "ln_floor": ln(max(x, eps)) flooring tiny positives
    # too (Kaldi); "log10_floor": log10(max(x, eps)) (librosa/Whisper)
    log_eps: float = 2.220446049250313e-16  # np.finfo(float64).eps — psf clamp
    logmel_norm: str = "none"  # features="logmel" post-normalization:
    # "whisper": x = max(x, max_valid(x) - 8); (x + 4) / 4 — the per-
    # utterance dynamic-range compression of the Whisper front-end
    # cepstra
    features: str = "mfcc"  # "mfcc": DCT to n_ceps; "logmel": stop after log;
    # "ssc": spectral subband centroids (power-weighted mean frequency per
    # mel band, psf lineage) — log/DCT/lifter/energy knobs are unused;
    # "plp": perceptual linear prediction (Kaldi compute-plp-feats
    # lineage): equal-loudness × mel energies → compress_factor power →
    # IDFT to autocorrelation → order-lpc_order Levinson-Durbin →
    # LPC-cepstra; c0 = residual log energy (or ln E with append_energy);
    # lifter applies; log/DCT knobs are unused
    # "spectrogram": log power spectrum per FFT bin (Kaldi
    # compute-spectrogram-feats lineage): the filterbank is the identity
    # (requires n_mels == n_bins), log applies per bin, and with
    # append_energy feature[0] is replaced by the log frame energy
    # exactly like Kaldi; mel/DCT/lifter knobs are unused
    lpc_order: int = 12  # PLP linear-prediction order
    compress_factor: float = 1.0 / 3.0  # PLP intensity-loudness power law
    n_ceps: int = 13
    dct_norm: str = "ortho"  # "ortho": scipy ortho; "htk": ortho with bin0 * sqrt(2)
    lifter: int = 22  # 0 disables
    append_energy: bool = True  # replace c0 with ln(E)
    energy_source: str = "pspec"  # "pspec": E = sum_k P[f,k] (psf lineage);
    # "raw_frame": E = sum_n frame[n]^2 after dither/DC-removal but BEFORE
    # pre-emphasis and windowing (Kaldi raw_energy=true); "windowed_frame":
    # E = sum_n windowed[n]^2 after both (Kaldi raw_energy=false)
    energy_floor: float = 0.0  # if > 0: ln(E) floored at ln(energy_floor)
    # dynamics
    deltas: int = 0  # 0: none, 1: +delta, 2: +delta+deltadelta
    delta_window: int = 2
    # normalization
    cmvn: str = "off"  # off | utterance | global
    cmvn_var_norm: bool = True
    cmvn_eps: float = 1e-8  # inside sqrt(var + eps)
    # compute
    dtype: str = "float32"  # on-device dtype; oracle is always float64

    def __post_init__(self) -> None:
        checks = [
            (self.window, WINDOWS, "window"),
            (self.mel_variant, MEL_VARIANTS, "mel_variant"),
            (self.log_kind, LOG_KINDS, "log_kind"),
            (self.dct_norm, DCT_NORMS, "dct_norm"),
            (self.frame_tail, FRAME_TAILS, "frame_tail"),
            (self.cmvn, CMVN_MODES, "cmvn"),
            (self.features, FEATURES, "features"),
            (self.preemph_mode, PREEMPH_MODES, "preemph_mode"),
            (self.energy_source, ENERGY_SOURCES, "energy_source"),
            (self.mel_scale, MEL_SCALES, "mel_scale"),
            (self.mel_norm, MEL_NORMS, "mel_norm"),
            (self.logmel_norm, LOGMEL_NORMS, "logmel_norm"),
        ]
        for val, allowed, name in checks:
            if val not in allowed:
                raise ValueError(f"{name}={val!r} not in {allowed}")
        if self.deltas not in (0, 1, 2):
            raise ValueError(f"deltas={self.deltas} must be 0, 1 or 2")
        if self.n_ceps > self.n_mels:
            raise ValueError("n_ceps must be <= n_mels")
        if self.features == "plp":
            if self.n_ceps > self.lpc_order + 1:
                raise ValueError(
                    "PLP yields lpc_order cepstra plus the residual-energy "
                    f"c0: need n_ceps <= lpc_order + 1, got {self.n_ceps} > "
                    f"{self.lpc_order + 1}"
                )
            if self.lpc_order < 1:
                raise ValueError("lpc_order must be >= 1")
        if self.features == "spectrogram" and self.n_mels != self.n_bins:
            raise ValueError(
                "features='spectrogram' outputs one lane per FFT bin: set "
                f"n_mels == n_bins ({self.n_bins} for n_fft={self.n_fft}), "
                f"got n_mels={self.n_mels}"
            )
        if self.dither < 0:
            raise ValueError("dither must be >= 0")
        if self.vtln_warp != 1.0 and self.mel_variant != "tf_continuous":
            raise ValueError(
                "vtln_warp requires mel_variant='tf_continuous' (the "
                "continuous-triangle filterbank the Kaldi warp is defined on)"
            )
        if self.logmel_norm != "none" and self.features != "logmel":
            raise ValueError(
                "logmel_norm normalizes the final log-mel features; it "
                "requires features='logmel'"
            )

    # -- derived constants (host-side, python ints) --------------------------

    @property
    def frame_length(self) -> int:
        """Samples per analysis frame (400 at 16 kHz / 25 ms)."""
        return int(round(self.win_len_s * self.sample_rate))

    @property
    def frame_step(self) -> int:
        """Hop in samples (160 at 16 kHz / 10 ms)."""
        return int(round(self.hop_s * self.sample_rate))

    @property
    def n_bins(self) -> int:
        """Real-FFT bin count: n_fft // 2 + 1 (257 for 512)."""
        return self.n_fft // 2 + 1

    @property
    def mel_high(self) -> float:
        return self.sample_rate / 2.0 if self.mel_high_hz is None else self.mel_high_hz

    @property
    def feat_dim(self) -> int:
        """Output feature dimension after deltas are stacked."""
        base = self.n_ceps if self.features in ("mfcc", "plp") else self.n_mels
        return base * (1 + self.deltas)

    def num_frames(self, n_samples: int) -> int:
        """Frame count for an utterance of n_samples (SURVEY.md Appendix B #2;
        "center" is Kaldi's snip_edges=false count, "center_reflect" the
        librosa/torch center=True count)."""
        L, S = self.frame_length, self.frame_step
        if self.frame_tail == "pad":
            n = 1 + math.ceil(max(0, n_samples - L) / S)
        elif self.frame_tail == "center":
            n = (n_samples + S // 2) // S
        elif self.frame_tail == "center_reflect":
            # pad L//2 both sides, then 1 + (N + 2*(L//2) - L) // S
            n = 1 + (n_samples + 2 * (L // 2) - L) // S if n_samples > 0 else 0
        else:
            n = max(0, 1 + (n_samples - L) // S) if n_samples >= L else 0
        if self.drop_last_frame:
            n = max(0, n - 1)
        return n

    def padded_length(self, num_frames: int) -> int:
        """Sample count the signal is zero-padded to for `num_frames` frames."""
        return (num_frames - 1) * self.frame_step + self.frame_length

    def config_hash(self) -> str:
        """Stable hash used in output manifests for resume-safety."""
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def replace(self, **kw) -> "FrontendConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Named configs — the five BASELINE.json scenarios.
# ---------------------------------------------------------------------------

NAMED_CONFIGS: dict[str, FrontendConfig] = {
    # BASELINE config #1: single 16 kHz wav -> 13 MFCCs.
    "classic13": FrontendConfig(),
    # BASELINE config #2: batch-64, 13 MFCCs + deltas (39-dim), per-utt CMVN.
    "classic13_deltas": FrontendConfig(deltas=2),
    # Spectral subband centroids (psf tutorial-family ssc): 26 centroids,
    # classic conventions; kernel-resident since r4 (second positive matmul
    # against the freq-weighted mel matrix).
    "ssc26": FrontendConfig(features="ssc"),
    # BASELINE config #3: 80-bin log-mel for neural ASR front-ends, batch-256.
    # ASR-style conventions: periodic Hann, continuous mel triangles,
    # stabilized log, no DCT/lifter/energy.
    "logmel80": FrontendConfig(
        features="logmel",
        n_mels=80,
        window="hann_periodic",
        mel_variant="tf_continuous",
        mel_low_hz=125.0,
        mel_high_hz=7600.0,
        log_kind="ln_stab",
        power_scale_nfft=False,
        append_energy=False,
        lifter=0,
    ),
    # BASELINE config #4: LibriSpeech-scale streaming with global CMVN, 8-chip DP.
    "classic13_deltas_gcmvn": FrontendConfig(deltas=2, cmvn="global"),
    # BASELINE config #5: 48 kHz input resampled to 16 kHz, 39-dim MFCC+Δ+ΔΔ.
    "mfcc39_48k": FrontendConfig(deltas=2, input_sample_rate=48000),
    # 44.1 kHz input (the second-most-common real rate): reduces to
    # up=160/down=441 — exactly one polyphase cycle per frame hop, so it
    # rides the same in-kernel fused resample as 48 kHz (r5)
    "mfcc39_44k": FrontendConfig(deltas=2, input_sample_rate=44100),
    # Kaldi compute-mfcc-feats defaults (src/feat semantics re-derived; no
    # Kaldi on disk — certified by construction + property tests): povey
    # window, snip_edges framing, per-frame processing (DC removal, frame
    # pre-emphasis), raw time-domain energy, 23 continuous mel triangles on
    # [20, nyquist], |X|^2 unscaled, floor-style natural log at FLT_EPSILON,
    # ortho DCT, lifter 22, c0 <- log raw energy. Kaldi's dither default
    # (1.0) is intentionally off here for determinism: --set dither=1.0.
    "kaldi_mfcc": FrontendConfig(
        window="povey",
        frame_tail="drop",
        preemph_mode="frame",
        remove_dc_offset=True,
        energy_source="raw_frame",
        n_mels=23,
        mel_variant="tf_continuous",
        mel_low_hz=20.0,
        power_scale_nfft=False,
        log_kind="ln_floor",
        log_eps=1.1920928955078125e-07,  # float32 machine epsilon (Kaldi)
    ),
    # Kaldi compute-spectrogram-feats defaults (same FrameExtractionOptions
    # as kaldi_mfcc): 257 log power-spectrum lanes, feature[0] <- log raw
    # energy. Dither ships off like the other Kaldi configs.
    "kaldi_spectrogram": FrontendConfig(
        features="spectrogram",
        window="povey",
        frame_tail="drop",
        preemph_mode="frame",
        remove_dc_offset=True,
        energy_source="raw_frame",
        n_mels=257,  # == n_bins: one lane per FFT bin
        power_scale_nfft=False,
        log_kind="ln_floor",
        log_eps=1.1920928955078125e-07,
    ),
    # Kaldi compute-fbank-feats defaults: 23 log-mel bins, same framing.
    "kaldi_fbank": FrontendConfig(
        features="logmel",
        window="povey",
        frame_tail="drop",
        preemph_mode="frame",
        remove_dc_offset=True,
        n_mels=23,
        mel_variant="tf_continuous",
        mel_low_hz=20.0,
        power_scale_nfft=False,
        log_kind="ln_floor",
        log_eps=1.1920928955078125e-07,
        append_energy=False,
        lifter=0,
    ),
    # Kaldi compute-plp-feats defaults (same provenance note as kaldi_mfcc;
    # the PLP math is additionally property-certified in tests/test_plp.py:
    # Durbin solves Yule-Walker, LPC-cepstra match the -log A(z) series,
    # IDFT bases match a length-2(M+1) irfft): same feature-window and
    # 23-bin mel bank as kaldi_mfcc, equal-loudness, cube-root compression,
    # order-12 LPC, 13 cepstra with c0 <- log raw energy, lifter 22.
    "kaldi_plp": FrontendConfig(
        features="plp",
        window="povey",
        frame_tail="drop",
        preemph_mode="frame",
        remove_dc_offset=True,
        energy_source="raw_frame",
        n_mels=23,
        mel_variant="tf_continuous",
        mel_low_hz=20.0,
        power_scale_nfft=False,
        log_eps=1.1920928955078125e-07,
    ),
    # OpenAI Whisper log-mel front-end (certified against the on-disk
    # transformers.WhisperFeatureExtractor numpy path, which matches the
    # original torch implementation to 1e-5): 400-pt FFT == window length,
    # periodic Hann, torch.stft center=True reflect padding, |X|^2
    # unscaled, 80 Slaney-scale slaney-normalized Hz-domain triangles on
    # [0, 8000], log10 floored at 1e-10, drop-last-frame quirk, and the
    # per-utterance max-8 dynamic-range compression. For bit-parity with
    # the HF pipeline, feed audio padded/trimmed to its 30 s chunk.
    "whisper80": FrontendConfig(
        features="logmel",
        input_scale=1.0 / 32768.0,  # whisper audio is [-1, 1) float
        win_len_s=0.025,
        hop_s=0.010,
        n_fft=400,
        window="hann_periodic",
        frame_tail="center_reflect",
        drop_last_frame=True,
        preemph=0.0,
        n_mels=80,
        mel_variant="librosa_hz",
        mel_scale="slaney",
        mel_norm="slaney",
        mel_low_hz=0.0,
        mel_high_hz=8000.0,
        power_scale_nfft=False,
        log_kind="log10_floor",
        log_eps=1e-10,
        logmel_norm="whisper",
        append_energy=False,
        lifter=0,
    ),
}


def named_config(name: str) -> FrontendConfig:
    try:
        return NAMED_CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown config {name!r}; known: {sorted(NAMED_CONFIGS)}")


def config_with_overrides(base: FrontendConfig, sets) -> FrontendConfig:
    """Apply "key=value" override strings to a config, parsing each value
    by the field's declared type (the CLI's `--set window=povey` path).

    Accepted value forms: ints/floats per the field type, true/false for
    bools, none/null for Optional fields, anything else verbatim for str
    enums (validated by FrontendConfig.__post_init__). Unknown keys and
    unparseable values raise ValueError with the legal field list."""
    fields = {f.name: f for f in dataclasses.fields(FrontendConfig)}
    kw = {}
    for s in sets:
        key, sep, raw = s.partition("=")
        key = key.strip()
        if not sep or key not in fields:
            raise ValueError(
                f"--set {s!r}: expected key=value with key one of "
                f"{sorted(fields)}"
            )
        raw = raw.strip()
        ftype = fields[key].type  # stringified by `from __future__ import annotations`
        try:
            if raw.lower() in ("none", "null") and "Optional" in ftype:
                val = None
            elif ftype == "bool":
                if raw.lower() not in ("true", "false", "1", "0"):
                    raise ValueError("expected true/false")
                val = raw.lower() in ("true", "1")
            elif "int" in ftype:  # int | Optional[int]
                val = int(raw)
            elif "float" in ftype:  # float | Optional[float]
                val = float(raw)
            else:
                val = raw
        except ValueError as e:
            raise ValueError(f"--set {s!r}: cannot parse as {ftype}: {e}")
        kw[key] = val
    return base.replace(**kw)  # __post_init__ re-validates enums/ranges
