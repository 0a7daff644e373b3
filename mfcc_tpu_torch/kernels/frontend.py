"""The fused front-end on Hopper: audio rows → [log-mel | energy] prefix.

Port of `mfcc_tpu/kernels/frontend.py::_make_radix4_kernel` (slab mode, at
any N2), of `_make_kernel` (the direct DFT) and of the `_stage_dict` prefix
they feed. One CUDA kernel (`csrc/frontend.cu`, whose header states its
design and bound) does, per utterance and frame: int16/fp32 convert ×
input_scale, the dither contract (`ops/dither.py`) when cfg.dither > 0,
signal pre-emphasis with x[-1] = 0, zeroing at t >= length, framing
("pad", "drop", or centered with edge reflection at each row's length),
Kaldi frame-first conditioning when the config asks for it (DC removal,
raw-frame energy, frame pre-emphasis, windowed-frame energy), window, a
real DFT of n_fft points (`dft_form`: radix-2 for powers of two, a
Stockham mixed-radix FFT for even n_fft whose half factors into 2, 3, 4
and 5, a direct DFT otherwise), |X|², then by feature kind
(`FEATURE_KINDS`): the mel projection and the log kind (ln, ln_stab, db,
ln_floor, log10_floor) for mfcc and logmel configs, the raw mel energies
for PLP, the log kind of each power bin for a spectrogram (the identity
projection, no matrix), or the SSC centroids of the per-bin clamped power;
lane M holds the clamped (unlogged) energy (0 for SSC). Output
[B, F, n_mels+1] float32 with F = cfg.num_frames(T) (F = 0 returns an
empty prefix without a launch). A config whose shared-memory layout
exceeds the block's 227 KB is refused (`layout_reason`).

Resampling configs (input_sample_rate != sample_rate) take rows at the
input rate, with lengths in input samples, through the kernel's second
form: the fused resample (port of `_gather_frames` :493-529), which
computes each staged 16 kHz sample from the input rows by the polyphase FIR
of `csrc/polyphase.cuh`. F = cfg.num_frames(output_length(T)) then.

The reference's `dft_passes` routes (`kernel_form`): "radix4", the
default, takes the FFT form of `dft_form`; "fp32" the direct DFT at any
n_fft; "bf16x3" (port of `_make_kernel` :857-867) a fourth form that
computes the DFT on the tensor cores as three bf16 products against the
window-folded matrix of `constants.folded_dft` (`bf16_matrix`), an opt-in of
its own accuracy class that no config takes and the fused-resample form
lacks.

`logmel_prefix` is the wrapper: on a CUDA tensor it launches the kernel or
raises; on a CPU tensor it returns `logmel_prefix_reference`, the plain
PyTorch version built from the chain's stages (after `chain.resample_input`
for resampling configs). `launches` counts launches of the plain front-end,
`resample_launches` those of the fused resample; `dither_launches`,
`conditioning_launches`, `plp_launches`, `spectrogram_launches`,
`ssc_launches`, `centered_launches`, `mixed_radix_launches`,
`direct_dft_launches` and `bf16x3_launches` count the launches (of either
form) that take that branch. Set them to 0 to start a count.

`fused_logmel_stages` is the port of the reference's entry of the same
name: the prefix by a `dft_passes` route, and with `feature_tail=True` the
finished mfcc features from the feature-tail kernel (`kernels/tail.py`);
`chain.extract_batch` calls it on the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mfcc_tpu_torch.config import FrontendConfig
from mfcc_tpu_torch.kernels import _build
from mfcc_tpu_torch.kernels import resample as rs_kernel
from mfcc_tpu_torch.ops import chain, constants, dither
from mfcc_tpu_torch.ops import resample as R

MAX_BATCH = 65535  # grid.y limit: one grid row per utterance
TILE = 32  # frames per block (csrc/frontend.cu kTile)
WARPS = 8
ENERGY_SOURCES = ("pspec", "raw_frame", "windowed_frame")  # csrc/frontend.cu codes
FEATURE_KINDS = ("logmel", "plp", "spectrogram", "ssc")  # csrc/frontend.cu codes; mfcc is logmel
DFT_FORMS = ("radix2", "mixed", "direct", "bf16x3")  # csrc/frontend.cu codes
CENTER_CODES = {"center": 1, "center_reflect": 2}  # csrc/frontend.cu reflection kinds; 0 = none

launches = 0
resample_launches = 0
dither_launches = 0
conditioning_launches = 0
plp_launches = 0
spectrogram_launches = 0
ssc_launches = 0
centered_launches = 0
mixed_radix_launches = 0
direct_dft_launches = 0
bf16x3_launches = 0


def feature_kind(cfg: FrontendConfig) -> str:
    """The kernel's feature kind for cfg: mfcc configs share the logmel
    epilogue (the DCT follows in tensor code)."""
    return "logmel" if cfg.features == "mfcc" else cfg.features


def mel_matrices(cfg: FrontendConfig) -> int:
    """How many [n_bins, M] matrices the kernel stages and reads for cfg
    (csrc/frontend.cu mel_floats): mel; none for the spectrogram's identity
    projection; mel and melf for SSC."""
    return {"spectrogram": 0, "ssc": 2}.get(feature_kind(cfg), 1)


def logmel_prefix_reference(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    cfg: FrontendConfig,
    consts: dict[str, torch.Tensor] | None = None,
    dft_passes: str = "radix4",
) -> torch.Tensor:
    """The kernel's plain version from chain.logmel_stages (torch.fft.rfft
    + mel matmul; with dft_passes="bf16x3" the three bf16 products of
    chain.bf16x3_power), on any device; for resampling configs after
    chain.resample_input (the plain resample). Lane for lane the Pallas
    kernel's prefix: [log-mel | clamped energy]; [melspec | energy] for
    PLP; [log pspec | energy] for a spectrogram (its log-mel, mel being the
    identity); [centroids | 0] for SSC."""
    if chain.resamples(cfg):
        audio, lengths = chain.resample_input(audio, lengths, cfg)
    st = chain.logmel_stages(audio, lengths, cfg, consts, dft_passes=dft_passes)
    kind = feature_kind(cfg)
    if kind == "ssc":
        c = chain.ssc_centroids(st["pspec"], cfg, consts)
        return torch.cat([c, torch.zeros_like(c[..., :1])], dim=-1)
    lanes = st["melspec"] if kind == "plp" else st["logmel"]
    return torch.cat([lanes, st["energy"][..., None]], dim=-1)


def radices(n_fft: int) -> tuple[int, ...] | None:
    """The Stockham stages of the mixed-radix form: n_fft/2 factored into
    4s first, then 2, 3 and 5 (200 = 4·2·5·5, 240 = 4·4·3·5); None when
    n_fft is odd or its half has another prime factor."""
    if n_fft % 2:
        return None
    h, out = n_fft // 2, []
    for r in (4, 2, 3, 5):
        while h % r == 0 and (r != 2 or h % 4):
            out.append(r)
            h //= r
    return tuple(out) if h == 1 else None


def dft_form(n_fft: int) -> str:
    """The kernel's DFT for n_fft: "radix2" (a power of two), "mixed" (a
    Stockham FFT of n_fft/2 points in radices 2-5) or "direct" (every other
    size, odd ones included)."""
    if n_fft >= 2 and n_fft & (n_fft - 1) == 0:
        return "radix2"
    return "mixed" if radices(n_fft) else "direct"


def resolve_dft_passes(cfg: FrontendConfig, dft_passes: str = "radix4") -> str:
    """The dft_passes route actually taken (port of the reference's
    `resolve_dft_passes`): "radix4", the port's FFT forms, becomes "fp32",
    the direct DFT, for an n_fft that neither FFT form takes."""
    if dft_passes not in chain.DFT_PASSES:
        raise ValueError(f"dft_passes={dft_passes!r} not in {chain.DFT_PASSES}")
    if dft_passes == "radix4" and dft_form(cfg.n_fft) == "direct":
        return "fp32"
    return dft_passes


def kernel_form(cfg: FrontendConfig, dft_passes: str = "radix4") -> str:
    """The kernel's DFT form for cfg and a dft_passes route: "radix4" the
    FFT form of `dft_form`, "fp32" the direct DFT at any n_fft, "bf16x3" the
    tensor-core form."""
    route = resolve_dft_passes(cfg, dft_passes)
    return {"radix4": dft_form(cfg.n_fft), "fp32": "direct", "bf16x3": "bf16x3"}[route]


def twiddle_count(n_fft: int, form: str | None = None) -> int:
    """Entries of the kernel's twiddle table for a DFT form (dft_form(n_fft)
    by default): n_fft/2 for the two FFT forms (the real split reads them
    all, the complex stages the even ones), the whole circle for the direct
    DFT, which indexes it by (k·n) mod n_fft, none for bf16x3."""
    form = form or dft_form(n_fft)
    return {"direct": n_fft, "bf16x3": 0}.get(form, n_fft // 2)


def fft_twiddles(n_fft: int, form: str | None = None) -> np.ndarray:
    """[twiddle_count(n_fft, form), 2] float32 table of e^{-2πik/n_fft}
    (cos, -sin), computed in float64."""
    ang = 2.0 * np.pi * np.arange(twiddle_count(n_fft, form), dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)


def bf16_dims(cfg: FrontendConfig) -> tuple[int, int]:
    """(kp, nbp) of the bf16x3 form: min(frame_length, n_fft) and n_bins,
    each rounded up to the tensor cores' 16."""
    return -(-min(cfg.frame_length, cfg.n_fft) // 16) * 16, -(-cfg.n_bins // 16) * 16


def bf16_matrix(cfg: FrontendConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16x3 form's matrices (csrc/frontend.cu dft_hi / dft_lo): the
    hi and lo parts of `constants.folded_dft`, [kp, 2·nbp] bfloat16, rows
    past min(L, n_fft) and bins past n_bins zero, column block 2j the
    cosines and 2j + 1 the sines of bins [16j, 16j + 16)."""
    k = constants.folded_dft(cfg)
    kp, nbp = bf16_dims(cfg)
    le, nb = k["dft"].shape[0], cfg.n_bins
    out = []
    for part in (k["dft_hi"], k["dft_lo"]):
        m = np.zeros((kp, 2, nbp), np.float32)  # [row, cos | sin, bin]
        m[:le, 0, :nb], m[:le, 1, :nb] = part[:, :nb], part[:, nb:]
        m = m.reshape(kp, 2, nbp // 16, 16).transpose(0, 2, 1, 3).reshape(kp, 2 * nbp)
        out.append(torch.from_numpy(np.ascontiguousarray(m)).to(torch.bfloat16))
    return out[0], out[1]


def mel_bands(mel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column [lo, hi) bounds of the nonzero rows of mel [n_bins, M]
    (lo = hi = 0 for an all-zero column): the kernel sums only inside them,
    which is exact since the weights it skips are zero."""
    nz = mel != 0
    k = torch.arange(mel.shape[0], device=mel.device)[:, None]
    hi = torch.where(nz, k + 1, 0).amax(dim=0)
    lo = torch.where(nz, k, mel.shape[0]).amin(dim=0)
    lo = torch.where(hi > 0, lo, 0)
    return lo.to(torch.int32).contiguous(), hi.to(torch.int32).contiguous()


def _tables(consts: dict[str, torch.Tensor], device) -> dict[str, torch.Tensor]:
    """The kernel's float32 tables on `device`; "melf" (SSC's freq-weighted
    mel, f_k·mel[k, m]) is formed in float64 and rounded once."""
    mel = consts["mel"].to(device=device, dtype=torch.float32).contiguous()
    lo, hi = mel_bands(mel)
    melf = consts["freqs"].double()[:, None] * consts["mel"].double()
    return {
        "window": consts["window"].to(device=device, dtype=torch.float32).contiguous(),
        "mel": mel,
        "melf": melf.to(device=device, dtype=torch.float32).contiguous(),
        "mel_lo": lo,
        "mel_hi": hi,
    }


@functools.lru_cache(maxsize=16)
def _device_tables(cfg: FrontendConfig, device: torch.device):
    return _tables(chain.device_constants(cfg, torch.device("cpu"), torch.float64), device)


@functools.lru_cache(maxsize=16)
def _device_twiddles(n_fft: int, form: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fft_twiddles(n_fft, form), device=device)


@functools.lru_cache(maxsize=16)
def _device_bf16_matrix(cfg: FrontendConfig, device: torch.device):
    return tuple(m.to(device).contiguous() for m in bf16_matrix(cfg))


def smem_bytes(cfg: FrontendConfig, dft_passes: str = "radix4") -> int:
    """Shared memory per block for cfg (csrc/frontend.cu layout): the
    signal row (or the fused resample's input window, whichever is longer),
    window, the [n_bins, M] matrices (mel; none for a spectrogram; mel and
    melf for SSC), twiddles, per-warp DFT buffers (two ping-pong rows for the
    mixed-radix form, whose free row then holds the powers) and power rows,
    or for bf16x3 at a 32-byte boundary the tile's frames as bf16 hi and lo,
    its power rows and frame energies; the staged x row of the fused
    resample and of dither, and the resample's tap table."""
    def a4(n):
        return (n + 3) & ~3

    N, form = cfg.n_fft, kernel_form(cfg, dft_passes)
    span = (TILE - 1) * cfg.frame_step + cfg.frame_length
    in_len = taps = 0
    xs = a4(span + 1) if chain.resamples(cfg) or cfg.dither > 0.0 else 0
    if chain.resamples(cfg):
        d = R.polyphase_design(*R.ratio(cfg.input_sample_rate, cfg.sample_rate))
        in_len = rs_kernel.input_span(span + 1, d)
        taps = d["up"] * d["K"]
    n = (a4(max(span, in_len)) + a4(max(cfg.frame_length, N))
         + mel_matrices(cfg) * a4(cfg.n_bins * cfg.n_mels) + a4(2 * twiddle_count(N, form)))
    if form == "bf16x3":
        kp, nbp = bf16_dims(cfg)
        n = ((n + 7) & ~7) + TILE * kp + TILE * nbp + TILE
    else:
        per_warp = a4(2 * N if form == "mixed" else N)
        n += per_warp * WARPS + (0 if form == "mixed" else a4(cfg.n_bins) * WARPS)
    return 4 * (n + xs + a4(taps))


def layout_reason(cfg: FrontendConfig, dft_passes: str = "radix4") -> str | None:
    """Why cfg's kernel layout cannot launch (over the block's shared
    memory), or None."""
    n = smem_bytes(cfg, dft_passes)
    if n <= rs_kernel.SMEM_BUDGET_BYTES:
        return None
    return (
        f"front-end kernel layout of {n:,} bytes of shared memory a block "
        f"(n_fft={cfg.n_fft}, frame length {cfg.frame_length}, "
        f"{cfg.n_mels} filters), over the block's {rs_kernel.SMEM_BUDGET_BYTES:,}"
    )


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("frontend")
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    branches = [
        f, u,  # dither, premixed seed
        i, i, f, f, i,  # conditioning, remove_dc, frame_preemph, frame_keep0, energy_source
        i, i,  # log_kind, feature_kind
        p,  # stream
    ]
    lib.mfcc_frontend_logmel.argtypes = [
        p, i, p, p, p, p, p, p, p, p,  # audio, is_int16, lengths, out, tables
        p, p,  # dft_hi, dft_lo (bf16x3)
        i, i, i, i, i, i,  # B, T, F, L, S, M
        i, i, i, i,  # n_fft, dft_form, frame_offset, center
        f, f, f, f,  # scale, preemph, eps, pscale
        *branches,
    ]
    lib.mfcc_frontend_logmel.restype = ctypes.c_int
    lib.mfcc_frontend_logmel_resample.argtypes = [
        p, i, p, p, p, p, p, p, p, p, p,  # audio, is_int16, lengths, out, tables, taps
        i, i, i, i, i, i,  # B, T, F, L, S, M
        i, i,  # n_fft, dft_form
        i, i, i, i,  # up, down, half_len, K
        f, f, f,  # preemph, eps, pscale
        *branches,
    ]
    lib.mfcc_frontend_logmel_resample.restype = ctypes.c_int
    lib.mfcc_frontend_error_string.argtypes = [ctypes.c_int]
    lib.mfcc_frontend_error_string.restype = ctypes.c_char_p
    return lib


def logmel_prefix(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    cfg: FrontendConfig,
    consts: dict[str, torch.Tensor] | None = None,
    dft_passes: str = "radix4",
) -> torch.Tensor:
    """audio [B, T] int16 or float32 + lengths [B] int32 → [B, F, M+1]
    float32 (lanes [0:M] log-mel, lane M the clamped energy; other feature
    kinds as in `logmel_prefix_reference`). For resampling configs T and
    lengths count input samples and F frames of the resampled signal.
    `dft_passes` picks the DFT route (`kernel_form`): "radix4" (the FFT
    forms, the default), "fp32" (the direct DFT) or "bf16x3" (three bf16
    tensor-core products, an opt-in of its own accuracy class, not in the
    fused-resample form).

    CUDA tensors launch the kernel (contiguous, on one device, else it
    raises); CPU tensors get the plain version. `consts` overrides the
    window and mel matrix (a chain-constants dict)."""
    global launches, resample_launches, dither_launches, conditioning_launches
    global plp_launches, spectrogram_launches, ssc_launches
    global centered_launches, mixed_radix_launches, direct_dft_launches, bf16x3_launches
    form = kernel_form(cfg, dft_passes)
    if form == "bf16x3" and chain.resamples(cfg):
        raise NotImplementedError(
            "dft_passes='bf16x3' in the fused-resample form: the resample branch of "
            "csrc/frontend.cu has no bf16x3 DFT (ROADMAP queue 2 item 5)"
        )
    if audio.device.type == "cpu":
        return logmel_prefix_reference(audio, lengths, cfg, consts, dft_passes)
    if audio.device.type != "cuda":
        raise ValueError(f"the front-end kernel runs on CUDA, got {audio.device}")
    chain.check_supported(cfg)  # the default route's layout among the rest
    reason = layout_reason(cfg, dft_passes) if dft_passes != "radix4" else None
    if reason:
        raise NotImplementedError(f"config {cfg.config_hash()} needs the {reason} "
                                  f"(dft_passes={dft_passes!r})")
    if cfg.dtype != "float32":
        raise NotImplementedError(f"the kernel computes in float32, not {cfg.dtype}")
    if audio.dim() != 2 or audio.dtype not in (torch.int16, torch.float32):
        raise ValueError(
            f"audio must be [B, T] int16 or float32, got {audio.dtype} "
            f"{tuple(audio.shape)}"
        )
    B, T = audio.shape
    if (
        lengths.device != audio.device
        or lengths.dtype != torch.int32
        or lengths.shape != (B,)
    ):
        raise ValueError(
            f"lengths must be int32 [{B}] on {audio.device}, got "
            f"{lengths.dtype} {tuple(lengths.shape)} on {lengths.device}"
        )
    if not (audio.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("audio and lengths must be contiguous")
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernel's {MAX_BATCH} rows")
    resampling = chain.resamples(cfg)
    kind = feature_kind(cfg)
    if resampling:
        sr_in = cfg.input_sample_rate
        F = cfg.num_frames(R.output_length(T, sr_in, cfg.sample_rate))
    else:
        F = cfg.num_frames(T)
    M = cfg.n_mels
    out = torch.empty((B, F, M + 1), dtype=torch.float32, device=audio.device)
    if B == 0 or F == 0:  # F = 0: "drop" framing of rows shorter than a frame
        return out
    k = _device_tables(cfg, audio.device) if consts is None else _tables(consts, audio.device)
    twiddle = _device_twiddles(cfg.n_fft, form, audio.device)
    lib = _lib()
    head = (
        audio.data_ptr(), int(audio.dtype == torch.int16), lengths.data_ptr(),
        out.data_ptr(), k["window"].data_ptr(), k["mel"].data_ptr(), k["melf"].data_ptr(),
        k["mel_lo"].data_ptr(), k["mel_hi"].data_ptr(), twiddle.data_ptr(),
    )
    dft_hi = dft_lo = None
    if form == "bf16x3":
        dft_hi, dft_lo = (m.data_ptr() for m in _device_bf16_matrix(cfg, audio.device))
    dims = (B, T, F, cfg.frame_length, cfg.frame_step, M, cfg.n_fft, DFT_FORMS.index(form))
    frame_mode = cfg.preemph_mode == "frame"
    tail = (
        0.0 if frame_mode else cfg.preemph,  # signal pre-emphasis while staging
        cfg.log_eps,
        1.0 / cfg.n_fft if cfg.power_scale_nfft else 1.0,
    )
    c = cfg.preemph if frame_mode else 0.0
    conditioning = chain.needs_conditioning(cfg)
    branches = (
        cfg.dither, dither._fmix32_int(cfg.dither_seed),
        int(conditioning), int(cfg.remove_dc_offset), c, 1.0 - c,
        ENERGY_SOURCES.index(cfg.energy_source), chain.LOG_KINDS.index(cfg.log_kind),
        FEATURE_KINDS.index(kind),
    )
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream().cuda_stream
        if resampling:
            up, down = R.ratio(sr_in, cfg.sample_rate)
            d = R.polyphase_design(up, down)
            taps = rs_kernel.device_table(up, down, cfg.input_scale, audio.device)
            rc = lib.mfcc_frontend_logmel_resample(
                *head, taps.data_ptr(), *dims,
                d["up"], d["down"], d["half_len"], d["K"], *tail, *branches, stream,
            )
        else:
            rc = lib.mfcc_frontend_logmel(
                *head, dft_hi, dft_lo, *dims, chain.frame_offset(cfg),
                CENTER_CODES.get(cfg.frame_tail, 0),
                cfg.input_scale, *tail, *branches, stream,
            )
    if rc != 0:
        raise RuntimeError(
            "front-end kernel launch failed: "
            f"{lib.mfcc_frontend_error_string(rc).decode()} (cudaError {rc})"
        )
    if resampling:
        resample_launches += 1
    else:
        launches += 1
    dither_launches += int(cfg.dither > 0.0)
    conditioning_launches += int(conditioning)
    plp_launches += int(kind == "plp")
    spectrogram_launches += int(kind == "spectrogram")
    ssc_launches += int(kind == "ssc")
    centered_launches += int(chain.centered(cfg))
    mixed_radix_launches += int(form == "mixed")
    direct_dft_launches += int(form == "direct")
    bf16x3_launches += int(form == "bf16x3")
    return out


def fused_logmel_stages(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    cfg: FrontendConfig,
    *,
    dft_passes: str = "radix4",
    feature_tail: bool = False,
    consts: dict[str, torch.Tensor] | None = None,
) -> dict:
    """The port of the reference's `fused_logmel_stages` (:1711-1893, its
    `_stage_dict` :1896): audio [B, T] (int16, or any float type, cast to
    float32) + lengths [B] → {"prefix" | "features_fused", "n_valid",
    "frame_mask", "num_frames"}, on audio's device. "prefix" is
    `logmel_prefix` by the `dft_passes` route; with feature_tail=True and an
    mfcc config the feature-tail kernel finishes the features
    ("features_fused", which `chain.features_from_logmel` returns as they
    are) at any frame count, or raises on the card (`tail.feature_tail`).
    Other families keep the prefix, as the reference's ineligible configs
    do. For resampling configs lengths count
    input samples; n_valid counts frames at cfg.sample_rate."""
    from mfcc_tpu_torch.kernels import tail

    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"the fused kernels compute in float32; use chain.logmel_stages for "
            f"dtype={cfg.dtype!r}"
        )
    if audio.dtype != torch.int16:
        audio = audio.to(torch.float32)
    audio = audio.contiguous()
    lengths = torch.as_tensor(lengths, device=audio.device).to(torch.int32).contiguous()
    prefix = logmel_prefix(audio, lengths, cfg, consts=consts, dft_passes=dft_passes)
    if chain.resamples(cfg):
        lengths = R.output_lengths(lengths, cfg.input_sample_rate, cfg.sample_rate)
    n_valid = chain.num_valid_frames(lengths, cfg).to(torch.int32).contiguous()
    F = prefix.shape[1]
    stages = {
        "n_valid": n_valid,
        "frame_mask": chain.frame_mask(n_valid, F, torch.float32),
        "num_frames": F,
    }
    if feature_tail and cfg.features == "mfcc":
        stages["features_fused"] = tail.feature_tail(prefix, n_valid, cfg, consts)
    else:
        stages["prefix"] = prefix
    return stages
