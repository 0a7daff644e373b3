"""The fused front-end on Hopper: audio rows → [log-mel | energy] prefix.

Port of `mfcc_tpu/kernels/frontend.py::_make_radix4_kernel` (slab mode, at
any N2), of `_make_kernel` (its fp32 and bf16x3 DFT routes) and of the
`_stage_dict` prefix they feed. One CUDA kernel (`csrc/frontend.cu`, whose header states its
design and bound) does, per utterance and frame: int16/fp32 convert ×
input_scale, the dither contract (`ops/dither.py`) when cfg.dither > 0,
signal pre-emphasis with x[-1] = 0, zeroing at t >= length, framing
("pad", "drop", or centered with edge reflection at each row's length),
Kaldi frame-first conditioning when the config asks for it (DC removal,
raw-frame energy, frame pre-emphasis, windowed-frame energy), window, a
real DFT of n_fft points (`dft_form`: a Stockham FFT of n_fft/2 complex
points in radices 8, 4, 2, 3 and 5 for every even n_fft whose half factors
so, powers of two included; for every other n_fft a Bluestein FFT, the DFT
as a chirp-z convolution through a Stockham FFT of a size that factors so;
by the plan of `fft_layout`: each warp a frame through its own two rows,
or, where those rows are over the block's shared memory, the block's
threads in 4, 2 or 1 groups, each a frame at a time through two rows of
its own, the tables staged or read from device memory, and where the
tile's staged span and window are over it too (long hops, long frames),
each frame read from device memory; where the rows and the packed mel
bands are over it too (n_fft from ~6,200), at FFTs of CLUSTER_MIN_POINTS
points or more (by form) each frame's rows split over the shared memory of a
thread-block cluster of 2, 4 or 8 blocks (the cluster plan), else the bands
read from device memory, then the rows kept in a workspace in device
memory, then, where
tens of thousands of filters put the projection's sums over it too, the
sums in device memory; at tens of thousands of filters, by `fft_layout`'s
rule, the wide plan: a tile's FFTs into power rows in shared memory, then
the projection filter by filter over the tile's frames), |X|², then
by feature kind (`FEATURE_KINDS`): the mel projection over the packed bands
(`mel_packed`) and the log kind (ln, ln_stab, db, ln_floor, log10_floor)
for mfcc and logmel configs, the raw mel energies
for PLP, the log kind of each power bin for a spectrogram (the identity
projection, no matrix), or the SSC centroids of the per-bin clamped power;
lane M holds the clamped (unlogged) energy (0 for SSC). Output
[B, F, n_mels+1] float32 with F = cfg.num_frames(T) (F = 0 returns an
empty prefix without a launch). The last plan's layout depends on neither
n_fft nor the hop nor the frame length nor the filter count, so the
Stockham and Bluestein forms take every config the reference takes, and so
does the bf16x3 opt-in (`bf16_layout`: past its staged plan, the block
plans' kernel, the tile's A built once in shared memory or the workspace,
then the packed bands and the accumulators in device memory); only a bf16x3
matrix over the card's memory is refused, on the card
(`bf16_matrix_reason`).

Resampling configs (input_sample_rate != sample_rate) take rows at the
input rate, with lengths in input samples, F = cfg.num_frames(output_length
(T)), by one of two routes (`resample_route`, picked by the layout mirrors
before any launch): the kernel's second form, the fused resample (port of
`_gather_frames` :493-529), which computes each staged 16 kHz sample from
the input rows by the polyphase FIR of `csrc/polyphase.cuh`; or the split
route, the reference's unfused one, for centered framing and for configs
whose fused layout is over the block (192 kHz input): `resample.cu`
(`kernels/resample.py::resample_rows`), then the plain form on its rows.

The reference's `dft_passes` routes (`kernel_form`): "radix4", the
default, and "fp32" both take the form of `dft_form` (every one of them
sums in full fp32; the reference's fp32 route is its own matrix DFT, and
the port matches outputs, not layouts); "bf16x3" (port of `_make_kernel`
:857-867) a form that computes the DFT on the tensor cores (wgmma) as three
bf16 products against the window-folded matrix of `constants.folded_dft`
(`bf16_matrix`), an opt-in of its own accuracy class that no config takes,
in both forms, in the plans of `bf16_layout`.

`logmel_prefix` is the wrapper: on a CUDA tensor it launches the kernel or
raises; on a CPU tensor it returns `logmel_prefix_reference`, the plain
PyTorch version built from the chain's stages (after `chain.resample_input`
for resampling configs). `launches` counts launches of the plain front-end,
`resample_launches` those of the fused resample; `dither_launches`,
`conditioning_launches`, `plp_launches`, `spectrogram_launches`,
`ssc_launches`, `centered_launches`, `bluestein_launches` and
`bf16x3_launches` count the launches (of either form) that take that
branch, `bf16_pass_launches`, `bf16_gather_launches`,
`bf16_gather_bands_launches` and `bf16_gather_out_launches` those of the
bf16x3 form in each block plan of `BF16_PLANS`, `block_fft_launches` those
of the FFT forms' block plan and
`global_table_launches` those of it that read the FFT tables from device
memory, `gather_launches` those that read each frame from device
memory, `gather_bands_launches`, `gather_rows_launches` and
`gather_sums_launches` those of the plans that read the packed mel bands,
and also keep the FFT rows, and then the projection's sums, in device
memory (`fft_layout`, `PLAN_TRAITS`), `cluster_launches` those of the
cluster plan, `wide_launches` those of the wide plan, `split_launches` the plain-form launches of
the split route (each after one `resample.cu` launch, counted by
`kernels/resample.py`). Set them to 0 to start a count.

`logmel_block` is the block launch of the plain form for streaming
(`pipeline/streaming.py`): rows [N, span+1] whose sample 0 is each block's
pre-context sample x[t0·S - 1] and whose frames start at sample 1, with
the samples after it that hold signal, → [N, K, n_mels+1]; its plain
version `logmel_block_reference`, its count `block_launches` (the branch
counts above count it too, `launches` does not).

`fused_logmel_stages` is the port of the reference's entry of the same
name: the prefix by a `dft_passes` route, and with `feature_tail=True` the
finished mfcc features from the feature-tail kernel (`kernels/tail.py`);
`chain.extract_batch` calls it on the card.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading

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
THREADS = 32 * WARPS
ENERGY_SOURCES = ("pspec", "raw_frame", "windowed_frame")  # csrc/frontend.cu codes
FEATURE_KINDS = ("logmel", "plp", "spectrogram", "ssc")  # csrc/frontend.cu codes; mfcc is logmel
DFT_FORMS = ("stockham", "bf16x3", "bluestein")  # csrc/frontend.cu codes
# the FFT forms' plans (csrc/frontend.cu plan): a frame a warp; frames a
# group of the block with the tables staged, or in device memory; the same
# with each frame read from device memory, no span and no window staged;
# then with the packed mel bands, then the FFT rows, then the projection's
# sums in device memory too
# then "cluster": each frame's FFT rows split over the shared memory of a
# thread-block cluster, the tables and bands in device memory; "wide": a
# tile's power rows in shared memory, projected filter by filter (tens of
# thousands of filters)
FFT_PLANS = ("warp", "block", "block_global", "gather", "gather_global", "cluster", "wide", "gather_bands",
             "gather_rows", "gather_sums")
# what each block plan keeps in device memory rather than staging
# (csrc/frontend.cu kLadder, and plan_cluster and plan_wide for "cluster"
# and "wide", which are no rows of it): (each frame, the FFT tables, the
# packed mel bands, the FFT rows, the projection's sums); "cluster" stages
# its rows in the cluster's shared memory, "wide" its groups' rows and the
# tile's power rows, its sums in registers
PLAN_TRAITS = {
    "block": (False, False, False, False, False),
    "block_global": (False, True, False, False, False),
    "gather": (True, False, False, False, False),
    "gather_global": (True, True, False, False, False),
    "cluster": (True, True, True, False, False),
    "wide": (True, True, True, False, False),
    "gather_bands": (True, True, True, False, False),
    "gather_rows": (True, True, True, True, False),
    "gather_sums": (True, True, True, True, True),
}
# csrc/frontend.cu kLadder's plans in its order: the block plans plan_block
# walks, every plan after "warp" but "cluster" and "wide" (which a launch
# asks for by its cluster size and its tile)
BLOCK_LADDER = tuple(plan for plan in FFT_PLANS[1:] if plan not in ("cluster", "wide"))
# the cluster plan's portable cluster sizes (blocks a frame), tried smallest first
CLUSTER_SIZES = (2, 4, 8)
# the cluster plan's size rule, by DFT form: `fft_layout` tries it only at
# FFTs of this many points or more (`fft_points`), where it beat or tied
# the plans it replaces in turns (chip_smoke.py phase 29): the Stockham
# form's 8,192 points (n_fft 16,384) and up, the Bluestein form's P = 16,384
# and up (at P = 12,800 it lost to "gather_bands")
CLUSTER_MIN_POINTS = {"stockham": 8192, "bluestein": 16384}
# the wide plan's rule (`fft_layout`): it takes every config the ladder
# without it gives "gather_sums", and those it gives "gather_bands" or
# "gather_rows" at this many filters or more (where "gather_bands" is first
# taken at n_fft 512), where it beat them in turns (scripts/block_plan_sweep.py
# --parent and --wide-rule, from 14,172 filters); its tile is the most frames whose
# layout fits two blocks an SM (WIDE_TWO_BLOCKS bytes each), else one, at
# most WIDE_MAX_TILE (32 beat 16, 46 and 93 at 60,000 filters b16 on an H100,
# `wide_tile` taking fewer where a launch's frames would leave SMs idle);
# from WIDE_CHUNK_TILE frames its projection takes the filters a chunk at a
# time, below it a filter at a time (csrc/frontend.cu kWideChunkTile)
WIDE_MIN_FILTERS = 14172
WIDE_TWO_BLOCKS = 115712
WIDE_MAX_TILE = 32
WIDE_CHUNK_TILE = 16
# (plan, frames a block transforms at once; for "cluster" the blocks a
# frame) in the order plan() tries them; "wide" (its second value its tile,
# `wide_layout`) is tried apart, by its rule
FFT_LAYOUTS = (("warp", WARPS),
               *((plan, g) for plan in FFT_PLANS[1:] if plan != "wide"
                 for g in (CLUSTER_SIZES if plan == "cluster" else (4, 2, 1))))
CENTER_CODES = {"center": 1, "center_reflect": 2}  # csrc/frontend.cu reflection kinds; 0 = none
FRAMINGS = ("pad", "drop", "center", "center_reflect")  # csrc/frontend.cu frame-count codes

launches = 0
resample_launches = 0
dither_launches = 0
conditioning_launches = 0
plp_launches = 0
spectrogram_launches = 0
ssc_launches = 0
centered_launches = 0
bluestein_launches = 0
block_fft_launches = 0
global_table_launches = 0
gather_launches = 0
gather_bands_launches = 0
gather_rows_launches = 0
gather_sums_launches = 0
cluster_launches = 0
wide_launches = 0
bf16x3_launches = 0
bf16_pass_launches = 0
bf16_gather_launches = 0
bf16_gather_bands_launches = 0
bf16_gather_out_launches = 0
block_launches = 0
split_launches = 0


def feature_kind(cfg: FrontendConfig) -> str:
    """The kernel's feature kind for cfg: mfcc configs share the logmel
    epilogue (the DCT follows in tensor code)."""
    return "logmel" if cfg.features == "mfcc" else cfg.features


def mel_matrices(cfg: FrontendConfig) -> int:
    """How many packed weight tables the kernel stages and reads for cfg:
    mel; none for the spectrogram's identity projection; mel and melf for
    SSC."""
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
    return _prefix_lanes(st, cfg, consts)


def _prefix_lanes(st: dict, cfg: FrontendConfig, consts) -> torch.Tensor:
    """The prefix from the chain's frame stages, by feature kind."""
    kind = feature_kind(cfg)
    if kind == "ssc":
        c = chain.ssc_centroids(st["pspec"], cfg, consts)
        return torch.cat([c, torch.zeros_like(c[..., :1])], dim=-1)
    lanes = st["melspec"] if kind == "plp" else st["logmel"]
    return torch.cat([lanes, st["energy"][..., None]], dim=-1)


def block_frames(cfg: FrontendConfig, T: int) -> int:
    """K of block rows of T = span + 1 samples, span = (K - 1)·S + L (the
    pre-context and K frames at cfg.sample_rate); anything else raises."""
    L, S = cfg.frame_length, cfg.frame_step
    K = (T - 1 - L) // S + 1 if T - 1 >= L else 0
    if K < 1 or (K - 1) * S + L != T - 1:
        raise ValueError(f"block rows hold (K - 1)·{S} + {L} + 1 samples for K >= 1, got {T}")
    return K


def _block_refusal(cfg: FrontendConfig) -> None:
    if cfg.dither > 0.0 or chain.centered(cfg):
        raise ValueError("the block launch has no dither and no centered framing (streaming "
                         "refuses both)")


def logmel_block_reference(
    rows: torch.Tensor,
    valid: torch.Tensor,
    cfg: FrontendConfig,
    consts: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """The block launch's plain version (the reference's streaming base
    block up to the prefix, `mfcc_tpu/pipeline/streaming.py:51-139`), on
    any device: rows [N, span+1] at cfg.sample_rate × input_scale, y =
    x[1:] - c·x[:-1] (signal pre-emphasis; x[1:] in frame mode), zeroed
    at t >= valid, K frames from y[0], then `chain.frame_stages` and the
    prefix lanes of `logmel_prefix_reference` → [N, K, n_mels+1]."""
    _block_refusal(cfg)
    K = block_frames(cfg, rows.shape[-1])
    dtype = chain.compute_dtype(cfg)
    k = consts if consts is not None else chain.device_constants(cfg, rows.device, dtype)
    x = rows.to(dtype)
    if cfg.input_scale != 1.0:
        x = x * cfg.input_scale
    if cfg.preemph_mode == "signal" and cfg.preemph:
        y = x[:, 1:] - cfg.preemph * x[:, :-1]
    else:  # frame-first conditioning (Kaldi order): frame the raw signal
        y = x[:, 1:]
    y = chain.zero_beyond(y, valid)
    st = chain.frame_stages(chain.frame_signal(y, K, cfg), cfg, k)
    return _prefix_lanes(st, cfg, consts)


def radices(n_fft: int) -> tuple[int, ...] | None:
    """The Stockham stages of n_fft/2 points: 8s first, then one 4 or 2 for
    the rest of its power of two, then 3s and 5s (256 = 8·8·4, 200 = 8·5·5,
    240 = 8·2·3·5); None when n_fft is odd or under 4, or its half has
    another prime factor."""
    if n_fft % 2 or n_fft < 4:
        return None
    h, out = n_fft // 2, []
    while h % 8 == 0:
        out.append(8)
        h //= 8
    for r in (4, 2):
        if h % r == 0:
            out.append(r)
            h //= r
            break
    for r in (3, 5):
        while h % r == 0:
            out.append(r)
            h //= r
    return tuple(out) if h == 1 else None


@functools.lru_cache(maxsize=None)
def bluestein_dims(n_fft: int) -> tuple[int, int, int]:
    """(Q, K, P) of the Bluestein form: it computes the first K outputs of
    a Q-point DFT as a chirp-z convolution through a P-point Stockham FFT.
    Even n_fft packs the frame as n_fft/2 complex points (Q = K = n_fft/2,
    then the real split, as the Stockham form); odd n_fft transforms the
    n_fft real samples (Q = n_fft, K = n_bins). P is the cheapest size
    >= Q + K - 1 that the Stockham stages take (`radices(2P)`): fewest
    stages, then fewest points (404: P = 512 = 8·8·8; 551: 960 = 8·8·3·5)."""
    if n_fft % 2 == 0:
        q = k = n_fft // 2
    else:
        q, k = n_fft, n_fft // 2 + 1
    lo = max(q + k - 1, 2)
    # a power of two lies in [lo, 2 lo), and no size past 2 lo has fewer
    # stages; argmin takes the first of the fewest, the fewest points
    stages = _stage_counts(1 << (2 * lo + 1).bit_length())[lo : 2 * lo + 1]
    return q, k, lo + int(np.argmin(stages))


@functools.lru_cache(maxsize=None)
def _stage_counts(limit: int) -> np.ndarray:
    """Stages of the Stockham FFT of n points (`radices(2n)`) for n <
    limit, 99 where it takes none."""
    return np.array([len(r) if (r := radices(2 * n)) is not None else 99 for n in range(limit)])


@functools.lru_cache(maxsize=256)
def dft_form(cfg: FrontendConfig) -> str:
    """The kernel's DFT form for cfg's n_fft: "stockham" (an FFT of n_fft/2
    complex points in radices 8, 4, 2, 3 and 5, powers of two included);
    else "bluestein" (`bluestein_dims`), at every other n_fft. Where a form's
    rows do not fit a warp each, `fft_layout` gives the block plan."""
    return "stockham" if radices(cfg.n_fft) is not None else "bluestein"


def resolve_dft_passes(cfg: FrontendConfig, dft_passes: str = "radix4") -> str:
    """The dft_passes route actually taken (port of the reference's
    `resolve_dft_passes`): "radix4" becomes "fp32" for an n_fft that the
    radix (Stockham) form does not take, as the reference's does."""
    if dft_passes not in chain.DFT_PASSES:
        raise ValueError(f"dft_passes={dft_passes!r} not in {chain.DFT_PASSES}")
    if dft_passes == "radix4" and radices(cfg.n_fft) is None:
        return "fp32"
    return dft_passes


def kernel_form(cfg: FrontendConfig, dft_passes: str = "radix4") -> str:
    """The kernel's DFT form for cfg and a dft_passes route: "radix4" and
    "fp32" the full-fp32 form of `dft_form`, "bf16x3" the tensor-core
    form."""
    route = resolve_dft_passes(cfg, dft_passes)
    return "bf16x3" if route == "bf16x3" else dft_form(cfg)


def fft_points(n_fft: int, form: str) -> int:
    """Points of the form's Stockham FFT: n_fft/2 for "stockham", P of
    `bluestein_dims` for "bluestein"."""
    return n_fft // 2 if form == "stockham" else bluestein_dims(n_fft)[2]


def _stages(n_fft: int, form: str = "stockham"):
    """(radix R, points ns before the stage, butterflies n/R) of each stage
    of the form's n-point Stockham FFT (`fft_points`)."""
    n = fft_points(n_fft, form)
    ns, out = 1, []
    for R in radices(2 * n):
        out.append((R, ns, n // R))
        ns *= R
    return out


def split_count(n_fft: int) -> int:
    """Twiddles of the real split, e^{-2πik/n_fft} for k <= n_fft/4 (even
    n_fft; odd n_fft takes no split)."""
    return n_fft // 4 + 1 if n_fft % 2 == 0 else 0


def twiddle_count(n_fft: int, form: str) -> int:
    """Entries of the kernel's twiddle table for a DFT form: for the
    Stockham form the real split's n_fft/4 + 1, then (R - 1) twists for each
    butterfly of every stage after the first (whose twists are all 1); for
    the Bluestein form the split's (even n_fft), the P-point stages' twists,
    then the Q chirp values and the filter spectrum (`filter_count`);
    none for bf16x3."""
    if form == "bf16x3":
        return 0
    twists = sum(hr * (R - 1) for R, ns, hr in _stages(n_fft, form)[1:])
    if form == "stockham":
        return split_count(n_fft) + twists
    q, _, P = bluestein_dims(n_fft)
    return split_count(n_fft) + twists + q + filter_count(n_fft)


def filter_count(n_fft: int) -> int:
    """Entries of the Bluestein filter spectrum the kernel stages: P/2 + 1
    for even n_fft, whose chirp filter is even (b[P - m] = b[m] for every m,
    so its spectrum is too, and the kernel reads entry min(n, P - n)), all P
    for odd n_fft."""
    P = bluestein_dims(n_fft)[2]
    return P // 2 + 1 if n_fft % 2 == 0 else P


def bluestein_filter(n_fft: int) -> np.ndarray:
    """The Bluestein form's filter spectrum, complex128 [P]: conj(FFT_P(b))
    / P for the chirp filter b[m] = e^{+iπ m²/Q}, at m for 0 <= m < K and
    at P - m for 1 <= m < Q (m² mod 2Q exact in integers), so that the
    convolution's inverse FFT is the forward FFT of conj(A)·filter."""
    q, k, P = bluestein_dims(n_fft)
    m = np.arange(max(q, k), dtype=np.int64)
    b_m = np.exp(1j * np.pi * ((m * m) % (2 * q)).astype(np.float64) / q)
    b = np.zeros(P, np.complex128)
    b[:k] = b_m[:k]
    b[P - np.arange(1, q)] = b_m[1:q]
    return np.conj(np.fft.fft(b)) / P


def fft_twiddles(n_fft: int, form: str) -> np.ndarray:
    """[twiddle_count(n_fft, form), 2] float32 table (re, im), each entry
    computed in float64 and rounded once (none for bf16x3). Stockham:
    e^{-2πik/n_fft} for k <= n_fft/4 (the real split),
    then per stage s >= 1 of radix R after ns points, at j·(R-1) + r - 1 for
    butterfly j < n/R and input 1 <= r < R, the twist e^{-2πi·r·k/(ns·R)},
    k = j mod ns, so the kernel takes no remainder. Bluestein: the split
    (even n_fft) and the P-point stages' twists laid out so, then the chirp
    c[n] = e^{-iπ n²/Q} (n < Q, n² mod 2Q exact) and the first
    `filter_count` entries of `bluestein_filter`."""
    if form == "bf16x3":
        return np.zeros((0, 2), np.float32)
    parts = [2.0 * np.pi * np.arange(split_count(n_fft), dtype=np.float64) / n_fft]
    for R, ns, hr in _stages(n_fft, form)[1:]:
        rk = (np.arange(hr)[:, None] % ns) * np.arange(1, R)[None, :]
        parts.append((2.0 * np.pi * (rk % (ns * R)) / (ns * R)).ravel())
    if form == "bluestein":
        q = bluestein_dims(n_fft)[0]
        n = np.arange(q, dtype=np.int64)
        parts.append(np.pi * ((n * n) % (2 * q)).astype(np.float64) / q)
    ang = np.concatenate(parts)
    tab = np.stack([np.cos(ang), -np.sin(ang)], axis=-1)
    if form == "bluestein":
        filt = bluestein_filter(n_fft)[: filter_count(n_fft)]
        tab = np.concatenate([tab, np.stack([filt.real, filt.imag], axis=-1)])
    return tab.astype(np.float32)


def stage_bases(n_fft: int, form: str = "stockham") -> np.ndarray:
    """int32 table of the form's Stockham stages' output bases, stage after
    stage: butterfly j < n/R of a stage after ns points writes its R outputs
    at (j - k)·R + k + r·ns, k = j mod ns; the table holds (j - k)·R + k.
    Empty for the bf16x3 form."""
    if form == "bf16x3":
        return np.zeros(0, np.int32)
    out = [(np.arange(hr) - np.arange(hr) % ns) * R + np.arange(hr) % ns
           for R, ns, hr in _stages(n_fft, form)]
    return np.concatenate(out).astype(np.int32)


def cluster_dims(n_fft: int, form: str, C: int) -> tuple[int, int, int] | None:
    """(H2, J, PB) of the cluster plan at C blocks a frame: the form's
    n-point FFT (`fft_points`) as C FFTs of H2 = n/C points, one a rank,
    then one radix-C pass across the cluster, its butterflies J = H2/C a
    rank; PB = ceil(n_bins / C) power bins a rank. None where n is not a
    multiple of C²."""
    n = fft_points(n_fft, form)
    if n % (C * C):
        return None
    return n // C, n // (C * C), -(-(n_fft // 2 + 1) // C)


def _local_stages(n_fft: int, form: str, C: int):
    """(radix R, points ns before the stage, butterflies H2/R) of each stage
    of the cluster plan's H2-point local FFT."""
    h2 = cluster_dims(n_fft, form, C)[0]
    ns, out = 1, []
    for R in radices(2 * h2):
        out.append((R, ns, h2 // R))
        ns *= R
    return out


def cluster_twiddles(n_fft: int, form: str, C: int, dtype=np.float32) -> np.ndarray:
    """[n, 2] float32 table (re, im) of the cluster plan at C blocks a
    frame (`dtype` float64: unrounded), each entry computed in float64 and
    rounded once: the real split's
    e^{-2πik/n_fft}, k <= n_fft/4 (even n_fft); the H2-point local FFT's
    stage twists laid out as `fft_twiddles` lays out a form's; for the
    Bluestein form the chirp and the filter spectrum as there; then the
    exchange's twists e^{-2πi·r·k1/n} of rank r = 1 .. C-1 at (r - 1)·H2 + k1,
    k1 < H2 (n = `fft_points`, r·k1 mod n exact in integers)."""
    n = fft_points(n_fft, form)
    h2 = cluster_dims(n_fft, form, C)[0]
    parts = [2.0 * np.pi * np.arange(split_count(n_fft), dtype=np.float64) / n_fft]
    for R, ns, hr in _local_stages(n_fft, form, C)[1:]:
        rk = (np.arange(hr)[:, None] % ns) * np.arange(1, R)[None, :]
        parts.append((2.0 * np.pi * (rk % (ns * R)) / (ns * R)).ravel())
    if form == "bluestein":
        q = bluestein_dims(n_fft)[0]
        m = np.arange(q, dtype=np.int64)
        parts.append(np.pi * ((m * m) % (2 * q)).astype(np.float64) / q)
    ang = np.concatenate(parts)
    tab = [np.stack([np.cos(ang), -np.sin(ang)], axis=-1)]
    if form == "bluestein":
        filt = bluestein_filter(n_fft)[: filter_count(n_fft)]
        tab.append(np.stack([filt.real, filt.imag], axis=-1))
    rk = (np.arange(1, C, dtype=np.int64)[:, None] * np.arange(h2)[None, :]) % n
    ang = (2.0 * np.pi * rk / n).ravel()
    tab.append(np.stack([np.cos(ang), -np.sin(ang)], axis=-1))
    return np.concatenate(tab).astype(dtype)


def cluster_bases(n_fft: int, form: str, C: int) -> np.ndarray:
    """int32 output bases of the cluster plan's local FFT (`stage_bases`'
    layout for its H2 points)."""
    out = [(np.arange(hr) - np.arange(hr) % ns) * R + np.arange(hr) % ns
           for R, ns, hr in _local_stages(n_fft, form, C)]
    return np.concatenate(out).astype(np.int32)


BF16_STEP = 16  # K of one wgmma step: one k16 slice of the matrix a ring stage
BF16_PASS_BINS = 136  # bins a pass: two m64n136k16 products over 272 interleaved columns
BF16_TILES = (64, 32)  # frames a block of the staged plan, the first whose layout fits
BF16_BLOCK_TILE = 128  # frames a block of the block plans (csrc/frontend.cu kBfTile)
BF16_STAGES = (4, 3, 2)  # ring stages, the first whose layout fits
BF16_BLOCK_THREADS = 384  # the block plans' kernel: two consumer warpgroups, the producer and projectors
# the bf16x3 form's plans (csrc/frontend.cu plan_bf16, kBfLadder): the power
# rows of every bin; then the block plans, each pass of 136 bins projected
# into per-frame accumulators while the next one's products run, the tile's
# A (the conditioned frames' bf16 hi and lo) built once: in shared memory;
# in the tile's rows of a workspace in device memory, streamed through the
# ring beside the matrix; the same with the packed bands and the pass table
# read from device memory too; and with the accumulators in the workspace
# too
BF16_PLANS = ("staged", "pass", "gather", "gather_bands", "gather_out")
# what each bf16x3 plan does (csrc/frontend.cu kBfLadder): (a block plan,
# the tile's A in the workspace, the packed bands and the pass table from
# device memory, the accumulators in the workspace)
BF16_TRAITS = {
    "staged": (False, False, False, False),
    "pass": (True, False, False, False),
    "gather": (True, True, False, False),
    "gather_bands": (True, True, True, False),
    "gather_out": (True, True, True, True),
}
# (plan, frames a block, ring stages) in the order bf16_layout tries them:
# the staged plan, then the block plans
BF16_LAYOUTS = (tuple(("staged", t, s) for t in BF16_TILES for s in BF16_STAGES)
                + tuple((plan, BF16_BLOCK_TILE, s) for plan in BF16_PLANS[1:] for s in BF16_STAGES))
# the block plans: steps whose products the tensor cores sum before the sum
# joins the pass's re/im rows in fp32 (csrc/frontend.cu kBfPromote); the
# floats between two frames' re/im rows, over which the pass's powers go,
# and between two frames' power rows; the bytes of one frame's A a step
BF16_PROMOTE = 25
BF16_PASS_STRIDE = 2 * BF16_PASS_BINS + 8
BF16_POWER_STRIDE = BF16_PASS_BINS + 1
BF16_A_CHUNK = 2 * BF16_STEP * 2
BF16_MATRIX_CACHE_BYTES = 2 << 30  # the card's matrices kept at once (`_device_bf16_matrix`)


def bf16_dims(cfg: FrontendConfig) -> tuple[int, int]:
    """(kp, nbp) of the bf16x3 form: min(frame_length, n_fft) rounded up to
    the wgmma step's 16, and n_bins rounded up to whole passes of 136 bins."""
    kp = -(-min(cfg.frame_length, cfg.n_fft) // BF16_STEP) * BF16_STEP
    return kp, -(-cfg.n_bins // BF16_PASS_BINS) * BF16_PASS_BINS


def bf16_power_stride(cfg: FrontendConfig) -> int:
    """Floats of a power row of the bf16x3 form: n_bins rounded up to 32,
    plus 4, so the 8 frames a wgmma fragment stores to fall in 8 bank groups."""
    return (cfg.n_bins + 31) // 32 * 32 + 4


def bf16_matrix_bytes(cfg: FrontendConfig) -> tuple[int, int]:
    """(bytes of `bf16_matrix` on the card, 8·kp·nbp; bytes of the host's
    float64 folding it starts from, `constants.folded_dft`'s [min(L, n_fft),
    2·n_bins] float64)."""
    kp, nbp = bf16_dims(cfg)
    return 8 * kp * nbp, 16 * min(cfg.frame_length, cfg.n_fft) * cfg.n_bins


def bf16_matrix_reason(cfg: FrontendConfig, device_bytes: int) -> str | None:
    """Why the bf16x3 route cannot run cfg on a card of `device_bytes` of
    memory, or None: its matrix, or the float64 folding the host builds it
    from, is over the card's memory (`bf16_matrix_bytes`). The route reads
    O(n_fft · L) bytes a frame by design; this first happens near n_fft = L
    = 131,072 on an 80 GB card. A resampling config is held to its feature
    rate's matrix, as `layout_reason` holds it."""
    if chain.resamples(cfg):
        cfg = feature_rate_config(cfg)
    matrix, folded = bf16_matrix_bytes(cfg)
    if max(matrix, folded) <= device_bytes:
        return None
    return (f"bf16x3 matrix of {matrix:,} bytes, folded from {folded:,} bytes of float64 on the host "
            f"(n_fft={cfg.n_fft}, frame length {cfg.frame_length}), over the card's {device_bytes:,} bytes")


def bf16_matrix(cfg: FrontendConfig) -> torch.Tensor:
    """The bf16x3 form's matrix (csrc/frontend.cu dft_matrix), one bf16
    tensor in the order the ring's bulk copies and wgmma's shared-memory
    descriptors read it: [pass][k16 step][hi | lo][8-column group (34)]
    [K half (2)][column (8)][k (8)], so each (pass, step) is one contiguous
    17,408-byte chunk of K-major core matrices (8 columns x 16 bytes).
    Column c of pass p is bin p·136 + c/2, its cosine for even c and its sine
    for odd c (re and im of a bin in adjacent columns); hi and lo are the
    `bf16_split` parts of `constants.folded_dft`, rows past min(L, n_fft)
    and bins past n_bins zero."""
    k = constants.folded_dft(cfg)
    kp, nbp = bf16_dims(cfg)
    le, nb = k["dft"].shape[0], cfg.n_bins
    steps, passes, groups = kp // BF16_STEP, nbp // BF16_PASS_BINS, 2 * BF16_PASS_BINS // 8
    out = []
    for part in (k["dft_hi"], k["dft_lo"]):
        m = np.zeros((kp, nbp, 2), np.float32)  # [k, bin, cos | sin]
        m[:le, :nb, 0], m[:le, :nb, 1] = part[:, :nb], part[:, nb:]
        m = m.reshape(steps, 2, 8, passes, groups, 8)  # [step, half, k, pass, group, column]
        out.append(m.transpose(3, 0, 4, 1, 5, 2))  # [pass, step, group, half, column, k]
    m = np.stack(out, axis=2)  # [pass, step, hi | lo, group, half, column, k]
    return torch.from_numpy(np.ascontiguousarray(m).reshape(-1)).to(torch.bfloat16)


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


def mel_packed(mel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The nonzero bands of mel [n_bins, M], packed filter after filter:
    (off [M+1] int32, index [n_packed] int64). Filter m's weights are its
    band [lo, hi) of `mel_bands`, at packed positions off[m] <= i <
    off[m+1]; an all-zero column keeps one zero weight at bin 0, so every
    filter owns at least one entry. `index` is each entry's flat position in
    mel (bin·M + m), for gathering mel and melf."""
    lo, hi = mel_bands(mel)
    width = torch.clamp(hi - lo, min=1).long()
    off = torch.zeros(mel.shape[1] + 1, dtype=torch.int64)
    off[1:] = torch.cumsum(width, 0)
    m = torch.repeat_interleave(torch.arange(mel.shape[1]), width)
    k = lo.long()[m] + torch.arange(int(off[-1])) - off[m]
    return off.to(torch.int32), k * mel.shape[1] + m


def packed_meta(off: torch.Tensor, index: torch.Tensor, M: int) -> torch.Tensor:
    """int32 [n_packed] per packed weight (csrc/frontend.cu Bands::meta): its
    bin (index // M, all 31 bits), the sign bit set on each filter's last
    weight, so the projection finds a weight's bin and the end of its filter
    with one load. No word names a filter: a lane finds the filter its chunk
    starts in by a binary search of `off` (csrc/frontend.cu filter_of) and
    counts the ends from there."""
    meta = index // M
    last = torch.zeros_like(meta, dtype=torch.bool)
    last[off[1:].long() - 1] = True
    return torch.where(last, meta - (1 << 31), meta).to(torch.int32)


def chunk(n_packed: int, lanes: int = 32) -> int:
    """Packed weights a lane sums in the balanced projection: n_packed over
    the warp's 32 lanes (`lanes`: a block-plan group's 64, 128 or 256
    threads), rounded up to an odd count, so that the lanes' first weights
    fall in 32 distinct shared-memory banks."""
    return -(-n_packed // lanes) | 1


def _tables(consts: dict[str, torch.Tensor], device) -> dict[str, torch.Tensor]:
    """The kernel's tables on `device`: the float32 window and the packed
    mel bands (`mel_packed`: the weights "mel_w", SSC's "melf_w" = f_k·mel[k,
    m] formed in float64 and rounded once, the offsets "mel_off" and
    `packed_meta` "mel_meta")."""
    mel = consts["mel"].to(device="cpu", dtype=torch.float32)
    off, index = mel_packed(mel)
    melf = consts["freqs"].double().cpu()[:, None] * consts["mel"].double().cpu()
    return {
        "window": consts["window"].to(device=device, dtype=torch.float32).contiguous(),
        "mel_w": mel.reshape(-1)[index].to(device).contiguous(),
        "melf_w": melf.reshape(-1)[index].to(device=device, dtype=torch.float32).contiguous(),
        "mel_off": off.to(device),
        "mel_meta": packed_meta(off, index, mel.shape[1]).to(device),
    }


@functools.lru_cache(maxsize=16)
def _device_tables(cfg: FrontendConfig, device: torch.device):
    return _tables(chain.device_constants(cfg, torch.device("cpu"), torch.float64), device)


@functools.lru_cache(maxsize=16)
def _device_fft_tables(n_fft: int, form: str, device: torch.device, cluster: int = 0):
    if cluster:
        return (torch.as_tensor(cluster_twiddles(n_fft, form, cluster), device=device),
                torch.as_tensor(cluster_bases(n_fft, form, cluster), device=device))
    return (torch.as_tensor(fft_twiddles(n_fft, form), device=device),
            torch.as_tensor(stage_bases(n_fft, form), device=device))


_bf16_matrices: collections.OrderedDict = collections.OrderedDict()
_bf16_matrices_lock = threading.Lock()


def _device_bf16_matrix(cfg: FrontendConfig, device: torch.device) -> torch.Tensor:
    """cfg's `bf16_matrix` on `device`, cached least recently used first out
    once the cache holds over BF16_MATRIX_CACHE_BYTES (the newest is always
    kept): at librosa's 16,384-point framing one matrix is 1.1 GB."""
    key = (cfg, device)
    with _bf16_matrices_lock:
        m = _bf16_matrices.pop(key, None)
        if m is None:
            m = bf16_matrix(cfg).to(device).contiguous()
        _bf16_matrices[key] = m
        while len(_bf16_matrices) > 1 and sum(
                t.numel() * t.element_size() for t in _bf16_matrices.values()) > BF16_MATRIX_CACHE_BYTES:
            _bf16_matrices.popitem(last=False)
    return m


def pass_table(mel: torch.Tensor) -> torch.Tensor:
    """The bf16x3 block plans' pass table of mel [n_bins, M] (csrc/frontend.cu
    4p), int32: npass + 1 offsets, then for each pass p (bins [136p, 136p +
    136)) in turn, filter by filter, one segment of 4 words for each filter
    whose packed band (`mel_packed`: [lo, hi), one weight at bin 0 for an
    all-zero filter) touches the pass: (filter m, first and end packed index
    of its weights in the pass, the first one's bin less 136p). Segments s of
    pass p are offsets[p] <= s < offsets[p + 1]."""
    n_bins, M = mel.shape
    npass = -(-n_bins // BF16_PASS_BINS)
    lo, hi = mel_bands(mel)
    off, _ = mel_packed(mel)
    lo = lo.long()
    hi = lo + torch.clamp(hi.long() - lo, min=1)
    first, last = lo // BF16_PASS_BINS, (hi - 1) // BF16_PASS_BINS
    count = last - first + 1
    m = torch.repeat_interleave(torch.arange(M), count)
    start = torch.cumsum(count, 0) - count
    ps = first[m] + torch.arange(int(count.sum())) - start[m]
    order = torch.argsort(ps * M + m)
    m, ps = m[order], ps[order]
    kl = torch.maximum(lo[m], ps * BF16_PASS_BINS)
    kh = torch.minimum(hi[m], ps * BF16_PASS_BINS + BF16_PASS_BINS)
    base = off.long()[m] - lo[m]
    segs = torch.stack([m, base + kl, base + kh, kl - ps * BF16_PASS_BINS], dim=1)
    offsets = torch.zeros(npass + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(torch.bincount(ps, minlength=npass), 0)
    return torch.cat([offsets, segs.reshape(-1)]).to(torch.int32)


def pass_table_words(cfg: FrontendConfig) -> int:
    """Words the bf16x3 block plans stage for cfg's pass table
    (csrc/frontend.cu Params::nptab), an upper bound of `pass_table`'s:
    npass + 1 offsets and 4 words for each of at most n_packed // 136 + 2M
    segments (a filter of w weights touches at most w // 136 + 2 passes);
    none for a spectrogram."""
    if not mel_matrices(cfg):
        return 0
    npass = -(-cfg.n_bins // BF16_PASS_BINS)
    return npass + 1 + 4 * (packed_count(cfg) // BF16_PASS_BINS + 2 * cfg.n_mels)


@functools.lru_cache(maxsize=16)
def _device_pass_table(cfg: FrontendConfig, device: torch.device) -> torch.Tensor:
    mel = chain.device_constants(cfg, torch.device("cpu"), torch.float64)["mel"]
    return pass_table(mel.to(torch.float32)).to(device)


def bf16_accumulators(cfg: FrontendConfig) -> int:
    """Accumulators a frame of the bf16x3 block plans (csrc/frontend.cu
    Params::nacc): M filter sums and the energy; for SSC the M mel and the M
    melf sums (its lane M is 0); for a spectrogram the energy alone (its
    bins go straight to their lanes)."""
    kind = feature_kind(cfg)
    return 2 * cfg.n_mels if kind == "ssc" else 1 if kind == "spectrogram" else cfg.n_mels + 1


def bf16_workspace(cfg: FrontendConfig, B: int, F: int, int16: bool = True) -> int:
    """Floats of the bf16x3 block plans' workspace for B rows of F frames
    (csrc/frontend.cu bf16_workspace): under "gather_out" the accumulators
    [B, F, `bf16_accumulators`], rounded up to 128 bytes; then, past "pass",
    each tile's A, tile x kp floats (bf16 hi and lo of kp samples a frame);
    0 for "staged" and "pass"."""
    plan, tile, _ = bf16_layout(cfg, int16)
    block, gather, _, acc_dev = BF16_TRAITS[plan]
    if not block:
        return 0
    acc = -(-B * F * bf16_accumulators(cfg) // 32) * 32 if acc_dev else 0
    return acc + (B * -(-F // tile) * tile * bf16_dims(cfg)[0] if gather else 0)


@functools.lru_cache(maxsize=None)
def packed_count(cfg: FrontendConfig) -> int:
    """Entries of cfg's packed mel table (`mel_packed`): each filter's band
    of `mel_bands`, one entry for an all-zero filter. Cached without bound
    (an int a config): each count builds the dense filterbank, and a sweep
    over more configs than a bounded cache holds would rebuild every one."""
    nz = constants.mel_filterbank(cfg) != 0
    hi = np.where(nz, np.arange(nz.shape[0])[:, None] + 1, 0).max(axis=0)
    lo = np.where(nz, np.arange(nz.shape[0])[:, None], nz.shape[0]).min(axis=0)
    return int(np.maximum(np.where(hi > 0, hi - lo, 0), 1).sum())


def row_floats(n_fft: int, form: str) -> int:
    """Floats of each of the two rows of a warp (or of the block plan) in
    the Stockham and Bluestein forms: n + n/8 + 1 float2 (n =
    `fft_points`), the stages' rows with a float2 of padding after every 8,
    whose free row then takes the n_fft/2 + 1 powers."""
    h = fft_points(n_fft, form)
    return (2 * (h + h // 8 + 1) + 3) & ~3


def _a4(n: int) -> int:
    return (n + 3) & ~3


def _a32(n: int) -> int:
    return (n + 31) & ~31


def _bf16_smem(cfg: FrontendConfig, plan: str, tile: int, stages: int, int16: bool = True) -> int:
    """Shared memory per block of cfg's bf16x3 layout in a plan of
    `BF16_PLANS` at `tile` frames and `stages` ring stages, for int16 or
    float32 rows. "staged" (csrc/frontend.cu layout): the signal row, the
    window and the packed bands, then the ring at a 128-byte boundary and
    its mbarriers, the power rows of every bin, the frame energies and means
    and the per-warp projection scratch, which the fused resample's input
    window overlays, widening them only where it is longer, then its tap
    table. The block plans (csrc/frontend.cu bf16_block_layout): the packed
    weights (and SSC's melf weights), the filters' offsets and the pass
    table unless they are read from device memory; at a 128-byte boundary the ring, each stage a matrix
    chunk and, where A is in the workspace, the tile's A of that step; its
    mbarriers and the projection's claim counter; at a 128-byte boundary the
    tile's A ("pass"); one pass's power rows (stride 137), or where a pass
    takes more than BF16_PROMOTE steps its re/im rows (stride 280); the
    frames' energies and means; the accumulators (`bf16_accumulators`) unless
    they are in device memory. The block plans stage no signal and no
    window: A is built from device memory."""
    block, gather, bands_dev, acc_dev = BF16_TRAITS[plan]
    ring = 2 * BF16_STEP * 2 * BF16_PASS_BINS // 2  # a stage's matrix chunk: hi and lo, bf16 in floats
    if block:
        kp = bf16_dims(cfg)[0]
        tables = mel_matrices(cfg)
        n = (tables * _a4(packed_count(cfg)) + _a4(cfg.n_mels + 1) + _a4(pass_table_words(cfg))
             if tables and not bands_dev else 0)
        n = _a32(n) + stages * (ring + (tile * BF16_A_CHUNK // 4 if gather else 0)) + 4 * stages + 4
        n = _a32(n) + (0 if gather else tile * kp)
        rows = BF16_PASS_STRIDE if kp // BF16_STEP > BF16_PROMOTE else BF16_POWER_STRIDE
        return 4 * (n + tile * rows + 2 * tile + (0 if acc_dev else _a4(tile * bf16_accumulators(cfg))))
    head = _a4(_span(cfg, tile) + _wide(cfg)) + _a4(max(cfg.frame_length, cfg.n_fft)) + _bands(cfg)
    n = _a32(head) + stages * ring + _a4(4 * stages)
    fir, taps = _fir_floats(cfg, tile, int16)
    rows = tile * bf16_power_stride(cfg) + 2 * _a4(tile) + WARPS * _a4(mel_matrices(cfg) * (32 + cfg.n_mels))
    return 4 * (n + max(rows, _a4(fir)) + _a4(taps))


def _span(cfg: FrontendConfig, tile: int) -> int:
    return (tile - 1) * cfg.frame_step + cfg.frame_length


def _wide(cfg: FrontendConfig) -> bool:
    """True when the signal row holds one more float, x[t0-1 .. t0+span)
    before pre-emphasis: the fused resample, and the dither's staging."""
    return chain.resamples(cfg) or cfg.dither > 0.0


def _bands(cfg: FrontendConfig) -> int:
    """Floats of the packed mel bands: the weights (and SSC's melf
    weights), the filter offsets and `packed_meta`; none for a
    spectrogram."""
    tables = mel_matrices(cfg)
    if not tables:  # a spectrogram's identity: nothing packed (and no identity matrix built)
        return 0
    return (tables + 1) * _a4(packed_count(cfg)) + _a4(cfg.n_mels + 1)


def _head(cfg: FrontendConfig, tile: int) -> int:
    """Floats of the layout's head: the signal row (one more float when
    `_wide`), the window and the packed mel bands."""
    return _a4(_span(cfg, tile) + _wide(cfg)) + _a4(max(cfg.frame_length, cfg.n_fft)) + _bands(cfg)


def _fir_floats(cfg: FrontendConfig, tile: int, int16: bool) -> tuple[int, int]:
    """(window, taps) floats of the fused resample at `tile` frames a block:
    its input window in the rows' type (`rs_kernel.stage_floats`) and its
    tap table [up, table_stride]; (0, 0) for a config at its feature rate."""
    if not chain.resamples(cfg):
        return 0, 0
    d = R.polyphase_design(*R.ratio(cfg.input_sample_rate, cfg.sample_rate))
    window = rs_kernel.stage_floats(resample_window(cfg, tile), 2 if int16 else 4)
    return window, d["up"] * rs_kernel.table_stride(d)


@functools.lru_cache(maxsize=256)
def bf16_layout(cfg: FrontendConfig, int16: bool = False) -> tuple[str, int, int]:
    """(plan, frames a block, ring stages) of the bf16x3 form for int16 or
    float32 rows (csrc/frontend.cu plan_bf16): the first of `BF16_LAYOUTS`
    whose layout fits the block. "staged" at 64 or 32 frames (a wgmma's 64
    rows; at 32 the upper 32 are zero) and 4, 3 or 2 stages: the tile's
    span, window, packed bands and power rows of every bin (in the fused
    resample with its input window of that many frames and its taps). Where
    those are over the block (n_fft from 2,245 at classic13, long hops and
    frames), the plain form's block plans at 128 frames (two consumer
    warpgroups of 64), each pass of 136 bins projected into per-frame
    accumulators while the next one's products run: "pass", the tile's A in shared memory; "gather", A in the
    tile's rows of the workspace, streamed through the ring; "gather_bands",
    the packed bands and the pass table read from device memory too;
    "gather_out", the accumulators in the workspace too (thousands of
    filters). A resampling config's fused form takes "staged" alone (else
    its smallest, and the wrapper takes the split route,
    `resample_route`)."""
    layouts = BF16_LAYOUTS[: len(BF16_TILES) * len(BF16_STAGES)] if chain.resamples(cfg) else BF16_LAYOUTS
    for plan, tile, stages in layouts:
        if _bf16_smem(cfg, plan, tile, stages, int16) <= rs_kernel.SMEM_BUDGET_BYTES:
            return plan, tile, stages
    return layouts[-1]


def bf16_plan(cfg: FrontendConfig, int16: bool = False) -> tuple[int, int]:
    """(frames a block, ring stages) of `bf16_layout`."""
    return bf16_layout(cfg, int16)[1:]


def resample_window(cfg: FrontendConfig, tile: int = TILE) -> int:
    """Input samples of the fused resample's window a block of `tile`
    frames stages: the FIR's window for x[t0-1 .. t0+span) (csrc/frontend.cu
    resample_window)."""
    d = R.polyphase_design(*R.ratio(cfg.input_sample_rate, cfg.sample_rate))
    return rs_kernel.fir_window(_span(cfg, tile) + 1, d)


def _fft_smem(cfg: FrontendConfig, form: str, plan: str, int16: bool = True, groups: int = 1) -> int:
    """Shared memory per block of cfg's layout in the Stockham or Bluestein
    form, a plan of `FFT_PLANS` and, for the block plans, `groups` frames a
    block at once, for int16 or float32 rows (csrc/frontend.cu layout): the
    head (for the gather plans no span and no window; none of it for
    "gather_bands", "gather_rows" and "gather_sums", which read the packed
    bands from device memory), the twiddles and the stages' output bases (none staged
    where `PLAN_TRAITS` reads the tables from device memory), then for
    "warp" per warp two rows and the projection's scratch (32 lane partials
    and M sums a weight table), which the fused resample's input window
    overlays, widening them only where it is longer, and the resample's
    taps; for the block plans per group two rows (none for "gather_rows"
    and "gather_sums": a workspace in device memory holds them,
    `rows_workspace`) and the projection's scratch (256 / groups thread
    partials and M sums a weight table; the partials alone for
    "gather_sums", whose sums are in device memory), then the 8 warps'
    partials of a group sum."""
    if plan == "cluster":  # its layout at `groups` blocks a frame
        return cluster_smem(cfg, form, groups)
    if plan == "wide":  # its layout at a tile of `groups` frames
        return wide_smem(cfg, form, wide_groups(cfg, form, groups), groups)
    N, M, tables = cfg.n_fft, cfg.n_mels, mel_matrices(cfg)
    gather, tables_dev, bands_dev, rows_dev, sums_dev = PLAN_TRAITS.get(plan, (False,) * 5)
    n = 0 if bands_dev else _bands(cfg) if gather else _head(cfg, TILE)
    if not tables_dev:
        n += _a4(2 * twiddle_count(N, form)) + _a4(sum(hr for _, _, hr in _stages(N, form)))
    fir, taps = _fir_floats(cfg, TILE, int16)
    if plan == "warp":
        rows = WARPS * (2 * row_floats(N, form) + _a4(tables * (32 + M)))
    else:
        rows = groups * (0 if rows_dev else 2 * row_floats(N, form))
        rows += groups * _a4(tables * (THREADS // groups + (0 if sums_dev else M))) + WARPS
    return 4 * (n + max(rows, fir) + _a4(taps))


CLUSTER_REFUSED = 1 << 40  # `cluster_smem` of a cluster size the FFT does not split into


def cluster_smem(cfg: FrontendConfig, form: str, C: int) -> int:
    """Shared memory per block of cfg's cluster plan at C blocks a frame
    (csrc/frontend.cu cluster_layout): each rank's
    two rows of its H2 points (`row_floats`' padding), the projection's 256
    thread partials and M filter partials a weight table, the 8 warps'
    partials, 4 slots of the rank's sums and 16 words of the ranks' filter
    ranges; CLUSTER_REFUSED where the form's FFT does not split C x C
    (`cluster_dims`)."""
    dims = cluster_dims(cfg.n_fft, form, C)
    if dims is None:
        return CLUSTER_REFUSED
    h2, tables = dims[0], mel_matrices(cfg)
    row = (2 * (h2 + h2 // 8 + 1) + 3) & ~3
    return 4 * (2 * row + tables * THREADS + _a4(tables * cfg.n_mels) + WARPS + 4 + 16)


def wide_smem(cfg: FrontendConfig, form: str, groups: int, tile: int) -> int:
    """Shared memory per block of cfg's wide plan (csrc/frontend.cu
    wide_layout): each of `groups` groups' two FFT rows (`row_floats`), the
    tile's `tile` power rows (bins rounded up to 4 floats), their energy
    lanes and the 8 warps' partials of a group sum."""
    return 4 * (groups * 2 * row_floats(cfg.n_fft, form) + tile * _a4(cfg.n_bins) + _a4(tile) + WARPS)


def wide_groups(cfg: FrontendConfig, form: str, tile: int) -> int:
    """Groups (frames at once) of the wide plan's FFT stage at a tile of
    `tile` frames (csrc/frontend.cu plan_wide): the first of 4, 2 and 1 whose
    layout fits the block; 0 where none does."""
    budget = rs_kernel.SMEM_BUDGET_BYTES
    return next((g for g in (4, 2, 1) if wide_smem(cfg, form, g, tile) <= budget), 0)


def wide_layout(cfg: FrontendConfig, form: str | None = None) -> tuple[int, int] | None:
    """(groups, tile) of cfg's wide plan: its FFT stage's groups
    (`wide_groups` at one frame), then the most frames whose power rows fit
    beside them in WIDE_TWO_BLOCKS bytes (two blocks an SM), else in the
    block, at most WIDE_MAX_TILE; None where one frame does not fit, or cfg
    has no weights (a spectrogram)."""
    form = form or dft_form(cfg)
    groups = wide_groups(cfg, form, 1)
    if not groups or not mel_matrices(cfg):
        return None
    fixed = wide_smem(cfg, form, groups, 0)
    for budget in (WIDE_TWO_BLOCKS, rs_kernel.SMEM_BUDGET_BYTES):
        tile = min(WIDE_MAX_TILE, (budget - fixed) // (4 * _a4(cfg.n_bins) + 4))
        while tile > 0 and wide_smem(cfg, form, groups, tile) > budget:  # the energies' rounding
            tile -= 1
        if tile > 0:
            return groups, tile
    return None


def wide_tile(tile: int, frames: int, slots: int) -> int:
    """The wide plan's tile for a launch of `frames` frames (B x F) on a card
    that holds `slots` of its blocks at once: its layout's `tile`, or fewer,
    so that the launch's blocks fill the card's slots once (at least one
    frame a block)."""
    return max(1, min(tile, -(-frames // slots)))


@functools.lru_cache(maxsize=64)
def _wide_slots(cfg: FrontendConfig, int16: bool, device: torch.device) -> int:
    """Blocks of cfg's wide-plan instantiation (a config at its feature rate)
    at its layout that the card holds at once: its SMs times the blocks an
    SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    form = dft_form(cfg)
    groups, tile = wide_layout(cfg, form)
    with torch.cuda.device(device):
        n = _wide_info(cfg, int16, tile, wide_smem(cfg, form, groups, tile))["blocks_per_sm"]
    return max(1, n) * torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def fft_layout(cfg: FrontendConfig, form: str | None = None, int16: bool = True,
               cluster: bool = True, wide: bool = True) -> tuple[str, int]:
    """(plan, frames a block transforms at once) of cfg's Stockham or
    Bluestein form (mirrors csrc/frontend.cu plan and plan_block): the first
    of `FFT_LAYOUTS` whose layout fits the block. "warp": each of the 8
    warps a frame through its own two rows. Else "block": the block's
    threads in 4, 2 or 1 groups, each taking a frame at a time through two
    rows of its own, each stage's butterflies spread over the group, the
    tables staged; else "block_global", the same with the twiddles, chirp,
    filter spectrum and stage bases read from device memory; else "gather"
    and "gather_global", the same two with no span and no window staged,
    each group reading its frame from device memory (a layout that depends
    on neither the hop nor the frame length); else, at FFTs of
    CLUSTER_MIN_POINTS[form] points or more, "cluster" (the second value its
    blocks a frame, the first of `CLUSTER_SIZES` whose layout fits: each
    frame's FFT rows split over a thread-block cluster's shared memory,
    `cluster_smem`); else "gather_bands", the
    packed mel bands read from device memory too (Stockham to n_fft 25,600,
    Bluestein to P = 12,800); else "gather_rows", each group's two FFT rows
    in a workspace in device memory (`rows_workspace`): its layout, the
    groups' projection scratch alone, depends on the filters and nothing
    else; else "gather_sums" (from 57,849 filters at one group, 28,797 for
    SSC), the projection's filter sums in the output row and SSC's melf
    sums in the workspace: its layout, the thread partials alone, fits at
    any filter count, so one plan always fits. Then the wide plan ("wide",
    the second value its tile of frames a block, `wide_layout`) takes every
    config that ladder gives "gather_sums" and, by its rule, those it gives
    "gather_bands" or "gather_rows" at WIDE_MIN_FILTERS filters or more,
    wherever one frame's power row fits beside its FFT rows (n_fft to
    ~21,000; past it "gather_sums" stays). The fused resample takes
    "warp" only: a resampling config whose fused layout is over the block
    takes the split route (`resample_route`), whose plain form plans at the
    feature rate. cluster=False: the ladder without the cluster plan (the
    plan a launch takes when it asks for none); wide=False: without the
    wide plan."""
    form = form or dft_form(cfg)
    if chain.resamples(cfg):
        return FFT_LAYOUTS[0]
    layout = FFT_LAYOUTS[-1]
    for plan, groups in FFT_LAYOUTS:
        if plan == "cluster" and not (cluster and fft_points(cfg.n_fft, form) >= CLUSTER_MIN_POINTS[form]):
            continue
        if _fft_smem(cfg, form, plan, int16, groups) <= rs_kernel.SMEM_BUDGET_BYTES:
            layout = plan, groups
            break
    if wide and (layout[0] == "gather_sums" or layout[0] in ("gather_bands", "gather_rows")
                 and cfg.n_mels >= WIDE_MIN_FILTERS):
        shape = wide_layout(cfg, form)
        if shape is not None:
            return "wide", shape[1]
    return layout


def fft_plan(cfg: FrontendConfig, form: str | None = None, int16: bool = True) -> str:
    """The plan of `fft_layout`, one of `FFT_PLANS`."""
    return fft_layout(cfg, form, int16)[0]


def _smem(cfg: FrontendConfig, form: str, int16: bool = True) -> int:
    """Shared memory per block of cfg's layout in a given DFT form, for
    int16 or float32 rows (csrc/frontend.cu layout); the Stockham and
    Bluestein forms in the plan of `fft_layout`."""
    if form == "bf16x3":
        return _bf16_smem(cfg, *bf16_layout(cfg, int16), int16)
    plan, groups = fft_layout(cfg, form, int16)
    return _fft_smem(cfg, form, plan, int16, groups)


@functools.lru_cache(maxsize=64)
def smem_bytes(cfg: FrontendConfig, dft_passes: str = "radix4", int16: bool = True) -> int:
    """Shared memory per block for cfg (csrc/frontend.cu layout) with int16
    or float32 rows, cached (`layout_reason`, `_resident_blocks`). The
    signal row (span floats, span + 1 in the fused resample and under
    dither), window, the
    packed mel bands (weights, and for SSC the melf weights; the filter
    offsets and `packed_meta`; none for a spectrogram), then for the FFT
    forms in the plan of `fft_layout` the twiddles and the stages' output
    bases (unless read from device memory), per warp (or per group of the
    block plan) two rows (`row_floats`) and the projection's scratch (32
    lane partials, or the group's thread partials, and M filter sums, twice
    for SSC, none for a spectrogram; the block plan then the 8 warps'
    partials of a group sum; "gather_sums" the partials alone), which the fused
    resample's input window (`resample_window` samples of the rows' type)
    overlays, widening them only where it is longer; for bf16x3 the
    ring, its barriers, the tile's power rows, energies and means, and the
    per-warp scratch (`bf16_plan`); then the resample's tap table [up,
    table_stride].
    The sample type changes only the fused resample's window."""
    return _smem(cfg, kernel_form(cfg, dft_passes), int16)


def feature_rate_config(cfg: FrontendConfig) -> FrontendConfig:
    """cfg at its feature rate (no input_sample_rate): the config of the
    split route's second launch, the plain form on resampled rows."""
    return cfg.replace(input_sample_rate=None)


@functools.lru_cache(maxsize=256)
def resample_route(cfg: FrontendConfig, dft_passes: str = "radix4") -> str | None:
    """How a resampling config reaches the front-end on the card, picked by
    the layout mirrors before any launch (None for a config at its feature
    rate):
    - "fused": one launch of the fused-resample form, which resamples the
      rows as it stages them;
    - "split": `resample.cu` on the rows (zeroed past each length, with
      their output lengths, `rs_kernel.resample_rows`), then the plain form
      on its rows at `feature_rate_config(cfg)`, the reference's unfused
      route (`mfcc_tpu/ops/chain.py:734-764`). It takes centered framing
      (the reference resamples, then dithers, reflects and frames the
      resampled rows: `mfcc_tpu/kernels/frontend.py:1852-1862`), and every
      config whose fused layout with float32 rows is over the block's shared
      memory (192 kHz input; bf16x3 where no plan of `bf16_plan` fits). The
      float32 rows' layout, the larger, decides, so int16 and float32 rows
      take the same route and give the same output, bitwise."""
    if not chain.resamples(cfg):
        return None
    if chain.centered(cfg):
        return "split"
    if smem_bytes(cfg, dft_passes, int16=False) > rs_kernel.SMEM_BUDGET_BYTES:
        return "split"
    return "fused"


def layout_reason(cfg: FrontendConfig, dft_passes: str = "radix4") -> str | None:
    """Why cfg's kernel layout cannot launch (over the block's shared
    memory), or None. Held to the float32 rows' layout, the larger, so a
    config the port takes runs with either row type. A resampling config is
    held to the plain form's layout at its feature rate: the split route's
    second launch, which the fused form (taken only where its own layout
    fits) never exceeds. No config gives a reason: the Stockham and
    Bluestein forms' last plan ("gather_sums") stages the thread partials
    alone, and the bf16x3 opt-in's (`bf16_layout`, "gather_out") the matrix
    ring and one pass's power rows alone, whatever the n_fft, hop, frame
    length and filter count. What bounds the bf16x3 route is its matrix's
    bytes on the card (`bf16_matrix_reason`, which its card wrapper
    checks)."""
    if chain.resamples(cfg):
        cfg = feature_rate_config(cfg)
    n = smem_bytes(cfg, dft_passes, int16=False)
    budget = rs_kernel.SMEM_BUDGET_BYTES
    if n <= budget:
        return None
    return (f"front-end kernel layout of {n:,} bytes of shared memory a block in the "
            f"{kernel_form(cfg, dft_passes)} form, over the block's {budget:,}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("frontend")
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    branches = [
        f, u,  # dither, premixed seed
        i, i, f, f, i,  # conditioning, remove_dc, frame_preemph, frame_keep0, energy_source
        i, i,  # log_kind, feature_kind
    ]
    lib.mfcc_frontend_logmel.argtypes = [
        p, i, p, p, p, p,  # audio, is_int16, lengths, out, n_valid, frame_mask
        p, p, p, p, p, p, p,  # tables
        p,  # dft_matrix (bf16x3)
        i, i, i, i, i, i, i,  # B, T, F, L, S, M, packed weights
        i, i, i, i, i, i,  # n_fft, dft_form, frame_offset, center, framing, drop_last
        f, f, f, f,  # scale, preemph, eps, pscale
        *branches,
        i,  # origin
        p, i, ctypes.c_longlong,  # "gather_rows": workspace, slots (its grid's blocks), workspace floats
        i,  # cluster: blocks a frame of the cluster plan (0: another plan)
        i,  # wide: frames a block of the wide plan (0: another plan)
        p,  # stream
    ]
    lib.mfcc_frontend_logmel.restype = ctypes.c_int
    lib.mfcc_frontend_logmel_resample.argtypes = [
        p, i, p, p, p, p,  # audio, is_int16, lengths, out, n_valid, frame_mask
        p, p, p, p, p, p, p,  # tables
        p, p,  # dft_matrix (bf16x3), taps
        i, i, i, i, i, i, i,  # B, T, F, L, S, M, packed weights
        i, i, i, i,  # n_fft, dft_form, framing, drop_last
        i, i, i, i,  # up, down, half_len, K
        f, f, f,  # preemph, eps, pscale
        *branches,
        p,  # stream
    ]
    lib.mfcc_frontend_logmel_resample.restype = ctypes.c_int
    lib.mfcc_frontend_kernel_info.argtypes = [i, i, i, i, i, i, i, p]
    lib.mfcc_frontend_kernel_info.restype = ctypes.c_int
    lib.mfcc_frontend_cluster_info.argtypes = [i, i, i, i, i, p]
    lib.mfcc_frontend_cluster_info.restype = ctypes.c_int
    lib.mfcc_frontend_wide_info.argtypes = [i, i, i, i, p]
    lib.mfcc_frontend_wide_info.restype = ctypes.c_int
    lib.mfcc_frontend_error_string.argtypes = [ctypes.c_int]
    lib.mfcc_frontend_error_string.restype = ctypes.c_char_p
    return lib


def kernel_info(cfg: FrontendConfig, int16: bool = True, dft_passes: str = "radix4") -> dict:
    """The card's view of cfg's kernel instantiation (needs a card; of the
    plain form on the split route, `resample_route`; of the block plan's
    instantiation where `fft_plan` takes it, and of the bf16x3 block plans'
    where `bf16_layout` takes one of them): registers a thread,
    local (spilled) bytes a thread, and the blocks an SM holds at cfg's
    shared memory for these rows (`smem_bytes`), from cudaFuncGetAttributes
    and cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    if resample_route(cfg, dft_passes) == "split":
        cfg = feature_rate_config(cfg)  # the split route's front-end launch
    out = (ctypes.c_int * 3)()
    form = kernel_form(cfg, dft_passes)
    threads = THREADS
    if form == "bf16x3":
        smem = smem_bytes(cfg, dft_passes, int16)
        block = not chain.resamples(cfg) and bf16_layout(cfg, int16)[0] != "staged"
        threads = BF16_BLOCK_THREADS if block else THREADS
    else:  # the layout of the plan the mirror takes now (not smem_bytes' cached one)
        plan, groups = fft_layout(cfg, form, int16)
        smem = _fft_smem(cfg, form, plan, int16, groups)
        if plan == "cluster":
            return _cluster_info(cfg, int16, groups, smem)
        if plan == "wide":
            return _wide_info(cfg, int16, groups, smem)
        block = plan != "warp"
    rc = _lib().mfcc_frontend_kernel_info(
        int(int16), int(chain.resamples(cfg)), int(cfg.dither > 0.0),
        int(chain.needs_conditioning(cfg)), int(form == "bf16x3"), int(block), smem, out)
    if rc != 0:
        raise RuntimeError(f"front-end kernel info failed: "
                           f"{_lib().mfcc_frontend_error_string(rc).decode()} (cudaError {rc})")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2], "smem_bytes": smem,
            "threads": threads}


def _cluster_info(cfg: FrontendConfig, int16: bool, C: int, smem: int) -> dict:
    """`kernel_info` of the cluster plan at C blocks a frame: registers, local
    bytes, blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
    the clusters the card holds at once (cudaOccupancyMaxActiveClusters)."""
    out = (ctypes.c_int * 4)()
    rc = _lib().mfcc_frontend_cluster_info(int(int16), int(cfg.dither > 0.0), int(chain.needs_conditioning(cfg)),
                                           C, smem, out)
    if rc != 0:
        raise RuntimeError(f"front-end cluster info failed: "
                           f"{_lib().mfcc_frontend_error_string(rc).decode()} (cudaError {rc})")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2], "smem_bytes": smem,
            "cluster": C, "clusters": out[3]}


def _wide_info(cfg: FrontendConfig, int16: bool, tile: int, smem: int) -> dict:
    """`kernel_info` of the wide plan at a tile of `tile` frames: registers,
    local bytes, blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    its tile and its FFT stage's groups."""
    out = (ctypes.c_int * 3)()
    rc = _lib().mfcc_frontend_wide_info(int(int16), int(cfg.dither > 0.0), int(chain.needs_conditioning(cfg)),
                                        smem, out)
    if rc != 0:
        raise RuntimeError(f"front-end wide info failed: "
                           f"{_lib().mfcc_frontend_error_string(rc).decode()} (cudaError {rc})")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2], "smem_bytes": smem,
            "tile": tile, "groups": wide_groups(cfg, dft_form(cfg), tile)}


@functools.lru_cache(maxsize=64)
def _active_clusters(cfg: FrontendConfig, int16: bool, C: int, device: torch.device) -> int:
    """Clusters of C blocks of cfg's cluster-plan instantiation (a config at
    its feature rate) that the card holds at once."""
    with torch.cuda.device(device):
        n = _cluster_info(cfg, int16, C, cluster_smem(cfg, dft_form(cfg), C))["clusters"]
    if n < 1:
        raise RuntimeError(f"the card holds no cluster of {C} blocks of the front-end's cluster plan")
    return n


@functools.lru_cache(maxsize=64)
def _resident_blocks(cfg: FrontendConfig, int16: bool, device: torch.device) -> int:
    """Blocks of cfg's block-plan instantiation (a config at its feature
    rate) that the card holds at once: its SMs times the blocks an SM holds
    at the layout's shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = (ctypes.c_int * 3)()
    form = dft_form(cfg)
    plan, groups = fft_layout(cfg, form, int16, cluster=False)
    if plan == "wide":  # the ladder's own plan without it (a launch forced to it)
        plan, groups = fft_layout(cfg, form, int16, False, False)
    with torch.cuda.device(device):
        rc = _lib().mfcc_frontend_kernel_info(
            int(int16), 0, int(cfg.dither > 0.0), int(chain.needs_conditioning(cfg)), 0, 1,
            _fft_smem(cfg, form, plan, int16, groups), out)
    if rc != 0:
        raise RuntimeError(f"front-end kernel info failed: "
                           f"{_lib().mfcc_frontend_error_string(rc).decode()} (cudaError {rc})")
    return max(1, out[2]) * torch.cuda.get_device_properties(device).multi_processor_count


def rows_workspace(cfg: FrontendConfig, form: str, blocks: int, resident: int) -> tuple[int, int]:
    """(slots, floats) of the workspace of a "gather_rows" or "gather_sums"
    launch of cfg (a config at its feature rate) in the Stockham or
    Bluestein form, over `blocks` tiles on a card that holds `resident`
    blocks at once: its persistent grid has a block for each that can be
    resident (never more than the tiles), each looping over the tiles with a
    slot of its own that holds its groups' two FFT rows (`row_floats`), and
    for SSC under "gather_sums" then a slot of its groups' M melf sums after
    every slot's rows. Its size is bounded by the card, not by the batch."""
    plan, groups = fft_layout(cfg, form, cluster=False)
    if plan == "wide":  # the ladder's own plan without it (a launch forced to it)
        plan, groups = fft_layout(cfg, form, True, False, False)
    slots = max(1, min(blocks, resident))
    sums = cfg.n_mels if plan == "gather_sums" and feature_kind(cfg) == "ssc" else 0
    return slots, slots * groups * (2 * row_floats(cfg.n_fft, form) + sums)


def _workspace(floats: int, device: torch.device) -> torch.Tensor:
    """A "gather_rows" or "gather_sums" launch's workspace: uninitialized
    (the kernel writes every row and sum before it reads it)."""
    return torch.empty(floats, dtype=torch.float32, device=device)


def frame_counts_reference(
    lengths: torch.Tensor, cfg: FrontendConfig, num_frames: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel's frame counts: (n_valid [B] int32,
    frame_mask [B, num_frames] float32) by `chain.num_valid_frames` and
    `chain.frame_mask`, of the output lengths (`R.output_lengths`) for
    resampling configs, as the reference's `_stage_dict` derives them."""
    if chain.resamples(cfg):
        lengths = R.output_lengths(lengths, cfg.input_sample_rate, cfg.sample_rate)
    n_valid = chain.num_valid_frames(lengths, cfg).to(torch.int32)
    return n_valid, chain.frame_mask(n_valid, num_frames, torch.float32)


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
    `dft_passes` picks the DFT route (`kernel_form`): "radix4" (the
    default) and "fp32" (the full-fp32 form of `dft_form`), or "bf16x3"
    (three bf16 tensor-core products, an opt-in of its own accuracy class).
    A resampling config takes the route of `resample_route`: the fused
    form, or `resample.cu` and then the plain form.

    CUDA tensors launch the kernel (contiguous, on one device, else it
    raises); CPU tensors get the plain version. `consts` overrides the
    window and mel matrix (a chain-constants dict). The launch's frame
    counts and mask come with `logmel_prefix_counts`."""
    return logmel_prefix_counts(audio, lengths, cfg, consts, dft_passes)[0]


def _launch_args(audio, lengths, out, n_valid, mask, cfg: FrontendConfig, consts, form: str):
    """(head, dims, framing, tail, branches): the arguments the entries share
    (`_lib`), for rows audio [B, T] and an output of F frames."""
    B, T = audio.shape
    k = _device_tables(cfg, audio.device) if consts is None else _tables(consts, audio.device)
    twiddle, bases = _device_fft_tables(cfg.n_fft, form, audio.device)
    head = (
        audio.data_ptr(), int(audio.dtype == torch.int16), lengths.data_ptr(),
        out.data_ptr(), n_valid.data_ptr(), mask.data_ptr(), k["window"].data_ptr(),
        k["mel_w"].data_ptr(), k["melf_w"].data_ptr(), k["mel_off"].data_ptr(),
        k["mel_meta"].data_ptr(), twiddle.data_ptr(), bases.data_ptr(),
    )
    dims = (B, T, out.shape[1], cfg.frame_length, cfg.frame_step, cfg.n_mels,
            k["mel_w"].numel(), cfg.n_fft, DFT_FORMS.index(form))
    framing = (FRAMINGS.index(cfg.frame_tail), int(cfg.drop_last_frame))
    frame_mode = cfg.preemph_mode == "frame"
    tail = (
        0.0 if frame_mode else cfg.preemph,  # signal pre-emphasis while staging
        cfg.log_eps,
        1.0 / cfg.n_fft if cfg.power_scale_nfft else 1.0,
    )
    c = cfg.preemph if frame_mode else 0.0
    branches = (
        cfg.dither, dither._fmix32_int(cfg.dither_seed),
        int(chain.needs_conditioning(cfg)), int(cfg.remove_dc_offset), c, 1.0 - c,
        ENERGY_SOURCES.index(cfg.energy_source), chain.LOG_KINDS.index(cfg.log_kind),
        FEATURE_KINDS.index(feature_kind(cfg)),
    )
    return head, dims, framing, tail, branches


def _check_rows(audio: torch.Tensor, lengths: torch.Tensor) -> None:
    if audio.dim() != 2 or audio.dtype not in (torch.int16, torch.float32):
        raise ValueError(
            f"audio must be [B, T] int16 or float32, got {audio.dtype} "
            f"{tuple(audio.shape)}"
        )
    B = audio.shape[0]
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


def logmel_prefix_counts(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    cfg: FrontendConfig,
    consts: dict[str, torch.Tensor] | None = None,
    dft_passes: str = "radix4",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`logmel_prefix` and, from the same launch, each row's valid frame
    count n_valid [B] int32 and the frame mask [B, F] float32, bitwise
    `frame_counts_reference` of the lengths. On a CPU tensor all three are
    the plain versions; with B = 0 or F = 0 nothing launches and the counts
    are the plain version's."""
    global split_launches
    form = kernel_form(cfg, dft_passes)
    if audio.device.type == "cpu":
        prefix = logmel_prefix_reference(audio, lengths, cfg, consts, dft_passes)
        return (prefix, *frame_counts_reference(lengths, cfg, prefix.shape[1]))
    if audio.device.type != "cuda":
        raise ValueError(f"the front-end kernel runs on CUDA, got {audio.device}")
    if form == "bf16x3":  # before the matrix is built
        reason = bf16_matrix_reason(cfg, torch.cuda.get_device_properties(audio.device).total_memory)
        if reason:
            raise NotImplementedError(f"config {cfg.config_hash()} needs the {reason} "
                                      f"(dft_passes={dft_passes!r})")
    if cfg.dtype != "float32":
        raise NotImplementedError(f"the kernel computes in float32, not {cfg.dtype}")
    _check_rows(audio, lengths)
    B, T = audio.shape
    if chain.resamples(cfg):
        F = cfg.num_frames(R.output_length(T, cfg.input_sample_rate, cfg.sample_rate))
    else:
        F = cfg.num_frames(T)
    M = cfg.n_mels
    out = torch.empty((B, F, M + 1), dtype=torch.float32, device=audio.device)
    if B == 0 or F == 0:  # F = 0: "drop" framing of rows shorter than a frame
        return (out, *frame_counts_reference(lengths, cfg, F))
    if resample_route(cfg, dft_passes) == "split":
        rows, out_lengths = rs_kernel.resample_rows(audio, lengths, cfg.input_sample_rate,
                                                    cfg.sample_rate)
        at_rate = feature_rate_config(cfg)
        n_valid, mask = _launch(rows, out_lengths, out, at_rate, consts,
                                kernel_form(at_rate, dft_passes), origin=0)
        split_launches += 1
        return out, n_valid, mask
    n_valid, mask = _launch(audio, lengths, out, cfg, consts, form, origin=0)
    return out, n_valid, mask


def _launch(audio, lengths, out, cfg: FrontendConfig, consts, form: str, origin: int):
    """Launches the front-end on rows audio over out's F frames (the fused
    form for a resampling config, else the plain form with frame 0 at row
    sample `origin`: 0 offline, 1 the block launch) and counts the launch
    → (n_valid, mask)."""
    global launches, resample_launches, block_launches, dither_launches, conditioning_launches
    global plp_launches, spectrogram_launches, ssc_launches
    global centered_launches, bluestein_launches, bf16x3_launches, block_fft_launches
    global global_table_launches, gather_launches, gather_bands_launches, gather_rows_launches
    global gather_sums_launches, cluster_launches, wide_launches
    global bf16_pass_launches, bf16_gather_launches, bf16_gather_bands_launches, bf16_gather_out_launches
    B, F = out.shape[:2]
    n_valid = torch.empty(B, dtype=torch.int32, device=audio.device)
    mask = torch.empty((B, F), dtype=torch.float32, device=audio.device)
    head, dims, framing, tail, branches = _launch_args(audio, lengths, out, n_valid, mask, cfg,
                                                       consts, form)
    dft_matrix = _device_bf16_matrix(cfg, audio.device).data_ptr() if form == "bf16x3" else None
    lib = _lib()
    resampling = origin == 0 and chain.resamples(cfg)
    int16 = audio.dtype == torch.int16
    # the fused form plans "warp" only; a plain-form launch (the block launch of
    # a resampling config too) plans at the feature rate
    at_rate = feature_rate_config(cfg)
    plan, C = ("warp", 0) if form == "bf16x3" or resampling else fft_layout(at_rate, form)
    bf16 = bf16_layout(cfg, int16)[0] if form == "bf16x3" else None
    # "gather_rows" and "gather_sums": the workspace, slots (the persistent
    # grid's blocks), floats
    rows = (None, 0, 0)
    if plan == "cluster":  # its persistent grid: the clusters the card holds, at most one a frame
        rows = (None, max(1, min(B * F, _active_clusters(at_rate, int16, C, audio.device))), 0)
        twiddle, bases = _device_fft_tables(cfg.n_fft, form, audio.device, C)
        head = (*head[:-2], twiddle.data_ptr(), bases.data_ptr())
    elif plan == "wide":  # its tile for this launch's frames
        C = wide_tile(C, B * F, _wide_slots(at_rate, int16, audio.device))
    elif plan in ("gather_rows", "gather_sums"):
        slots, floats = rows_workspace(at_rate, form, B * -(-F // TILE),
                                       _resident_blocks(at_rate, int16, audio.device))
        ws = _workspace(floats, audio.device)
        rows = (ws.data_ptr(), slots, floats)
    elif bf16 not in (None, "staged", "pass"):  # the accumulators and the tiles' A
        floats = bf16_workspace(cfg, B, F, int16)
        ws = _workspace(floats, audio.device)
        rows = (ws.data_ptr(), 0, floats)
    if bf16 not in (None, "staged") and mel_matrices(cfg):  # the pass table rides `bases`
        table = _device_pass_table(cfg, audio.device) if consts is None else pass_table(
            consts["mel"].to(device="cpu", dtype=torch.float32)).to(audio.device)
        head = (*head[:-1], table.data_ptr())
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream().cuda_stream
        if resampling:
            up, down = R.ratio(cfg.input_sample_rate, cfg.sample_rate)
            d = R.polyphase_design(up, down)
            taps = rs_kernel.device_table(up, down, cfg.input_scale, audio.device)
            rc = lib.mfcc_frontend_logmel_resample(
                *head, dft_matrix, taps.data_ptr(), *dims, *framing,
                d["up"], d["down"], d["half_len"], d["K"], *tail, *branches, stream,
            )
        else:
            rc = lib.mfcc_frontend_logmel(
                *head, dft_matrix, *dims, chain.frame_offset(cfg),
                CENTER_CODES.get(cfg.frame_tail, 0), *framing,
                cfg.input_scale, *tail, *branches, origin, *rows, C if plan == "cluster" else 0,
                C if plan == "wide" else 0, stream,
            )
    if rc != 0:
        raise RuntimeError(
            f"front-end {'block ' if origin else ''}launch failed: "
            f"{lib.mfcc_frontend_error_string(rc).decode()} (cudaError {rc})"
        )
    if resampling:
        resample_launches += 1
    elif origin:
        block_launches += 1
    else:
        launches += 1
    kind = feature_kind(cfg)
    dither_launches += int(cfg.dither > 0.0)
    conditioning_launches += int(chain.needs_conditioning(cfg))
    plp_launches += int(kind == "plp")
    spectrogram_launches += int(kind == "spectrogram")
    ssc_launches += int(kind == "ssc")
    centered_launches += int(chain.centered(cfg))
    bluestein_launches += int(form == "bluestein")
    bf16x3_launches += int(form == "bf16x3")
    bf16_pass_launches += int(bf16 == "pass")
    bf16_gather_launches += int(bf16 == "gather")
    bf16_gather_bands_launches += int(bf16 == "gather_bands")
    bf16_gather_out_launches += int(bf16 == "gather_out")
    gather, tables_dev = PLAN_TRAITS.get(plan, (False,) * 5)[:2]
    block_fft_launches += int(plan != "warp")
    global_table_launches += int(tables_dev)
    gather_launches += int(gather)
    gather_bands_launches += int(plan == "gather_bands")
    gather_rows_launches += int(plan == "gather_rows")
    gather_sums_launches += int(plan == "gather_sums")
    cluster_launches += int(plan == "cluster")
    wide_launches += int(plan == "wide")
    return n_valid, mask


def logmel_block(
    rows: torch.Tensor,
    valid: torch.Tensor,
    cfg: FrontendConfig,
    consts: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """The block launch: rows [N, span+1] int16 or float32 at
    cfg.sample_rate (streaming resamples on the host first), row sample 0
    the block's pre-context x[t0·S - 1], frames from sample 1, span =
    (K - 1)·S + L; valid [N] int32, the samples from sample 1 that hold
    signal → the prefix [N, K, n_mels+1] of `logmel_prefix`'s lanes (see
    csrc/frontend.cu, "The block launch"). A config with dither or centered
    framing raises ValueError on both devices.

    CUDA tensors launch the plain form at row origin 1 (contiguous, on one
    device, else it raises; a compute dtype other than float32 raises
    NotImplementedError); CPU tensors get `logmel_block_reference`. N = 0
    launches nothing."""
    _block_refusal(cfg)
    K = block_frames(cfg, rows.shape[-1])
    if rows.device.type == "cpu":
        return logmel_block_reference(rows, valid, cfg, consts)
    if rows.device.type != "cuda":
        raise ValueError(f"the front-end kernel runs on CUDA, got {rows.device}")
    if cfg.dtype != "float32":
        raise NotImplementedError(f"the kernel computes in float32, not {cfg.dtype}")
    _check_rows(rows, valid)
    B = rows.shape[0]
    out = torch.empty((B, K, cfg.n_mels + 1), dtype=torch.float32, device=rows.device)
    if B == 0:
        return out
    _launch(rows, valid, out, cfg, consts, dft_form(cfg), origin=1)
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
    input samples; n_valid counts frames at cfg.sample_rate. On the card
    "n_valid" and "frame_mask" come from the front-end's own launch
    (`logmel_prefix_counts`), so with int32 lengths on the card the step
    runs the front-end and the tail and no other device kernel."""
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
    prefix, n_valid, mask = logmel_prefix_counts(audio, lengths, cfg, consts, dft_passes)
    stages = {"n_valid": n_valid, "frame_mask": mask, "num_frames": prefix.shape[1]}
    if feature_tail and cfg.features == "mfcc":
        stages["features_fused"] = tail.feature_tail(prefix, n_valid, cfg, consts)
    else:
        stages["prefix"] = prefix
    return stages
