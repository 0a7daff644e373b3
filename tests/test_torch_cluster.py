"""The front-end's cluster plan (csrc/frontend.cu logmel_kernel_cluster) on the CPU.

The plan splits each frame's FFT over a thread-block cluster of C = 2, 4 or
8 blocks: rank r transforms the points g = C·n + r by the H2 = n/C-point
Stockham stages of the local tables (`frontend.cluster_twiddles`,
`cluster_bases`), then one radix-C exchange across the cluster twists
rank r's output k1 by e^{-2πi·r·k1/n} and stores output q, X[k1 + q·H2],
to rank q, so rank q holds X[q·H2, (q + 1)·H2) in order. The Bluestein
form runs that twice, its inverse's stage 0 reading conj(A[g]) from the
rank that holds it. The real split reads its partners Z[H - k] from the
ranks that hold them and stores each power to the rank of its bin (rank
k // PB, PB = ceil(n_bins / C)); each rank sums the packed weights of its
own bins over the filters its bins touch, in the balanced chunks of the
other plans, and filter m is completed from the ranks' partials in rank
order. `_emulate_cluster` mirrors all of it in numpy: the index algebra in
float64 against numpy's rfft and the plain version, float32 within the
kernel-vs-plain gates, at every cluster size and in both forms, forced at
small n_fft. The layout mirror's choice of the plan and of C at each phase
29 case (chip_smoke.py ANY_NFFT) is pinned, and every config outside it
keeps the plan it had before the cluster plan.
"""

import os

import numpy as np
import pytest
import torch

from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.ops import constants as tconstants
from mfcc_tpu_torch.ops import dither as tdither
from mfcc_tpu_torch.testing import assert_prefix_close
from tests.test_torch_frontend import _batch, _gather_samples, _log_lane, _real_split, _reference

LANES = frontend.THREADS  # a rank's threads


def _table(n_fft, form, C, dtype):
    """The cluster plan's twiddle table as complex numbers: unrounded
    (float64) or as the card reads it (float32)."""
    tab = frontend.cluster_twiddles(n_fft, form, C, np.float64 if dtype == np.float64 else np.float32)
    return tab[:, 0] + 1j * tab[:, 1]


def _offsets(n_fft, form, C):
    """(chirp, filter spectrum, exchange twists) offsets in the table."""
    local = sum(hr * (R - 1) for R, _, hr in frontend._local_stages(n_fft, form, C)[1:])
    chirp = frontend.split_count(n_fft) + local
    q = frontend.bluestein_dims(n_fft)[0] if form == "bluestein" else 0
    filt = chirp + q
    cross = filt + (frontend.filter_count(n_fft) if form == "bluestein" else 0)
    return chirp, filt, cross


def _local_fft(z, n_fft, form, C, w):
    """A rank's local FFT on rows z [nf, H2]: the Stockham stages of
    radices(2·H2), stage s of radix R after ns points, butterfly j reading
    src[j + r·H2/R], input r twisted by the local table (after the split's
    entries; none at stage 0), the R-point DFT stored at base[j] + q·ns,
    each output written once."""
    h2 = z.shape[1]
    bases = frontend.cluster_bases(n_fft, form, C)
    src, ns, tw, b0 = z, 1, frontend.split_count(n_fft), 0
    for s, R in enumerate(frontend.radices(2 * h2)):
        hr = h2 // R
        q = np.arange(R)
        dft = np.exp(-2j * np.pi * np.outer(q, q) / R).astype(z.dtype)
        j = np.arange(hr)
        v = np.stack([src[:, j + r * hr] for r in range(R)])  # [R, nf, hr]
        assert not np.isnan(v).any()
        if s:
            v[1:] = v[1:] * w[tw : tw + hr * (R - 1)].reshape(hr, R - 1).T[:, None, :]
            tw += hr * (R - 1)
        out = np.einsum("qr,rfj->qfj", dft, v)
        d = bases[b0 : b0 + hr]
        dst = np.full_like(src, np.nan)
        written = np.zeros(h2, np.int64)
        for qq in range(R):
            dst[:, d + qq * ns] = out[qq]
            written[d + qq * ns] += 1
        assert (written == 1).all()
        b0 += hr
        src, ns = dst, ns * R
    return src


def _cluster_fft(a, n_fft, form, C, w):
    """The plan's FFT of rows a [nf, n] (global order): rank r's local FFT
    of a[:, r::C], then the exchange. Returns X [nf, n] in order, rank q's
    share X[:, q·H2 : (q + 1)·H2]."""
    n = a.shape[1]
    h2 = n // C
    Y = [_local_fft(np.ascontiguousarray(a[:, r::C]), n_fft, form, C, w) for r in range(C)]
    cross = w[_offsets(n_fft, form, C)[2] :].reshape(C - 1, h2)
    v = np.stack([Y[0]] + [Y[r] * cross[r - 1] for r in range(1, C)])  # [C, nf, H2]
    q = np.arange(C)
    out = np.einsum("qr,rfk->qfk", np.exp(-2j * np.pi * np.outer(q, q) / C).astype(a.dtype), v)
    return np.concatenate(list(out), axis=1)


def _cluster_bluestein(fr, n_fft, C, w, ctype):
    """The Bluestein form through the plan: the chirped points, the plan's
    forward FFT (A spread in order), the inverse's loads conj(A[g])·filter
    (filter[min(g, P - g)] for even n_fft), the plan's FFT again, then
    c[k]·conj(D[k]) for k < K."""
    q, k, P = frontend.bluestein_dims(n_fft)
    chirp_at, filt_at, _ = _offsets(n_fft, "bluestein", C)
    chirp, filt = w[chirp_at : chirp_at + q], w[filt_at : filt_at + frontend.filter_count(n_fft)]
    if n_fft % 2 == 0:
        filt = filt[np.minimum(np.arange(P), P - np.arange(P))]
        z = fr[:, 0 : 2 * q : 2] + 1j * fr[:, 1 : 2 * q : 2]
    else:
        z = fr[:, :q]
    a = np.zeros((fr.shape[0], P), ctype)
    a[:, :q] = z * chirp
    A = _cluster_fft(a, n_fft, "bluestein", C, w)
    D = _cluster_fft((np.conj(A) * filt).astype(ctype), n_fft, "bluestein", C, w)
    return (chirp[:k] * np.conj(D[:, :k])).astype(ctype)


def _rank_filters(kbin, off, bins, C):
    """csrc/frontend.cu step 4r: (first, last) filter whose band touches
    each rank's bins [q·PB, (q + 1)·PB), from each filter's first and last
    bin; (M, -1) for a rank no band touches."""
    pb = -(-bins // C)
    lo, hi = kbin[off[:-1]], kbin[off[1:] - 1] + 1
    out = []
    for q in range(C):
        touch = np.flatnonzero((lo < min(bins, (q + 1) * pb)) & (hi > q * pb))
        out.append((int(touch[0]), int(touch[-1])) if len(touch) else (len(off) - 1, -1))
    return out


def _cluster_project(P, w, wf, off, kbin, eps, ssc, C):
    """The plan's projection of power rows P [nf, bins]: rank q sums the
    weights of the filters its bins touch, [off[ma], off[mb + 1]), in
    balanced chunks of its 256 threads (a filter ending in a chunk stored
    there, one begun in an earlier chunk completed from the partials in
    order), a weight whose bin another rank holds adding nothing; filter m
    is then the ranks' partials in rank order. Returns the mel sums [nf, M]
    (and the melf sums)."""
    nf, bins = P.shape
    M = len(off) - 1
    pb = -(-bins // C)
    ranges = _rank_filters(kbin, off, bins, C)
    z = np.zeros(nf, P.dtype)
    partial = {}
    for q, (ma, mb) in enumerate(ranges):
        if ma > mb:
            continue
        i0, i1 = int(off[ma]), int(off[mb + 1])
        c = frontend.chunk(i1 - i0, LANES)
        filt = np.repeat(np.arange(M), np.diff(off))
        own = (kbin >= q * pb) & (kbin < min(bins, (q + 1) * pb))
        sums, sumsf = np.full((nf, M), np.nan, P.dtype), np.full((nf, M), np.nan, P.dtype)
        part, partf, held = {}, {}, {}
        for lane in range(LANES):
            j0, j1 = i0 + lane * c, min(i0 + lane * c + c, i1)
            acc, accf = z.copy(), z.copy()
            for i in range(j0, j1):
                m = filt[i]
                if own[i]:
                    v = P[:, kbin[i]]
                    if ssc:
                        v = np.where(v <= 0, eps, v)
                        accf = accf + v * wf[i]
                    acc = acc + v * w[i]
                if i + 1 == off[m + 1]:
                    if off[m] < j0:
                        held[lane] = (m, acc, accf)
                    else:
                        sums[:, m], sumsf[:, m] = acc, accf
                    acc, accf = z.copy(), z.copy()
            part[lane], partf[lane] = acc, accf
        for lane, (m, h, hf) in held.items():
            a = (off[m] - i0) // c
            t, tf = part[a], partf[a]
            for lo in range(a + 1, lane):
                t, tf = t + part[lo], tf + partf[lo]
            sums[:, m], sumsf[:, m] = t + h, tf + hf
        assert not np.isnan(sums[:, ma : mb + 1]).any()
        partial[q] = sums, sumsf
    out, outf = np.zeros((nf, M), P.dtype), np.zeros((nf, M), P.dtype)
    for m in range(M):
        ranks = [q for q, (ma, mb) in enumerate(ranges) if ma <= m <= mb]
        assert ranks, m
        out[:, m], outf[:, m] = partial[ranks[0]][0][:, m], partial[ranks[0]][1][:, m]
        for q in ranks[1:]:
            out[:, m] = out[:, m] + partial[q][0][:, m]
            outf[:, m] = outf[:, m] + partial[q][1][:, m]
    return out, outf


def _emulate_cluster(audio, lengths, cfg, dtype, C):
    """csrc/frontend.cu's cluster plan in numpy, frame by frame, in `dtype`:
    each frame's samples from the row (`_gather_samples`, staged_at), the
    conditioning (mean and raw energy over all L samples, frame
    pre-emphasis, the windowed energy), a frame at or past its row's length
    (non-centered framing) taking no DFT, the plan's FFT of the windowed
    frame's first min(L, n_fft) samples (`_cluster_fft`, or
    `_cluster_bluestein`), the split or the odd form's powers, then by
    feature kind the plan's projection (`_cluster_project`) and epilogue, and
    the energy lane."""
    ctype = np.complex64 if dtype == np.float32 else np.complex128
    k = tconstants.chain_constants(cfg)
    kind = frontend.feature_kind(cfg)
    win, mel = k["window"].astype(dtype), k["mel"].astype(dtype)
    melf = (k["freqs"][:, None] * k["mel"]).astype(dtype)
    off, index = (t.numpy() for t in frontend.mel_packed(torch.as_tensor(mel)))
    w_mel, w_melf = mel.reshape(-1)[index], melf.reshape(-1)[index]
    N, form = cfg.n_fft, frontend.dft_form(cfg)
    w = _table(N, form, C, dtype).astype(ctype)
    B, T = audio.shape
    S, L, M = cfg.frame_step, cfg.frame_length, cfg.n_mels
    H, Lk, F = N // 2, min(L, N), cfg.num_frames(T)
    pscale = dtype(1.0 / N if cfg.power_scale_nfft else 1.0)
    eps = dtype(cfg.log_eps)
    c = dtype(cfg.preemph if cfg.preemph_mode == "frame" else 0.0)
    keep0 = dtype(np.float32(1.0 - float(c)))
    x_all = audio.astype(dtype) * dtype(cfg.input_scale)
    noise = tdither.signal_noise(cfg.dither_seed, T, S).numpy().astype(dtype) if cfg.dither > 0.0 else None
    out = np.empty((B, F, M + 1), dtype)
    for b in range(B):
        n = min(int(lengths[b]), T)
        f = _gather_samples(x_all[b], noise, n, (np.arange(F) * S)[:, None] + np.arange(L), cfg, dtype)
        zero = np.zeros(F, bool) if tchain.centered(cfg) else np.arange(F) * S >= n
        e_raw = np.zeros(F, dtype)
        if tchain.needs_conditioning(cfg):
            mu = f.sum(axis=-1, keepdims=True) / dtype(L) if cfg.remove_dc_offset else dtype(0)
            d = (f - mu).astype(dtype)
            e_raw = (d * d).sum(axis=-1)
            f = np.concatenate([d[:, :1] * keep0, d[:, 1:] - c * d[:, :-1]], axis=-1)
        wf = f * win
        e_win = (wf * wf).sum(axis=-1)
        fr = np.zeros((F, 2 * H + 2), dtype)
        fr[:, :Lk] = wf[:, :Lk]
        if form == "bluestein":
            Z = _cluster_bluestein(fr, N, C, w, ctype)
            P = (np.abs(Z) ** 2 * pscale).astype(dtype) if N % 2 else _real_split(Z, w, pscale, dtype)
        else:
            z = (fr[:, 0 : 2 * H : 2] + 1j * fr[:, 1 : 2 * H : 2]).astype(ctype)
            P = _real_split(_cluster_fft(z, N, form, C, w), w, pscale, dtype)
        P[zero], e_raw[zero], e_win[zero] = 0, 0, 0
        if kind == "spectrogram":
            lanes = _log_lane(P[:, :M], cfg.log_kind, eps, dtype)
        else:
            sums, sumsf = _cluster_project(P, w_mel, w_melf, off, index // M, eps, kind == "ssc", C)
            lanes = sumsf / sums if kind == "ssc" else sums if kind == "plp" else _log_lane(
                sums, cfg.log_kind, eps, dtype)
        out[b, :, :M] = lanes
        if kind == "ssc":
            out[b, :, M] = 0
        elif cfg.energy_source == "raw_frame":
            out[b, :, M] = np.maximum(e_raw, eps)
        elif cfg.energy_source == "windowed_frame":
            out[b, :, M] = np.maximum(e_win, eps)
        else:
            e = P.sum(axis=-1)
            out[b, :, M] = np.where(e <= 0, eps, e)
    return out


# (n_fft, form): Stockham, even Bluestein (the split after it) and odd
# Bluestein at sizes whose FFT points split C x C at C = 8 too
FFT_CASES = [(2048, "stockham"), (1102, "bluestein"), (551, "bluestein"), (404, "bluestein")]


@pytest.mark.parametrize("C", frontend.CLUSTER_SIZES)
@pytest.mark.parametrize("n_fft,form", FFT_CASES, ids=[f"{f}_{n}" for n, f in FFT_CASES])
def test_cluster_fft_matches_numpy_rfft_in_float64(n_fft, form, C):
    """The plan's local stages, exchange and split (the Bluestein form's two
    passes through them) ≡ np.fft.rfft within 1e-9 in float64 at every
    cluster size: the tables' layout and the exchange's index algebra."""
    assert frontend.dft_form(T_CONFIGS["classic13"].replace(n_fft=n_fft)) == form
    assert frontend.cluster_dims(n_fft, form, C) is not None
    g = np.random.default_rng(n_fft + C)
    fr = g.standard_normal((3, n_fft + 2))
    fr[:, n_fft:] = 0.0
    w = _table(n_fft, form, C, np.float64)
    if form == "bluestein":
        Z = _cluster_bluestein(fr, n_fft, C, w, np.complex128)
        power = np.abs(Z) ** 2 if n_fft % 2 else _real_split(Z, w, 1.0, np.float64)
    else:
        z = fr[:, 0:n_fft:2] + 1j * fr[:, 1:n_fft:2]
        power = _real_split(_cluster_fft(z, n_fft, form, C, w), w, 1.0, np.float64)
    want = np.abs(np.fft.rfft(fr[:, :n_fft], axis=-1)) ** 2
    np.testing.assert_allclose(power, want, rtol=0, atol=1e-9 * want.max())


@pytest.mark.parametrize("C", frontend.CLUSTER_SIZES)
@pytest.mark.parametrize("name", ["classic13", "ssc26", "logmel80"])
def test_cluster_projection_counts_every_weight_once(name, C):
    """Each rank's partials over the filters its bins touch, completed in
    rank order, ≡ the dense mel product in float64 (and the melf product
    for SSC, over the clamped powers) at n_fft 2048: every weight is summed
    once, by the rank that holds its bin, however the bands cross ranks."""
    cfg = T_CONFIGS[name].replace(n_fft=2048)
    k = tconstants.chain_constants(cfg)
    mel = k["mel"].astype(np.float64)
    melf = k["freqs"][:, None] * mel
    off, index = (t.numpy() for t in frontend.mel_packed(torch.as_tensor(mel)))
    M = cfg.n_mels
    g = np.random.default_rng(C)
    P = g.exponential(size=(2, cfg.n_bins))
    P[:, ::7] = 0.0  # clamped bins for SSC
    ranges = _rank_filters(index // M, off, cfg.n_bins, C)
    assert sum(mb >= ma for ma, mb in ranges) >= min(C, 2)
    crossing = sum(1 for m in range(M) if sum(ma <= m <= mb for ma, mb in ranges) > 1)
    assert crossing >= C - 1  # bands do cross ranks
    sums, sumsf = _cluster_project(P, mel.reshape(-1)[index], melf.reshape(-1)[index], off, index // M,
                                   1e-10, name == "ssc26", C)
    q = np.where(P <= 0, 1e-10, P) if name == "ssc26" else P  # SSC sums the clamped powers
    np.testing.assert_allclose(sums, q @ mel, rtol=1e-12, atol=1e-12)
    if name == "ssc26":
        np.testing.assert_allclose(sumsf, q @ melf, rtol=1e-12, atol=1e-12)


# (config, overrides): each form, feature kind and branch the plan takes,
# forced at small n_fft
KERNEL_CASES = [
    ("classic13_deltas", {"n_fft": 1024}),
    ("logmel80", {"n_fft": 1102}),
    ("kaldi_mfcc", {"n_fft": 551, "dither": 1.0}),
    ("kaldi_mfcc", {"n_fft": 1024, "energy_source": "windowed_frame", "win_len_s": 0.08}),
    ("ssc26", {"n_fft": 1024}),
    ("kaldi_plp", {"n_fft": 404}),
    ("kaldi_spectrogram", {"n_fft": 1024, "n_mels": 513}),
    ("whisper80", {"n_fft": 1024}),
    ("classic13", {"n_fft": 2048, "frame_tail": "center_reflect"}),
]
KERNEL_IDS = ["classic13_deltas_1024", "logmel80_bluestein_1102", "kaldi_dither_odd_551",
              "kaldi_windowed_long_frames", "ssc26", "kaldi_plp_404", "spectrogram", "whisper80",
              "center_reflect_2048"]


@pytest.mark.parametrize("C", frontend.CLUSTER_SIZES)
@pytest.mark.parametrize("name,overrides", KERNEL_CASES, ids=KERNEL_IDS)
def test_cluster_plan_exact_in_float64(name, overrides, C):
    """The whole plan, forced at every cluster size, reproduces the plain
    version to ~1e-9 in float64 (the spectrogram's bins in the linear
    domain, as test_torch_frontend's branches)."""
    cfg = T_CONFIGS[name].replace(dtype="float64", **overrides)
    assert frontend.cluster_smem(cfg, frontend.dft_form(cfg), C) <= frontend.rs_kernel.SMEM_BUDGET_BYTES
    audio, lengths = _batch("classic13", ("noise", "short"))
    audio = audio[:, :6000].astype(np.float64) * 3000
    lengths = np.minimum(lengths, 5500)
    got = _emulate_cluster(audio, lengths, cfg, np.float64, C)
    want = _reference(audio, lengths, cfg)
    assert got.shape == want.shape == (2, cfg.num_frames(6000), cfg.n_mels + 1)
    if cfg.features == "spectrogram":
        M = cfg.n_mels
        lin_g, lin_w = np.exp(got[..., :M]), np.exp(want[..., :M])
        rowmax = lin_w.max(axis=-1, keepdims=True)
        np.testing.assert_allclose(lin_g / rowmax, lin_w / rowmax, rtol=1e-9, atol=1e-12)
        got, want = got[..., M], want[..., M]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("C", frontend.CLUSTER_SIZES)
@pytest.mark.parametrize("name,overrides", KERNEL_CASES[:5], ids=KERNEL_IDS[:5])
def test_cluster_plan_float32_within_gates(name, overrides, C):
    """In float32, with the tables the card reads, the plan is within the
    kernel-vs-plain gates of the plain version at every cluster size."""
    cfg = T_CONFIGS[name].replace(**overrides)
    audio, lengths = _batch("classic13", ("noise", "speechish"))
    pcm = np.round(audio[:, :6000] * 3000).astype(np.int16)
    lengths = np.minimum(lengths, 5500)
    got = _emulate_cluster(pcm, lengths, cfg, np.float32, C)
    assert_prefix_close(got, _reference(pcm, lengths, cfg), cfg.n_mels, cfg.log_kind, cfg.features)


# chip_smoke.py phase 29 (ANY_NFFT): (config, overrides) -> (the cluster
# plan's blocks a frame, its shared memory a block, the parent's plan, and
# whether the ladder takes the cluster plan: at CLUSTER_MIN_POINTS[form]
# points or more).
# Phase 31's n_fft 131,072 with 16,385 filters is pinned on the card alone:
# its dense mel table is ~4 GB here.
LIBROSA_16384 = dict(sample_rate=44100, n_fft=16384, win_len_s=16384 / 44100, hop_s=4096 / 44100, n_mels=128,
                     mel_variant="librosa_hz", mel_scale="slaney", mel_norm="slaney", mel_low_hz=0.0,
                     mel_high_hz=22050.0)
PINNED = [
    ("logmel80", LIBROSA_16384, 2, 75408, "gather_bands", True),
    ("classic13_deltas", dict(n_fft=7001), 2, 111872, "gather_bands", False),
    ("classic13_deltas", dict(n_fft=12502), 2, 116480, "gather_bands", False),
    ("whisper80", dict(n_fft=16384), 2, 75216, "gather_bands", True),
    ("classic13_deltas", dict(n_fft=13001), 2, 185600, "gather_rows", True),
    ("classic13_deltas", dict(n_fft=32768), 2, 148736, "gather_rows", True),
    ("classic13_deltas", dict(sample_rate=48000, n_fft=65536), 4, 148736, "gather_rows", True),
    ("classic13_deltas", dict(n_fft=131072), 8, 148736, "gather_rows", True),
]
PINNED_IDS = ["librosa_44k_16384", "bluestein_7001", "bluestein_12502", "whisper80_16384", "bluestein_13001",
              "32768", "48k_65536", "131072"]


@pytest.mark.parametrize("name,over,C,nbytes,parent,taken", PINNED, ids=PINNED_IDS)
def test_phase_29_cases_take_the_cluster_plan(name, over, C, nbytes, parent, taken):
    """Each phase 29 case has a cluster layout at the smallest cluster that
    fits (2, 4 or 8 blocks a frame), its shared memory a block as pinned
    (two rows of H2 = n/C points, the thread partials, M filter partials a
    table, the warps' partials, the slots and ranges); the ladder takes it
    at Stockham FFTs of 8,192 points or more (librosa's and whisper80's
    16,384, where the parent took "gather_bands"; 32,768, 65,536 and
    131,072, where it took "gather_rows") and Bluestein FFTs of P = 16,384
    or more (13,001: P = 20,480, "gather_rows"), and keeps the parent's
    "gather_bands" at Bluestein P = 12,288 and 12,800 (7,001 and 12,502);
    with int16 and float32 rows alike, and nothing refused."""
    cfg = T_CONFIGS[name].replace(**over)
    form = frontend.dft_form(cfg)
    assert frontend.fft_layout(cfg, cluster=False)[0] == parent
    want = ("cluster", C) if taken else frontend.fft_layout(cfg, cluster=False)
    assert frontend.fft_layout(cfg) == frontend.fft_layout(cfg, int16=False) == want
    assert (frontend.fft_points(cfg.n_fft, form) >= frontend.CLUSTER_MIN_POINTS[form]) == taken
    assert frontend.cluster_smem(cfg, form, C) == nbytes <= frontend.rs_kernel.SMEM_BUDGET_BYTES
    if taken:
        assert frontend.smem_bytes(cfg) == nbytes
    smaller = [c for c in frontend.CLUSTER_SIZES if c < C]
    assert all(frontend.cluster_smem(cfg, form, c) > frontend.rs_kernel.SMEM_BUDGET_BYTES for c in smaller)
    h2 = frontend.fft_points(cfg.n_fft, form) // C
    row = (2 * (h2 + h2 // 8 + 1) + 3) & ~3
    tables = frontend.mel_matrices(cfg)
    assert nbytes == 4 * (2 * row + tables * frontend.THREADS + ((tables * cfg.n_mels + 3) & ~3) + 8 + 4 + 16)
    assert frontend.layout_reason(cfg) is None and tchain.unsupported_reason(cfg) is None


def test_only_the_redesigned_plans_move():
    """Every config whose layout is not the cluster plan keeps the plan the
    ladder takes without it (the parent's, bitwise the same kernel code);
    the cluster plan replaces only "gather_bands", "gather_rows" and
    "gather_sums", and only at FFTs of CLUSTER_MIN_POINTS[form] points or more: the
    named families at n_fft from 256 to 131,072 (Stockham and Bluestein
    sizes) at hops of 10 ms and 1 s, and with 40,000 filters at n_fft 512
    and 2,048 (each filter count's packed table is a dense matrix on the
    host: larger ones take minutes)."""
    moved = kept = 0
    grid = [(n, {}) for n in (256, 512, 2048, 5393, 6205, 8192, 12502, 14400, 16384, 25602, 40001, 65536, 131072)]
    grid += [(n, {"hop_s": 1.0}) for n in (2048, 12502, 32768)] + [(n, {"n_mels": 40000}) for n in (512, 2048)]
    for name in sorted(T_CONFIGS):
        base = frontend.feature_rate_config(T_CONFIGS[name])
        for n_fft, over in grid:
            if base.features == "spectrogram":
                if "n_mels" in over:
                    continue
                over = over | {"n_mels": n_fft // 2 + 1}
            cfg = base.replace(n_fft=n_fft, **over)
            layout, parent = frontend.fft_layout(cfg), frontend.fft_layout(cfg, cluster=False)
            if layout[0] != "cluster":
                assert layout == parent, (name, n_fft, over)
                kept += 1
                continue
            assert parent[0] in ("gather_bands", "gather_rows", "gather_sums"), (name, n_fft, over)
            form = frontend.dft_form(cfg)
            assert frontend.fft_points(n_fft, form) >= frontend.CLUSTER_MIN_POINTS[form], (name, n_fft, over)
            moved += 1
    assert kept > 80 and moved > 30, (kept, moved)


def test_the_kernels_constants_are_the_mirrors():
    """csrc/frontend.cu's largest portable cluster is the layout mirror's;
    the mirror tries the cluster sizes right after "gather_global", and its
    size rule names both FFT forms the plan takes. The kernel's ladder has
    no cluster row and no size rule: a launch asks for the plan by its
    cluster size."""
    import pathlib
    import re

    src = (pathlib.Path(frontend.__file__).parent / "csrc" / "frontend.cu").read_text()
    value = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))  # noqa: E731
    assert value("kMaxCluster") == max(frontend.CLUSTER_SIZES)
    assert frontend.FFT_LAYOUTS[10:13] == tuple(("gather_global", g) for g in (4, 2, 1))
    assert frontend.FFT_LAYOUTS[13:16] == tuple(("cluster", C) for C in frontend.CLUSTER_SIZES)
    assert set(frontend.CLUSTER_MIN_POINTS) == {"stockham", "bluestein"}
    assert "kClusterRung" not in src and "kClusterMinPoints" not in src


def test_the_build_compiles_each_part_and_links_them(tmp_path, monkeypatch):
    """kernels/_build.py compiles csrc/frontend.cu as `PARTS` objects, each
    with -DFRONTEND_PART=k and -c (no -shared), at most `os.cpu_count()`
    at once, then links them with the library's flags; the source declares
    a part for every group of instantiations and the C entries in part 0."""
    import re

    from mfcc_tpu_torch.kernels import _build

    calls = []
    monkeypatch.setattr(_build, "_run", lambda args, what: calls.append(args) or "")
    src = _build.CSRC / "frontend.cu"
    _build.compile_source(src, tmp_path / "frontend.so", _build.PARTS["frontend"])
    *compiles, link = calls
    assert len(compiles) == _build.PARTS["frontend"] == 17
    assert sorted(a[a.index("-c") + 1] for a in compiles) == sorted(f"-DFRONTEND_PART={k}" for k in range(17))
    assert all("-shared" not in a for a in compiles) and "-shared" in link
    assert [a for a in link if a.endswith(".o")] == [str(tmp_path / f"frontend.part{k}.o") for k in range(17)]
    text = src.read_text()
    parts = re.findall(r"#(?:el)?if FRONTEND_PART == (\d+)\nFRONTEND_DEFINE\(", text)
    assert [int(k) for k in parts] == list(range(1, 17))
    assert "#if !defined(FRONTEND_PART) || FRONTEND_PART == 0" in text  # the C entries
    assert _build._NVCC_SLOTS._initial_value == (os.cpu_count() or 1)
