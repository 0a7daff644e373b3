// Fused MFCC front-end for Hopper (sm_90a): audio rows -> [log-mel | energy].
//
// Replaces mfcc_tpu/kernels/frontend.py::_make_radix4_kernel (:905), slab
// mode, launched from _fused_logmel_energy (:1295) through pl.pallas_call
// (:1552), at N2 = 128 and at whisper80's N2 = 100 with the host reflect
// extension _reflect_extend (:1572-1640) and the log10_floor epilogue
// (:701); _make_kernel (:807-897) with kernel_constants (:160-241), the
// direct DFT of the fp32 dft_passes route, for the sizes radix-4 cannot
// tile, also at any n_fft for the fp32 route; the bf16x3 route on the
// tensor cores; and the dither, frame-first conditioning, log-kind and PLP,
// spectrogram and SSC branches. Plain version and wrapper:
// mfcc_tpu_torch/kernels/frontend.py (logmel_prefix_reference,
// logmel_prefix).
//
// Per utterance b and frame f < F (default branches; N = n_fft):
//   x[t]   = float(audio[b, t]) * scale              (int16 or float32 rows)
//   y[t]   = x[t] - c * x[t-1], x[-1] = 0; then y[t] = 0 for t >= lengths[b]
//   X[k]   = rfft(y[f*S + o : f*S + o + L] * window, n=N)  (zero past T, and
//            past N for frames longer than N; o = 0 unless centered)
//   P[k]   = |X[k]|^2 * pscale                       (k < N/2 + 1)
//   out[b, f, m] = ln(where(mel_m <= 0, eps, mel_m)), mel_m = sum_k P[k] mel[k, m]
//   out[b, f, M] = where(E <= 0, eps, E),             E = sum_k P[k] (unlogged)
// The dither, conditioning, framing, DFT and log-kind branches are
// described below.
//
// Bound at the main path (classic13_deltas, batch 64 x 10 s, int16 rows,
// T = 160,080, F = 999, M = 26; H100 SXM peaks):
//   bytes: 20.49 MB int16 in + 6.90 MB out = 27.4 MB -> 8.2 us at 3.35 TB/s.
//   operations, the function's minimum: 0.4 k window + 6.66 k for a
//     split-radix 256-point complex FFT (4N log2 N - 6N + 8) + 1.78 k real
//     split (its 1/2 scalings fold into pscale) + 0.77 k |X|^2 + 0.92 k mel
//     (the 459 nonzero weights) + 0.26 k energy + 53 clamp/ln = 10,839 FLOP
//     per frame x 56,836 frames that hold samples, plus 2 per sample of
//     pre-emphasis = 0.634 GFLOP -> 9.47 us at 67 TFLOP/s fp32. The
//     operations set the bound; chip_smoke.py computes it from each run's
//     inputs.
// Neither bytes nor operations bind this kernel on Hopper. A frame is
// about a thousand warp instructions of shared-memory passes, index
// arithmetic and butterflies, run as a chain of dependent passes (load ->
// butterfly -> store -> __syncwarp, once per FFT stage), so it is bound by
// instruction issue and shared-memory throughput per SM, and by the passes'
// latency where too few warps are resident. The design cuts each: three
// FFT passes at 256 points where radix 2 took eight, three blocks (24
// warps) an SM, the projection spread evenly over the lanes with its logs
// off the divergent loop, no DFT for frames of zeros, and the staging
// loads issued in batches. PERF.md section 6 gives the measured breakdown
// (staging, DFT and split, projection).
//
// Design. One block per (utterance, tile of 32 frames), 8 warps:
//   1. The tile's sample span, 31*S + L samples (5,360 at S = 160, L = 400),
//      is staged once in shared memory as fp32 after convert, pre-emphasis
//      and zeroing, each thread issuing the loads of kStageBatch samples
//      before it uses any, so their latencies overlap. Each input byte is
//      read about once (the overlap
//      between tiles and the x[t-1] re-read are served by L1/L2);
//      pre-emphasis reads the previous tile's last sample from global
//      memory, so only t = 0 sees x[-1] = 0. Zeroing follows pre-emphasis,
//      so y[length] = 0, and it does not rely on the padding being zero.
//      Under non-centered framing a tile that starts at or past its row's
//      length stages nothing (all its frames are zero frames, step 2z).
//   2. Each warp takes one frame at a time.
//   2z. A frame that starts at or past its row's length (non-centered
//      framing, both forms) holds only zeros by construction, so it takes
//      no DFT: its power row is set to 0, exactly what the DFT of its zero
//      samples gives, and the conditioning's mean and energy are 0. Step 4
//      runs on that row. (11 % of the main path's frames.)
//   3. The DFT, by a warp-uniform switch on the form the host picked from N
//      (no template flag):
//      (a) the Stockham (autosort) FFT, for every even N whose half H = N/2
//          factors into 8s, one 4 or 2, 3s and 5s (256 = 8*8*4: three
//          passes; whisper80's 200 = 8*5*5; 240 = 8*2*3*5): the frame is
//          H complex points z[n] = y[2n] + i y[2n+1]. Stage s of radix R
//          after ns points: butterfly j < H/R reads its R inputs
//          j + r H/R, twists input r by e^{-2 pi i r k/(ns R)}, k = j mod
//          ns, takes the R-point DFT in registers (radix 8 as two radix-4
//          DFTs and the W8 twists) and writes (j - k) R + k + r ns. The
//          last stage leaves natural order: no digit reversal, no __brev.
//          Stage 0 reads its inputs straight from the staged signal, the
//          window (and the conditioning) applied on the way, so the frame
//          is never packed; each later stage reads the row the one before
//          wrote, ping-ponging between the warp's two rows. The twists and
//          each butterfly's output base (j - k) R + k come from host tables
//          per stage (float64 rounded once), so no butterfly takes a
//          remainder or a sincosf. Rows are padded by one float2 after
//          every 8 (index i at i + i/8): stage 0's stride-8 stores, 8-way
//          bank conflicts in a plain row, spread over 16 banks.
//      (b) every other N, odd ones included (N = 404: H = 2*101): a direct
//          DFT, lane k summing X[k] = sum_n v[n] e^{-2 pi i ((k n) mod N)/N}
//          with the exact integer index into a table of all N entries; it
//          costs O(N * bins) a frame and is meant for the sizes nothing
//          else takes, not for speed.
//      Every table is computed on the host in float64; every sum is fp32
//      FMA: no TF32, no bf16 (1-pass reduced precision breaks the 1e-4
//      log-mel gate, docs/KERNEL.md section 3). For (a) the real split gives
//      X[k] and X[H-k] from Z[k] and Z[H-k] (k <= H/2) into the warp's free
//      row, summing the powers on the way (the pspec energy); (b) writes
//      its power row directly. Rows are indexed by bin in every form.
//   4. The projection over packed mel bands: the host packs each filter's
//      nonzero band [lo, hi) filter after filter (459 weights at
//      classic13, 1.8 KB, where the dense [257, 26] matrix took 26.7 KB),
//      with per-filter offsets and, per weight, one word holding its bin,
//      its filter and whether it is the filter's last. The packed weights
//      are cut evenly over the warp's lanes, c = ceil(nnz/32) rounded up to
//      odd (15 at classic13; an odd stride puts the lanes' first weights in
//      32 banks): lane l sums [l c, l c + c) one weight at a time, storing
//      the sum of every filter that ends in its chunk to the warp's sum row
//      and posting the partial of the one that goes on; a filter that began
//      in an earlier lane a is summed by the lane it ends in, as part[a] +
//      ... + part[l-1] + its own sum, in that order, so two runs are
//      bitwise equal. The loop's only branch stores a sum; the clamp and log
//      (or nothing for plp, or the SSC ratio) follow lane-parallel over the
//      sum row, with lane M's energy. Nothing but the [F, M+1] prefix
//      reaches device memory.
//
// Shared memory (floats, every offset 16-byte aligned; kernels/frontend.py
// smem_bytes mirrors it): the signal row (the fused resample's input
// window first when longer), the window, the packed weights (mel; melf
// after it for ssc), the filters' offsets [M+1] and the weights' bin-filter
// words, the twiddles (the split's N/4 + 1 entries, then each later stage's
// (H/R)(R - 1) twists), the stages' output bases, then per warp its two
// rows and its projection scratch (32 lane partials and M sums; twice for
// ssc; none for a spectrogram), then the dither's and fused resample's x
// row and the resample's taps. classic13 takes 71,200 B, logmel80 73,184,
// whisper80 62,832, ssc26 74,832: three blocks an SM (24 warps) for each.
// __launch_bounds__(256, 3) caps the FFT forms at 80 registers a thread.
//
// Centered framing (center != 0; replaces _reflect_extend :1572-1640 and
// its host twin, which write a reflect-extended float32 slab). Frame f
// starts at f*S + o, o = S/2 - L/2 ("center", Kaldi snip_edges=false) or
// -(L/2) ("center_reflect", torch.stft center=True); no extension pass
// and no host rows: the staged position t = f0*S + o + i maps to the
// source index r = reflect(t, max(len, 1)) (ops/chain.py reflect_index,
// any number of wraps), and the kernel reads row[r] as int16 or float32.
// The reference pre-emphasizes, dithers and zeroes the flat signal before
// it reflects, so the staged value is y[r] = x[r] - c x[r-1] at the SOURCE
// index (x[-1] = 0, the noise keyed on r, y = 0 for a length-0 row), not
// the difference of two staged neighbours, which differ at the seams.
// Reflected frames hold samples, so centered framing skips no frame.
//
// Bound at whisper80 (batch 64 x 30 s int16, all lengths 480,000, T =
// 480,240, F = 3,000, M = 80, N = 400): bytes 61.4 MB in + 62.2 MB of
// [64, 3000, 81] out = 123.6 MB -> ~37 us; operations ~8.6 k a frame at the
// function's minimum (a 200-point complex FFT counted by the split-radix
// formula, the real split, |X|^2, 80 Slaney filters over their nonzero
// weights, 80 log10 and the energy) x 192,000 frames ~ 1.65 GFLOP -> ~25
// us: bytes bound it, a little. chip_smoke.py computes both from each
// run's inputs.
//
// Fused resample (kResample; entry mfcc_frontend_logmel_resample). Replaces
// the in-kernel resample of mfcc_tpu/kernels/frontend.py::_gather_frames
// (:493-529, two fp32 dots over blocked sr_in rows). The rows are at sr_in
// (T and lengths[b] in input samples); x above is the sr_in signal
// resampled by the polyphase FIR of polyphase.cuh (scipy resample_poly,
// zero padding), with input_scale folded into the taps:
//   x[t]   = sum_i tab[p(t), i] * in[q(t) - i],  in[u] = 0 unless 0 <= u < lengths[b]
//   y[t]   = x[t] - c * x[t-1] with x[-1] = 0; then y[t] = 0 for
//            t >= ceil(lengths[b] * up / down)
// Staging becomes: the tile's input window (span*down/up + K samples) and
// the [up][K] tap table into shared memory, then x[t0-1 .. t0+span) by the
// FIR (only t < the output length), then pre-emphasis and zeroing into the
// signal row, which reuses the input window's memory. The resampled signal
// never reaches device memory. Frames past the output length take step 2z.
// Shared memory at 44.1 kHz (up = 160, K = 56): 166,384 B, one block an SM.
// No centered framing.
// Bound at mfcc39_48k (batch 64 x 10 s int16, lengths 480,000 - 1,713*i):
//   bytes: 54.5 MB int16 in + 6.9 MB out -> ~18 us;
//   operations: 91 FLOP per output sample that holds signal (61 symmetric
//   taps folded) x ~9.1 M = 0.83 GFLOP, plus the front-end's 0.63 GFLOP
//   -> ~22 us: operations bound it (chip_smoke.py computes it per run).
//
// Dither (kDither; replaces _gather_frames' slab dither, frontend.py
// :537-546, and the hash of mfcc_tpu/ops/dither.py::dither_field :113-136).
// Every source sample 0 <= t < length (at 16 kHz: output positions in the
// fused form, masked at the output length) becomes
//   x[t] + sigma * noise(t),  noise(t) = BoxMuller16(fmix32(fmix32(
//       (t / S) * GOLDEN ^ seed') + t % S)),  seed' = fmix32(seed) (host)
// before pre-emphasis (mfcc_tpu_torch/ops/dither.py states the contract).
// The hash is native uint32; the uniforms (k + 0.5) * 2^-16 and the cos
// polynomial use __fmul_rn / __fadd_rn, so nvcc contracts none of them into
// an FMA and they stay bit-equal to the numpy contract; only logf and sqrtf
// may differ by ulps. The plain form stages x[t0-1 .. t0+span) once,
// dithered, in a shared row (as the fused form's resampled row), and
// pre-emphasizes from there, so the hash runs once per staged sample;
// centered framing hashes x[r] (and x[r-1] when c != 0) per staged sample.
// Cost per sample that holds signal: 30 float operations (uniforms 4, ln,
// -2x, sqrt, cos 20, r cos, sigma n, the add) and 25 integer ones (two
// fmix32, the row key, t / S and t % S, the 16-bit halves and their
// conversions).
//
// Frame-first conditioning (kCond; replaces _make_conditioning :620-655,
// _win_energy_np :244-251, and the staging without pre-emphasis of
// _gather_preemph :1643-1651): the staged signal is x zeroed at t >= length
// (the host passes preemph = 0 in "frame" mode), and per frame, in the
// warp that transforms it, over ALL of the frame's L samples f[n] (L may
// exceed N: the span stages all L, as the TPU kernel widens its chunk
// window, frontend.py:303-307, and only the first N are transformed):
//   mu   = sum f / L (remove_dc; else 0), a warp sum;
//   E    = sum (f - mu)^2 (raw_frame; a second pass over shared memory,
//          not sum f^2 - L mu^2, which cancels);
//   g[0] = (f0 - mu)(1 - c), g[n] = (fn - mu) - c (fn-1 - mu) (c = 0
//          outside "frame" mode), folded into the DFT's first loads, which
//          read fr[a] and fr[a-1] from the staged row;
//   E    = sum (w g)^2 (windowed_frame), from those loads and a pass over
//          the samples past N;
// and lane M holds max(E, eps) for the two frame energies.
//
// Epilogue log kinds (_make_epilogue :693-702), a warp-uniform switch:
//   ln: ln(where(m <= 0, eps, m)); ln_stab: ln(m + 1e-6);
//   db: 10 log10(where(m <= 0, eps, m)); ln_floor: ln(max(m, eps));
//   log10_floor: log10f(max(m, eps)) (CUDA's log10f, not ln times 1/ln 10).
//
// Bound of the new branches at kaldi_mfcc b64 x 10 s (F = 998, M = 23):
// conditioning adds 6L - 1 = 2,399 operations per frame (mean, centering,
// raw energy, frame pre-emphasis), 0.74 GFLOP in all -> 11.0 us; dither 55
// operations per sample that holds signal (the integer ones counted at the
// fp32 rate), +0.50 G -> 18.5 us. Both stay bound by operations; logmel80 at
// b256 is bound by its 83 MB of output (38 us). chip_smoke.py computes every
// bound from its run's inputs.
//
// Feature kinds (feature_kind, a warp-uniform switch in step 4 of every
// form; _make_epilogue :660-712):
//   logmel (mfcc and logmel configs): the log kind of the band sum, above.
//   plp (the PLP branch, :682-692): o[m] = the band sum, unlogged; lane M
//     the energy. ops/chain.py plp_base does the rest in tensor code.
//   spectrogram (the multi-tile output, :308-311): the identity projection,
//     o[m] = log kind of P[m] for m < M = N/2 + 1, lane M the energy, lane
//     m taking bins m, m + 32, ... No table is staged.
//   ssc (:965-975 and epilogue_ssc :673-677): per bin q[k] = P[k] <= 0 ?
//     eps : P[k], then o[m] = sum q[k] melf[k, m] / sum q[k] mel[k, m] over
//     the band (IEEE division), with melf[k, m] = f_k mel[k, m] rounded once
//     from float64 on the host and packed as mel is; both sums ride the same
//     lane split; o[M] = 0. P is indexed by bin here, so the TPU kernel's
//     per-lane clamp of eps / lanes_per_bin (a workaround for its scrambled
//     radix-4 lane order) is not needed.
// Bounds at b64 x 10 s int16 (chip_smoke.py computes them per run):
// kaldi_spectrogram is bound by bytes (20.5 MB in + 65.9 MB of
// [64, 998, 258] out: ~26 us); kaldi_plp (~11 us, kaldi_mfcc's operations
// less the logs) and ssc26 (~10 us: the clamps, two sums per weight and the
// divisions instead of the logs and the energy) by operations.
//
// The bf16x3 form (dft_form 2, kBf16x3; replaces the dft_passes="bf16x3"
// route of _make_kernel, :857-867, with the window-folded matrix of
// kernel_constants :160-241). An opt-in of its own accuracy class (~1e-4 on
// loud log-mel bins, as the reference's), chosen by the wrapper's dft_passes
// and not by n_fft; no config and no default path takes it. After staging and
// the per-frame conditioning, the tile's 32 frames go to shared memory as
// bf16 hi = rn(g) and lo = rn(g - hi) of the conditioned, unwindowed samples
// (the window rides the matrix), [32][kp] each (51 KB at L = 400), zero past
// min(L, n_fft). The matrix (hi and lo, [kp][2 nbp] bf16, 0.87 MB at n_fft
// 512, built on the host from constants.folded_dft) stays in device memory
// and L2. Each warp takes (16 frames, 16 bins): wmma bf16 m16n16k16 with fp32
// accumulation sums ah Wh + al Wh + ah Wl for the cosine block and the sine
// block of the same bins, so |X|^2 forms element-wise in registers and one
// store writes the tile's power rows [32][nbp]; the al Wl term (~2^-16
// relative) is dropped, as in the reference. Then step 4 as in every form.
// It takes the plain form's framing, dither, conditioning and feature-kind
// branches (it stages every tile and transforms every frame); the
// fused-resample form has no bf16x3 instantiation.
// Bound: the bytes and the function's minimum of the other forms (9.47 us at
// classic13 b64 x 10 s, by operations). The three passes alone are 3 x 2 x
// 400 x 514 = 1.23 MFLOP a frame: 0.0709 ms of bf16 tensor work at 989 TFLOP/s
// for 56,836 frames, 7.5x that minimum, so on Hopper the matrix DFT is no
// throughput route (the TPU's MXU made it one). Shared memory at classic13:
// 115,360 B, two blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "polyphase.cuh"

namespace {

constexpr int kTile = 32;  // frames per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFftBlocks = 3;   // blocks an SM the FFT forms are built for
constexpr int kStageBatch = 8;  // samples a thread loads at once while staging
constexpr int kProjBatch = 4;   // packed weights a lane loads at once in the projection
constexpr int kMaxStages = 16;  // Stockham stages, 4 bits each in Params::radices

// energy_source, log_kind, feature_kind, DFT form and reflection codes
// (kernels/frontend.py ENERGY_SOURCES, ops/chain.py LOG_KINDS,
// kernels/frontend.py FEATURE_KINDS, DFT_FORMS, CENTER_CODES)
enum { kPspec = 0, kRawFrame = 1, kWindowedFrame = 2 };
enum { kLn = 0, kLnStab = 1, kDb = 2, kLnFloor = 3, kLog10Floor = 4 };
enum { kLogmel = 0, kPlp = 1, kSpectrogram = 2, kSsc = 3 };
enum { kStockham = 0, kDirect = 1, kBf16x3 = 2 };
enum { kNoCenter = 0, kCenter = 1, kCenterReflect = 2 };

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int align8(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Per-config scalars of one launch.
struct Params {
  int T, F, L, S, M;
  // packed mel weights (kernels/frontend.py mel_packed)
  int nnz;
  // DFT size and form; frame 0's first sample (0, S/2 - L/2 or -(L/2)) and
  // the reflection kind of centered framing
  int n_fft, form, offset, center;
  float scale, preemph, eps, pscale;
  // dither (kDither): sigma and the host-premixed seed fmix32(seed)
  float dither;
  uint32_t seed;
  // conditioning (kCond); frame_keep0 = 1 - frame_preemph, rounded on the host
  int remove_dc, energy_source, log_kind;
  float frame_preemph, frame_keep0;
  int feature_kind;
  // derived on the host (plan()): half = n_fft / 2, bins = n_fft / 2 + 1;
  // the Stockham radices, stage s in bits [4s, 4s + 4); the twiddle and
  // output-base table lengths; the projection's weights a lane; for the
  // bf16x3 form the matrix depth kp = min(L, n_fft) and bins nbp, each
  // rounded up to 16
  int half, bins, nstages;
  unsigned long long radices;
  int ntw, nbases, chunk, kp, nbp;
};

// Packed weight tables staged for the feature kind: mel; none for the
// spectrogram's identity; mel and melf for ssc.
__host__ __device__ inline int weight_tables(const Params& p) {
  return p.feature_kind == kSpectrogram ? 0 : p.feature_kind == kSsc ? 2 : 1;
}

// Dynamic shared memory layout, in floats (every offset 16-byte aligned;
// the header states it, kernels/frontend.py smem_bytes mirrors it). part is
// warp 0's projection scratch (32 lane partials and the M filter sums, for
// each weight table), pstride the step to the next warp's.
struct Layout {
  int span, win, melw, melf, moff, meta, tw, bases, buf, row, part, pstride, pw, ef, xs, tab,
      total;
};

__host__ __device__ inline Layout layout(const Params& p, int in_len, int taps, bool xs) {
  Layout l;
  const int tables = weight_tables(p);
  const int parts = align4(tables * (32 + p.M));
  l.span = (kTile - 1) * p.S + p.L;
  l.win = align4(imax(l.span, in_len));
  l.melw = l.win + align4(imax(p.L, p.n_fft));
  l.melf = l.melw + align4(p.nnz);  // ssc only
  l.moff = l.melw + tables * align4(p.nnz);
  l.meta = l.moff + (tables ? align4(p.M + 1) : 0);
  l.tw = l.meta + (tables ? align4(p.nnz) : 0);
  l.bases = l.tw + align4(2 * p.ntw);
  l.buf = l.bases + align4(p.nbases);
  if (p.form == kBf16x3) {
    l.buf = align8(l.buf);
    l.row = 0;
    l.pw = l.buf + kTile * p.kp;  // two bf16 rows of kp a frame = kp floats
    l.ef = l.pw + kTile * p.nbp;
    l.part = l.ef + kTile;
    l.pstride = parts;
    l.xs = l.part + kWarps * parts;
  } else {
    l.row = p.form == kStockham ? align4(2 * (p.half + (p.half >> 3) + 1))
                                : align4(imax(p.n_fft, p.bins));
    l.part = l.buf + 2 * l.row;
    l.pstride = 2 * l.row + parts;
    l.pw = l.ef = 0;
    l.xs = l.buf + kWarps * l.pstride;
  }
  l.tab = l.xs + (xs ? align4(l.span + 1) : 0);
  l.total = l.tab + align4(taps);
  return l;
}

__host__ __device__ inline int resample_window(const Params& p, const Polyphase& pp) {
  return pp_input_span((kTile - 1) * p.S + p.L + 1, pp);  // x[t0-1 .. t0+span)
}

__device__ inline float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ inline float to_f32(float v) { return v; }

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// murmur3 fmix32
__device__ inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// cos(2 pi u), u in (0, 1), from exact float ops in the contract's order
// (ops/dither.py _cos2pi): quarter-period reduction, then Horner in b^2 on
// the float32 Taylor coefficients _C2PI (hex literals, held against the
// Python table by tests/test_torch_dither.py).
__device__ inline float cos2pi(float u) {
  const float a = __fsub_rn(u, floorf(__fadd_rn(u, 0.5f)));
  const float aa = fabsf(a);
  const bool flip = aa > 0.25f;
  const float b = flip ? __fsub_rn(0.5f, aa) : aa;
  const float t = __fmul_rn(b, b);
  float acc = 0x1.f9d38ap+2f;                         // C2PI[6]
  acc = __fadd_rn(__fmul_rn(acc, t), -0x1.a6d1f2p+4f);  // C2PI[5]
  acc = __fadd_rn(__fmul_rn(acc, t), 0x1.e1f506p+5f);   // C2PI[4]
  acc = __fadd_rn(__fmul_rn(acc, t), -0x1.55d3c8p+6f);  // C2PI[3]
  acc = __fadd_rn(__fmul_rn(acc, t), 0x1.03c1f0p+6f);   // C2PI[2]
  acc = __fadd_rn(__fmul_rn(acc, t), -0x1.3bd3ccp+4f);  // C2PI[1]
  acc = __fadd_rn(__fmul_rn(acc, t), 0x1p+0f);          // C2PI[0]
  return flip ? -acc : acc;
}

// x + sigma * noise(t): the dither contract at signal position 0 <= t < 2^32.
__device__ inline float dithered(float x, uint32_t t, const Params& p) {
  const uint32_t row = t / static_cast<uint32_t>(p.S);
  const uint32_t lane = t - row * static_cast<uint32_t>(p.S);
  const uint32_t h = fmix32(fmix32((row * 0x9E3779B9u) ^ p.seed) + lane);
  const float k = 1.f / 65536.f;
  const float u1 = __fmul_rn(__fadd_rn(static_cast<float>(h >> 16), 0.5f), k);
  const float u2 = __fmul_rn(__fadd_rn(static_cast<float>(h & 0xFFFFu), 0.5f), k);
  const float n = __fmul_rn(sqrtf(__fmul_rn(-2.f, logf(u1))), cos2pi(u2));
  return __fadd_rn(x, __fmul_rn(p.dither, n));
}

// The source sample x[t] (0 <= t < length): converted, scaled, and under
// kDither plus the contract noise keyed on t.
template <bool kDither, typename Sample>
__device__ inline float source(const Sample* row, long long t, const Params& p) {
  const float x = to_f32(row[t]) * p.scale;
  if constexpr (kDither) return dithered(x, static_cast<uint32_t>(t), p);
  return x;
}

// ops/chain.py reflect_index: t -> [0, n), n >= 1. "center" repeats the
// edge sample (period 2n), "center_reflect" does not (period 2(n-1), 1 at
// n = 1). Indices inside the row map to themselves without a division.
__device__ inline long long reflect(long long t, long long n, int kind) {
  if (t >= 0 && t < n) return t;
  const long long per = kind == kCenter ? 2 * n : (n > 1 ? 2 * n - 2 : 1);
  long long m = t % per;
  if (m < 0) m += per;
  if (m < n) return m;
  return kind == kCenter ? 2 * n - 1 - m : 2 * n - 2 - m;
}

__device__ inline float log_lane(float m, const Params& p) {
  switch (p.log_kind) {
    case kLnStab: return logf(m + 1e-6f);
    case kDb: return 10.f * log10f(m <= 0.f ? p.eps : m);
    case kLnFloor: return logf(fmaxf(m, p.eps));
    case kLog10Floor: return log10f(fmaxf(m, p.eps));
    default: return logf(m <= 0.f ? p.eps : m);
  }
}

__device__ inline float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

__device__ inline float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ inline float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

// A Stockham row's index i lives at i + i/8: one float2 of padding after
// every 8, so stride-8 stores spread over the banks.
__device__ inline int pad(int i) { return i + (i >> 3); }

// R-point forward DFTs, X[q] = sum_r v[r] e^{-2 pi i r q / R}, in place.
// Constants are float64 values rounded once to float32 (no sincosf).
template <int R>
__device__ inline void dft_small(float2 (&v)[R]);

template <>
__device__ inline void dft_small<2>(float2 (&v)[2]) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ inline void dft_small<3>(float2 (&v)[3]) {
  const float s = 0x1.bb67aep-1f;  // sin(2 pi / 3)
  const float2 t1 = cadd(v[1], v[2]);
  const float2 t2 = csub(v[1], v[2]);
  const float2 a = make_float2(v[0].x - 0.5f * t1.x, v[0].y - 0.5f * t1.y);
  v[0] = cadd(v[0], t1);
  v[1] = make_float2(a.x + s * t2.y, a.y - s * t2.x);  // a - i s t2
  v[2] = make_float2(a.x - s * t2.y, a.y + s * t2.x);  // a + i s t2
}

template <>
__device__ inline void dft_small<4>(float2 (&v)[4]) {
  const float2 a0 = cadd(v[0], v[2]);
  const float2 a1 = csub(v[0], v[2]);
  const float2 b0 = cadd(v[1], v[3]);
  const float2 b1 = csub(v[1], v[3]);
  v[0] = cadd(a0, b0);
  v[1] = make_float2(a1.x + b1.y, a1.y - b1.x);  // a1 - i b1
  v[2] = csub(a0, b0);
  v[3] = make_float2(a1.x - b1.y, a1.y + b1.x);  // a1 + i b1
}

template <>
__device__ inline void dft_small<5>(float2 (&v)[5]) {
  const float c1 = 0x1.3c6ef4p-2f;   // cos(2 pi / 5)
  const float c2 = -0x1.9e377ap-1f;  // cos(4 pi / 5)
  const float s1 = 0x1.e6f0e2p-1f;   // sin(2 pi / 5)
  const float s2 = 0x1.2cf230p-1f;   // sin(4 pi / 5)
  const float2 t1 = cadd(v[1], v[4]);
  const float2 t2 = cadd(v[2], v[3]);
  const float2 t3 = csub(v[1], v[4]);
  const float2 t4 = csub(v[2], v[3]);
  const float2 a1 = make_float2(v[0].x + c1 * t1.x + c2 * t2.x, v[0].y + c1 * t1.y + c2 * t2.y);
  const float2 a2 = make_float2(v[0].x + c2 * t1.x + c1 * t2.x, v[0].y + c2 * t1.y + c1 * t2.y);
  const float2 b1 = make_float2(s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y);
  const float2 b2 = make_float2(s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y);
  v[0] = make_float2(v[0].x + t1.x + t2.x, v[0].y + t1.y + t2.y);
  v[1] = make_float2(a1.x + b1.y, a1.y - b1.x);  // a1 - i b1
  v[4] = make_float2(a1.x - b1.y, a1.y + b1.x);  // a1 + i b1
  v[2] = make_float2(a2.x + b2.y, a2.y - b2.x);  // a2 - i b2
  v[3] = make_float2(a2.x - b2.y, a2.y + b2.x);  // a2 + i b2
}

// Radix 8 as two radix-4 DFTs of the even and odd inputs, then
// X[q] = E[q] + W8^q O[q] and X[q + 4] = E[q] - W8^q O[q], W8 = e^{-i pi/4}.
template <>
__device__ inline void dft_small<8>(float2 (&v)[8]) {
  const float h = 0x1.6a09e6p-1f;  // sqrt(2) / 2
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft_small<4>(e);
  dft_small<4>(o);
  const float2 t1 = make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));   // (1 - i) h o1
  const float2 t2 = make_float2(o[2].y, -o[2].x);                                // -i o2
  const float2 t3 = make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));  // -(1 + i) h o3
  v[0] = cadd(e[0], o[0]);
  v[4] = csub(e[0], o[0]);
  v[1] = cadd(e[1], t1);
  v[5] = csub(e[1], t1);
  v[2] = cadd(e[2], t2);
  v[6] = csub(e[2], t2);
  v[3] = cadd(e[3], t3);
  v[7] = csub(e[3], t3);
}

// One Stockham stage of radix R over H points after ns = the product of the
// earlier radices: butterfly j < H/R loads inputs j + r H/R (stage 0 by
// first(n), from the staged signal; later stages from the padded row src), twists
// input r by tw[j (R-1) + r - 1] = e^{-2 pi i r k/(ns R)}, k = j mod ns (none
// at ns = 1: every twist is 1), and stores output r at base[j] + r ns =
// (j - k) R + k + r ns into the padded row dst.
template <int R, bool kFirst, typename First>
__device__ inline void stockham_stage(First first, const float2* __restrict__ src,
                                      float2* __restrict__ dst, int H, int ns,
                                      const float2* __restrict__ tw,
                                      const int* __restrict__ base, int lane) {
  const int hr = H / R;
  for (int j = lane; j < hr; j += 32) {
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (kFirst) {
        v[r] = first(j + r * hr);
      } else {
        v[r] = src[pad(j + r * hr)];
      }
    }
    if (ns > 1) {
      const float2* w = tw + j * (R - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], w[r - 1]);
    }
    dft_small<R>(v);
    const int d = base[j];
#pragma unroll
    for (int r = 0; r < R; ++r) dst[pad(d + r * ns)] = v[r];
  }
}

template <bool kFirst, typename First>
__device__ inline void stage_of_radix(int R, First first, const float2* src, float2* dst, int H,
                                      int ns, const float2* tw, const int* base, int lane) {
  switch (R) {  // warp-uniform
    case 8: stockham_stage<8, kFirst>(first, src, dst, H, ns, tw, base, lane); break;
    case 4: stockham_stage<4, kFirst>(first, src, dst, H, ns, tw, base, lane); break;
    case 2: stockham_stage<2, kFirst>(first, src, dst, H, ns, tw, base, lane); break;
    case 3: stockham_stage<3, kFirst>(first, src, dst, H, ns, tw, base, lane); break;
    default: stockham_stage<5, kFirst>(first, src, dst, H, ns, tw, base, lane); break;
  }
}

// 3a. The Stockham FFT of the frame's H = n_fft/2 complex points: stage 0
//     loads point n by first(n) (from the staged signal), each later stage
//     the row the one before stored, ping-ponging between the warp's rows a
//     and b. tw holds the stage twists (after the split's entries), base
//     the output bases, stage after stage. Returns the row holding Z.
template <typename First>
__device__ inline const float2* stockham(First first, float2* a, float2* b, const Params& p,
                                         const float2* tw, const int* base, int lane) {
  float2* dst = a;
  const float2* src = b;
  int ns = 1;
  for (int s = 0; s < p.nstages; ++s) {
    const int R = static_cast<int>((p.radices >> (4 * s)) & 15u);
    if (s == 0) {
      stage_of_radix<true>(R, first, nullptr, dst, p.half, 1, tw, base, lane);
    } else {
      stage_of_radix<false>(R, first, src, dst, p.half, ns, tw, base, lane);
      tw += (p.half / R) * (R - 1);
    }
    base += p.half / R;
    __syncwarp();
    src = dst;
    dst = dst == a ? b : a;
    ns *= R;
  }
  return src;
}

// Real split of the half-size complex FFT Z (a padded row) of
// z[n] = y[2n] + i y[2n+1]:
// Xe = (Z[k] + conj Z[H-k]) / 2, Xo = (Z[k] - conj Z[H-k]) / 2i,
// X[k] = Xe + W^k Xo and X[H-k] = conj(Xe - W^k Xo), W = e^{-2 pi i / n_fft},
// for k <= H/2; |X|^2 * pscale into pw[k] and pw[H-k] (once when 2k = H).
// Returns the warp sum of the powers (the pspec energy).
__device__ inline float real_split(const float2* __restrict__ Z, float* __restrict__ pw,
                                   const float2* __restrict__ tw, int H, float pscale, int lane) {
  float es = 0.f;
  for (int k = lane; k <= H / 2; k += 32) {
    const float2 a = Z[pad(k)];
    const float2 c = Z[pad(k == 0 ? 0 : H - k)];
    const float er = 0.5f * (a.x + c.x);
    const float ei = 0.5f * (a.y - c.y);
    const float orr = 0.5f * (a.y + c.y);
    const float oi = -0.5f * (a.x - c.x);
    const float2 w = tw[k];
    const float wr = orr * w.x - oi * w.y;
    const float wi = orr * w.y + oi * w.x;
    const float xr = er + wr, xi = ei + wi;
    const float px = (xr * xr + xi * xi) * pscale;
    pw[k] = px;
    es += px;
    if (2 * k != H) {
      const float yr = er - wr, yi = ei - wi;
      const float py = (yr * yr + yi * yi) * pscale;
      pw[H - k] = py;
      es += py;
    }
  }
  return warp_sum(es);
}

// The warp sum of a power row (the pspec energy of the direct and bf16x3
// forms).
__device__ inline float power_sum(const float* pw, int bins, int lane) {
  float es = 0.f;
  for (int k = lane; k < bins; k += 32) es += pw[k];
  return warp_sum(es);
}

// 3b. The direct DFT of v[0 .. Lk): lane bins k, X[k] = sum_n v[n] W^{(k n)
//     mod n_fft} with the exact integer index into the whole-circle table.
__device__ inline void direct_dft(const float* v, float* pw, const float2* tw, const Params& p,
                                  int Lk, int lane) {
  const int N = p.n_fft;
  for (int k = lane; k < p.bins; k += 32) {
    float re = 0.f, im = 0.f;
    int m = 0;  // (k n) mod N
    for (int n = 0; n < Lk; ++n) {
      const float2 w = tw[m];
      re += v[n] * w.x;
      im += v[n] * w.y;
      m += k;
      if (m >= N) m -= N;
    }
    pw[k] = (re * re + im * im) * p.pscale;
  }
}

// Shared-memory views of the packed mel bands: filter m's weights are
// w[off[m] .. off[m+1]) (wf: melf, ssc); meta[i] = k | m << 16, with the
// sign bit set on a filter's last weight, gives weight i's bin k and filter
// m (kernels/frontend.py mel_packed, packed_meta).
struct Bands {
  const float* w;
  const float* wf;
  const int* off;
  const int* meta;
};

// 4. One frame's output row o from its power row pw (pw[k], k < bins), by
//    feature kind: the projection over the packed bands, then the log kind
//    (logmel), nothing (plp) or the centroid (ssc, over the clamped
//    powers); the log kind of power bin m (spectrogram). Lane l sums the
//    packed weights [l c, l c + c) in order, c = p.chunk: a filter that
//    ends in the lane's chunk has its sum stored to sum[m] there, the
//    partial of the one that goes on is posted to part[l], and a filter
//    that began in an earlier lane `from` (-1: the chunk starts a filter)
//    is summed by the lane it ends in as part[from] + ... + part[l-1] + its
//    own sum. Then lane m takes the log kind (or the ratio) of sum[m], m,
//    m + 32, ..., off the divergent loop, and lane M `energy`. scratch
//    holds part [32] and sum [M] (for ssc then the melf ones).
__device__ inline void write_frame(float* o, const float* pw, float energy, const Bands& bd,
                                   float* scratch, int from, const Params& p, int lane) {
  const int M = p.M, kind = p.feature_kind;
  if (kind == kSpectrogram) {
    for (int m = lane; m < M; m += 32) o[m] = log_lane(pw[m], p);
  } else {
    const bool ssc = kind == kSsc;
    float* part = scratch;
    float* sum = scratch + 32;
    float* partf = sum + M;  // ssc only
    float* sumf = partf + 32;
    const int i0 = lane * p.chunk, i1 = imin(i0 + p.chunk, p.nnz);
    float acc = 0.f, accf = 0.f, hacc = 0.f, haccf = 0.f;
    int held = -1;  // the filter begun in lane `from` that ends in this one
    bool head = from >= 0;
    for (int i = i0; i < i1; i += kProjBatch) {
      // a batch's loads first: the sums' stores below would order them
      int e[kProjBatch];
      float q[kProjBatch], w[kProjBatch], wf[kProjBatch];
#pragma unroll
      for (int u = 0; u < kProjBatch; ++u) {
        const bool in = i + u < i1;
        e[u] = in ? bd.meta[i + u] : 0;
        w[u] = in ? bd.w[i + u] : 0.f;
        wf[u] = in && ssc ? bd.wf[i + u] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kProjBatch; ++u) q[u] = pw[e[u] & 0xFFFF];
#pragma unroll
      for (int u = 0; u < kProjBatch; ++u) {
        if (i + u >= i1) break;
        if (ssc) {
          q[u] = q[u] <= 0.f ? p.eps : q[u];
          accf += q[u] * wf[u];
        }
        acc += q[u] * w[u];
        if (e[u] < 0) {  // the last weight of filter m
          const int m = (e[u] >> 16) & 0x7FFF;
          if (head) {
            hacc = acc;
            haccf = accf;
            held = m;
            head = false;
          } else {
            sum[m] = acc;
            if (ssc) sumf[m] = accf;
          }
          acc = accf = 0.f;
        }
      }
    }
    part[lane] = acc;
    if (ssc) partf[lane] = accf;
    __syncwarp();
    if (held >= 0) {
      float s = part[from], sf = ssc ? partf[from] : 0.f;
      for (int l = from + 1; l < lane; ++l) {
        s += part[l];
        if (ssc) sf += partf[l];
      }
      sum[held] = s + hacc;
      if (ssc) sumf[held] = sf + haccf;
    }
    __syncwarp();
    for (int m = lane; m < M; m += 32) {
      o[m] = ssc ? __fdiv_rn(sumf[m], sum[m]) : kind == kPlp ? sum[m] : log_lane(sum[m], p);
    }
  }
  if (lane == 0) o[M] = energy;
}

// 3c. The bf16x3 DFT of the tile (kBf16x3): X = ah Wh + al Wh + ah Wl on the
//     tensor cores (wmma bf16 m16n16k16, fp32 accumulation), frames [kTile,
//     kp] as bf16 hi a and lo al in shared memory, the window-folded, scaled
//     matrix W [kp, 2 nbp] (hi Wh, lo Wl) in device memory, L2-resident,
//     its column block 2j the cosines and 2j + 1 the sines of bins
//     [16j, 16j + 16). A warp takes a (16-frame, 16-bin) tile: both
//     accumulators share one fragment layout, so |X|^2 = re^2 + im^2 forms
//     element-wise in registers before one store into the power rows.
__device__ inline void bf16x3_dft(const __nv_bfloat16* ahi, const __nv_bfloat16* alo,
                                  const __nv_bfloat16* __restrict__ whi,
                                  const __nv_bfloat16* __restrict__ wlo, float* pw,
                                  const Params& p, int warp) {
  namespace wmma = nvcuda::wmma;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  const int ldw = 2 * p.nbp;
  const int blocks = p.nbp / 16;
  for (int item = warp; item < (kTile / 16) * blocks; item += kWarps) {
    const int rt = item % (kTile / 16), j = item / (kTile / 16);
    const __nv_bfloat16* ah_row = ahi + rt * 16 * p.kp;
    const __nv_bfloat16* al_row = alo + rt * 16 * p.kp;
    FragC re, im;
    wmma::fill_fragment(re, 0.f);
    wmma::fill_fragment(im, 0.f);
#pragma unroll 1
    for (int k = 0; k < p.kp; k += 16) {
      FragA ah, al;
      FragB ch, cl, sh, sl;
      const size_t off = static_cast<size_t>(k) * ldw + 32 * j;
      wmma::load_matrix_sync(ah, ah_row + k, p.kp);
      wmma::load_matrix_sync(al, al_row + k, p.kp);
      wmma::load_matrix_sync(ch, whi + off, ldw);
      wmma::load_matrix_sync(sh, whi + off + 16, ldw);
      wmma::load_matrix_sync(cl, wlo + off, ldw);
      wmma::load_matrix_sync(sl, wlo + off + 16, ldw);
      wmma::mma_sync(re, ah, ch, re);
      wmma::mma_sync(re, al, ch, re);
      wmma::mma_sync(re, ah, cl, re);
      wmma::mma_sync(im, ah, sh, im);
      wmma::mma_sync(im, al, sh, im);
      wmma::mma_sync(im, ah, sl, im);
    }
    for (int t = 0; t < re.num_elements; ++t) {
      re.x[t] = __fadd_rn(__fmul_rn(re.x[t], re.x[t]), __fmul_rn(im.x[t], im.x[t]));
    }
    wmma::store_matrix_sync(pw + rt * 16 * p.nbp + 16 * j, re, p.nbp, wmma::mem_row_major);
  }
}

template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16>
__global__ void __launch_bounds__(kThreads, kBf16 ? 1 : kFftBlocks)
logmel_kernel(const Sample* __restrict__ audio, const int* __restrict__ lengths,
              float* __restrict__ out, const float* __restrict__ window,
              const float* __restrict__ mel_w, const float* __restrict__ melf_w,
              const int* __restrict__ mel_off, const int* __restrict__ mel_meta,
              const float2* __restrict__ twiddle, const int* __restrict__ bases,
              const __nv_bfloat16* __restrict__ dft_hi, const __nv_bfloat16* __restrict__ dft_lo,
              const float* __restrict__ taps, Params p, Polyphase pp) {
  extern __shared__ __align__(128) float smem[];
  const int T = p.T, F = p.F, L = p.L, S = p.S, M = p.M;
  const int kind = p.feature_kind;
  const float preemph = p.preemph;
  const Layout lay = kResample ? layout(p, resample_window(p, pp), pp.up * pp.K, true)
                               : layout(p, 0, 0, kDither);
  float* sig = smem;
  float* win = smem + lay.win;
  int* moff = reinterpret_cast<int*>(smem + lay.moff);
  int* meta = reinterpret_cast<int*>(smem + lay.meta);
  const Bands bd{smem + lay.melw, smem + lay.melf, moff, meta};
  float2* tw = reinterpret_cast<float2*>(smem + lay.tw);
  int* sb = reinterpret_cast<int*>(smem + lay.bases);

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTile;
  const long long t0 = static_cast<long long>(f0) * S;
  const Sample* row = audio + static_cast<size_t>(b) * T;

  const int wlen = imax(L, p.n_fft);
  for (int i = threadIdx.x; i < wlen; i += kThreads) win[i] = i < L ? window[i] : 0.f;
  if (kind != kSpectrogram) {
    float* w = smem + lay.melw;
    float* wf = smem + lay.melf;
    for (int i = threadIdx.x; i < p.nnz; i += kThreads) {
      w[i] = mel_w[i];
      meta[i] = mel_meta[i];
      if (kind == kSsc) wf[i] = melf_w[i];
    }
    for (int i = threadIdx.x; i <= M; i += kThreads) moff[i] = mel_off[i];
  }
  for (int i = threadIdx.x; i < p.ntw; i += kThreads) tw[i] = twiddle[i];
  for (int i = threadIdx.x; i < p.nbases; i += kThreads) sb[i] = bases[i];

  // the row's length at the frame rate's sample rate (the output length of
  // the fused resample): under non-centered framing a frame that starts at
  // or past it holds only zeros (step 2z), and so does every frame of a tile
  // that starts there, which then stages nothing
  const int len_in = max(0, min(lengths[b], T));
  const long long len = kResample ? pp_output_length(len_in, pp) : len_in;
  const bool framed = p.center == kNoCenter;
  const bool stage = kBf16 || !framed || t0 < len;

  if constexpr (kResample) {
    // 1r. the input window and the taps; x[t0-1 .. t0+span) by the FIR
    //     (x[-1] = 0, and 0 past the output length), dithered at output
    //     positions under kDither; then pre-emphasis and zeroing into the
    //     signal row, over the input window
    if (stage) {
      const long long lo = pp_first_input(t0 - 1, pp);
      const int in_len = resample_window(p, pp);
      float* in = sig;
      float* xs = smem + lay.xs;  // xs[i] = x[t0 - 1 + i]
      float* tab = smem + lay.tab;
      for (int i = threadIdx.x; i < in_len; i += kThreads) {
        const long long u = lo + i;
        in[i] = (u >= 0 && u < len_in) ? to_f32(row[u]) : 0.f;
      }
      for (int i = threadIdx.x; i < pp.up * pp.K; i += kThreads) tab[i] = taps[i];
      __syncthreads();
      for (int i = threadIdx.x; i <= lay.span; i += kThreads) {
        const long long t = t0 - 1 + i;
        float x = 0.f;
        if (t >= 0 && t < len) {
          x = pp_output(t, lo, in, tab, pp);
          if constexpr (kDither) x = dithered(x, static_cast<uint32_t>(t), p);
        }
        xs[i] = x;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < lay.span; i += kThreads) {
        sig[i] = t0 + i < len ? xs[i + 1] - preemph * xs[i] : 0.f;
      }
    }
  } else if (!framed) {
    // 1c. centered framing: staged position t = t0 + offset + i reads the
    //     source index r = reflect(t, max(len, 1)) and stages
    //     y[r] = x[r] - c x[r-1] (x[-1] = 0; dithered x keyed on r under
    //     kDither), 0 when r >= len: pre-emphasis and noise at the source
    //     index, as the signal is pre-emphasized before it is reflected
    const long long n = len > 0 ? len : 1;
    for (int i0 = threadIdx.x; i0 < lay.span; i0 += kThreads * kStageBatch) {
      long long r[kStageBatch];
      float x[kStageBatch], xp[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        r[u] = reflect(t0 + p.offset + i0 + u * kThreads, n, p.center);
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {  // the indices first, so the loads issue together
        const bool in = i0 + u * kThreads < lay.span && r[u] < len;
        x[u] = in ? source<kDither>(row, r[u], p) : 0.f;
        xp[u] = in && preemph != 0.f && r[u] > 0 ? source<kDither>(row, r[u] - 1, p) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < lay.span) sig[i] = preemph != 0.f ? x[u] - preemph * xp[u] : x[u];
      }
    }
  } else if (stage) {
    if constexpr (kDither) {
      // 1d. x[t0-1 .. t0+span) converted and dithered (0 outside [0, length))
      //     into the xs row, then pre-emphasis and zeroing from there
      float* xs = smem + lay.xs;  // xs[i] = x[t0 - 1 + i]
      for (int i = threadIdx.x; i <= lay.span; i += kThreads) {
        const long long t = t0 - 1 + i;
        xs[i] = (t >= 0 && t < len) ? source<true>(row, t, p) : 0.f;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < lay.span; i += kThreads) {
        sig[i] = t0 + i < len ? xs[i + 1] - preemph * xs[i] : 0.f;
      }
    } else {
      // 1. stage the tile's span: convert, pre-emphasis, then zero t >= length
      for (int i0 = threadIdx.x; i0 < lay.span; i0 += kThreads * kStageBatch) {
        float x[kStageBatch], xp[kStageBatch];
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const long long t = t0 + i0 + u * kThreads;
          const bool in = i0 + u * kThreads < lay.span && t < len;
          x[u] = in ? source<false>(row, t, p) : 0.f;
          xp[u] = in && t > 0 ? source<false>(row, t - 1, p) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < lay.span) sig[i] = x[u] - preemph * xp[u];
        }
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Lk = min(L, p.n_fft);  // rfft(n=n_fft) truncates longer frames
  float* part = smem + lay.part + warp * lay.pstride;
  // step 4: the lane where the filter this lane's chunk starts inside began
  // (-1 when the chunk starts a filter, or lies past the table)
  int from = -1;
  if (kind != kSpectrogram && lane * p.chunk < p.nnz) {
    const int m = (meta[lane * p.chunk] >> 16) & 0x7FFF;
    if (moff[m] < lane * p.chunk) from = moff[m] / p.chunk;
  }
  auto energy_lane = [&](float es, float e_frame) -> float {
    if (kind == kSsc) return 0.f;
    if (kCond && p.energy_source != kPspec) return fmaxf(e_frame, p.eps);
    return es <= 0.f ? p.eps : es;
  };

  // 2. per frame, the conditioning over the frame's L samples under kCond:
  //    mean and raw energy of the centered frame (frame_stats); cond(a) is
  //    the conditioned sample g[a] (frame pre-emphasis folded in), sample(a)
  //    the windowed one
  auto frame_stats = [&](const float* fr, float& mu, float& e) {
    mu = 0.f;
    e = 0.f;
    if constexpr (kCond) {
      if (p.remove_dc) {
        float s = 0.f;
        for (int a = lane; a < L; a += 32) s += fr[a];
        mu = warp_sum(s) / static_cast<float>(L);
      }
      if (p.energy_source == kRawFrame) {
        for (int a = lane; a < L; a += 32) {
          const float d = fr[a] - mu;
          e += d * d;
        }
      }
    }
  };
  auto cond = [&](const float* fr, float mu, int a) -> float {
    if constexpr (kCond) {
      const float d = fr[a] - mu;
      return a == 0 ? d * p.frame_keep0 : d - p.frame_preemph * (fr[a - 1] - mu);
    } else {
      return fr[a];
    }
  };
  const bool wsum = kCond && p.energy_source == kWindowedFrame;

  if constexpr (kBf16) {
    // 2b. every frame of the tile (zeros past F) as bf16 hi and lo, the
    //     conditioned samples unwindowed (the matrix carries the window),
    //     zero past Lk; the frame energies into ef
    __nv_bfloat16* ahi = reinterpret_cast<__nv_bfloat16*>(smem + lay.buf);
    __nv_bfloat16* alo = ahi + kTile * p.kp;
    float* pw_tile = smem + lay.pw;
    float* ef = smem + lay.ef;
    for (int fl = warp; fl < kTile; fl += kWarps) {
      __nv_bfloat16* ah = ahi + fl * p.kp;
      __nv_bfloat16* al = alo + fl * p.kp;
      if (f0 + fl >= F) {
        for (int a = lane; a < p.kp; a += 32) ah[a] = al[a] = __float2bfloat16_rn(0.f);
        continue;  // warp-uniform
      }
      const float* fr = sig + fl * S;
      float mu, e;
      frame_stats(fr, mu, e);
#pragma unroll 1
      for (int a = lane; a < p.kp; a += 32) {
        const float g = a < Lk ? cond(fr, mu, a) : 0.f;
        if (wsum && a < Lk) {
          const float v = g * win[a];
          e += v * v;
        }
        const __nv_bfloat16 h = __float2bfloat16_rn(g);
        ah[a] = h;
        al[a] = __float2bfloat16_rn(g - __bfloat162float(h));
      }
      if (wsum) {
        for (int a = Lk + lane; a < L; a += 32) {
          const float v = cond(fr, mu, a) * win[a];
          e += v * v;
        }
      }
      if constexpr (kCond) {
        if (p.energy_source != kPspec) e = warp_sum(e);
      }
      if (lane == 0) ef[fl] = e;
    }
    __syncthreads();
    // 3c. the tile's DFT on the tensor cores into the power rows
    bf16x3_dft(ahi, alo, dft_hi, dft_lo, pw_tile, p, warp);
    __syncthreads();
    // 4. each frame's output row (the powers carry the matrix's scale)
    for (int fl = warp; fl < kTile; fl += kWarps) {
      const int f = f0 + fl;
      if (f >= F) break;  // warp-uniform
      const float* pw = pw_tile + fl * p.nbp;
      const float energy = energy_lane(power_sum(pw, p.bins, lane), ef[fl]);
      write_frame(out + (static_cast<size_t>(b) * F + f) * (M + 1), pw, energy, bd, part, from,
                  p, lane);
      __syncwarp();  // part is rewritten by the warp's next frame
    }
    return;
  }

  float* rows = smem + lay.buf + warp * lay.pstride;  // the warp's two rows
  float2* ra = reinterpret_cast<float2*>(rows);
  float2* rb = reinterpret_cast<float2*>(rows + lay.row);

  for (int fl = warp; fl < kTile; fl += kWarps) {
    const int f = f0 + fl;
    if (f >= F) break;  // warp-uniform
    float* pw;
    float es, e_frame = 0.f;
    if (framed && static_cast<long long>(f) * S >= len) {
      // 2z. a frame wholly past its row's length: zero samples, zero powers
      pw = rows;
      for (int k = lane; k < p.bins; k += 32) pw[k] = 0.f;
      es = 0.f;
    } else {
      const float* fr = sig + fl * S;
      // 2. under kCond the conditioning over the frame's L samples: mean,
      //    raw energy of the centered frame, then frame pre-emphasis folded
      //    into the DFT's loads, and the windowed energy of all L samples
      //    (those past n_fft too)
      float mu, e;
      frame_stats(fr, mu, e);
      auto sample = [&](int a) -> float { return cond(fr, mu, a) * win[a]; };
      if (p.form == kDirect) {
        // 3b. the first Lk windowed samples into row a, the powers into row b
        float* v = rows;
#pragma unroll 1
        for (int a = lane; a < Lk; a += 32) {
          const float x = sample(a);
          if (wsum) e += x * x;
          v[a] = x;
        }
        __syncwarp();
        pw = rows + lay.row;
        direct_dft(v, pw, tw, p, Lk, lane);
        __syncwarp();
        es = power_sum(pw, p.bins, lane);
      } else {
        // 3a. the Stockham FFT, stage 0 loading point n = (y[2n], y[2n+1])
        //     windowed (0 past Lk) from the staged frame; then the real
        //     split into the free row
        auto point = [&](int n) -> float2 {
          const int a = 2 * n;
          const float re = a < Lk ? sample(a) : 0.f;
          const float im = a + 1 < Lk ? sample(a + 1) : 0.f;
          if (wsum) e += re * re + im * im;
          return make_float2(re, im);
        };
        const float2* Z = stockham(point, ra, rb, p, tw + p.half / 2 + 1, sb, lane);
        pw = reinterpret_cast<float*>(Z == ra ? rb : ra);
        es = real_split(Z, pw, tw, p.half, p.pscale, lane);
      }
      if (wsum) {
        for (int a = Lk + lane; a < L; a += 32) {
          const float x = sample(a);
          e += x * x;
        }
      }
      if constexpr (kCond) {
        if (p.energy_source != kPspec) e_frame = warp_sum(e);
      }
    }
    __syncwarp();
    write_frame(out + (static_cast<size_t>(b) * F + f) * (M + 1), pw, energy_lane(es, e_frame),
                bd, part, from, p, lane);
    __syncwarp();  // the rows and partials are rewritten by the warp's next frame
  }
}

struct Args {
  const void* audio;
  const int* lengths;
  float* out;
  const float *window, *mel_w, *melf_w;
  const int *mel_off, *mel_meta;
  const float* twiddle;
  const int* bases;
  const void *dft_hi, *dft_lo;
  const float* taps;
  int B;
  Params p;
  Polyphase pp;
  cudaStream_t stream;
};

template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16>
size_t smem_of(const Params& p, const Polyphase& pp) {
  const Layout lay = kResample ? layout(p, resample_window(p, pp), pp.up * pp.K, true)
                               : layout(p, 0, 0, kDither);
  return static_cast<size_t>(lay.total) * sizeof(float);
}

// The launch of one instantiation.
struct Launch {
  const Args& a;
  template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16>
  cudaError_t run() const {
    const Params& p = a.p;
    const size_t bytes = smem_of<Sample, kResample, kDither, kCond, kBf16>(p, a.pp);
    auto kernel = logmel_kernel<Sample, kResample, kDither, kCond, kBf16>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.F + kTile - 1) / kTile, a.B);
    kernel<<<grid, kThreads, bytes, a.stream>>>(
        static_cast<const Sample*>(a.audio), a.lengths, a.out, a.window, a.mel_w, a.melf_w,
        a.mel_off, a.mel_meta, reinterpret_cast<const float2*>(a.twiddle), a.bases,
        static_cast<const __nv_bfloat16*>(a.dft_hi), static_cast<const __nv_bfloat16*>(a.dft_lo),
        a.taps, p, a.pp);
    return cudaGetLastError();
  }
};

// The card's view of one instantiation at `smem` bytes: registers and local
// (spilled) bytes a thread, and the blocks an SM holds.
struct Info {
  int smem;
  int* out;
  template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16>
  cudaError_t run() const {
    auto kernel = logmel_kernel<Sample, kResample, kDither, kCond, kBf16>;
    cudaFuncAttributes attr = {};
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, kThreads, smem);
    }
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    return err;
  }
};

// Picks the instantiation for the sample type and the dither and
// conditioning branches (the bf16x3 form: the plain form only).
template <bool kResample, bool kBf16, typename Fn>
cudaError_t dispatch(const Fn& fn, bool is_int16, bool dither, bool cond) {
  if (is_int16) {
    if (dither) {
      return cond ? fn.template run<int16_t, kResample, true, true, kBf16>()
                  : fn.template run<int16_t, kResample, true, false, kBf16>();
    }
    return cond ? fn.template run<int16_t, kResample, false, true, kBf16>()
                : fn.template run<int16_t, kResample, false, false, kBf16>();
  }
  if (dither) {
    return cond ? fn.template run<float, kResample, true, true, kBf16>()
                : fn.template run<float, kResample, true, false, kBf16>();
  }
  return cond ? fn.template run<float, kResample, false, true, kBf16>()
              : fn.template run<float, kResample, false, false, kBf16>();
}

// The DFT plan of p.n_fft for the wrapper's form (kernels/frontend.py
// kernel_form), as kernels/frontend.py radices and fft_twiddles lay it out:
// the Stockham form only where it applies (an even n_fft >= 4 whose half
// factors into 8s, one 4 or 2, 3s and 5s), the direct DFT and bf16x3 at any
// n_fft; the projection's chunk. False when the wrapper's form disagrees,
// or for n_fft < 2.
bool plan(Params& p) {
  const int N = p.n_fft;
  if (N < 2) return false;
  p.half = N / 2;
  p.bins = N / 2 + 1;
  p.nstages = 0;
  p.radices = 0;
  p.ntw = p.nbases = p.kp = p.nbp = 0;
  p.chunk = ((p.nnz + 31) / 32) | 1;
  if (p.form == kDirect) {
    p.ntw = N;
    return true;
  }
  if (p.form == kBf16x3) {
    p.kp = (imin(p.L, N) + 15) / 16 * 16;
    p.nbp = (p.bins + 15) / 16 * 16;
    return true;
  }
  if (p.form != kStockham || N % 2 != 0 || N < 4) return false;
  int h = p.half;
  p.ntw = p.half / 2 + 1;
  auto add = [&](int r) {
    const int hr = p.half / r;
    if (p.nstages > 0) p.ntw += hr * (r - 1);
    p.nbases += hr;
    p.radices |= static_cast<unsigned long long>(r) << (4 * p.nstages++);
    h /= r;
  };
  while (h % 8 == 0 && p.nstages < kMaxStages) add(8);
  if (h % 4 == 0) {
    add(4);
  } else if (h % 2 == 0) {
    add(2);
  }
  while (h % 3 == 0 && p.nstages < kMaxStages) add(3);
  while (h % 5 == 0 && p.nstages < kMaxStages) add(5);
  return h == 1;
}

bool bad_params(Params& p, int B, const float* melf_w, const int* bases) {
  return p.L < 1 || p.S < 1 || p.M < 1 || B < 1 || p.F < 1 || !plan(p) ||
         p.energy_source < kPspec || p.energy_source > kWindowedFrame ||
         p.log_kind < kLn || p.log_kind > kLog10Floor || p.feature_kind < kLogmel ||
         p.feature_kind > kSsc || (p.feature_kind == kSpectrogram && p.M != p.bins) ||
         (p.feature_kind != kSpectrogram && p.nnz < p.M) ||
         (p.feature_kind == kSsc && melf_w == nullptr) ||
         (p.form == kStockham && bases == nullptr) || p.center < kNoCenter ||
         p.center > kCenterReflect;
}

}  // namespace

extern "C" {

// Launches the front-end on `stream`; returns cudaGetLastError() (0 = launched).
// audio [B, T] int16 (audio_is_int16 != 0) or float32; lengths [B] int32;
// out [B, F, M+1] float32; window [L] float32; the packed mel bands
// (kernels/frontend.py mel_packed; none read for a spectrogram): mel_w
// [n_packed] float32, melf_w [n_packed] float32 (ssc; may be null
// otherwise), mel_off [M+1] and mel_meta [n_packed] int32 (bin | filter
// << 16, the sign bit on each filter's last weight), every filter owning
// at least one weight; twiddle [n, 2] float32 and bases int32 as
// kernels/frontend.py fft_twiddles and stage_bases lay them out for
// dft_form 0 (Stockham), twiddle [n_fft, 2] of e^{-2 pi i k / n_fft} for
// 1 (direct), neither for 2 (bf16x3; bases may be null but for 0);
// dft_hi / dft_lo [kp, 2 nbp] bf16 (dft_form 2 only, else null): the
// window-folded, scaled DFT's hi and lo parts, rows past min(L, n_fft) and
// bins past n_fft/2 zero, column block 2j the cosines and 2j + 1 the sines
// of bins [16j, 16j + 16) (pscale is then unused: the matrix carries it).
// frame_offset is frame 0's first sample and center 0 none / 1 "center" /
// 2 "center_reflect". dither > 0 adds the contract noise (dither_seed =
// fmix32(cfg.dither_seed)); conditioning != 0 takes the frame-first branch
// (remove_dc, frame_preemph and frame_keep0 = 1 - frame_preemph,
// energy_source 0 pspec / 1 raw_frame / 2 windowed_frame); log_kind 0 ln /
// 1 ln_stab / 2 db / 3 ln_floor / 4 log10_floor; feature_kind 0 logmel /
// 1 plp / 2 spectrogram (M = n_fft/2+1) / 3 ssc.
int mfcc_frontend_logmel(const void* audio, int audio_is_int16, const int* lengths,
                         float* out, const float* window, const float* mel_w,
                         const float* melf_w, const int* mel_off, const int* mel_meta,
                         const float* twiddle, const int* bases, const void* dft_hi,
                         const void* dft_lo, int B, int T, int F, int L, int S, int M,
                         int n_packed, int n_fft, int dft_form, int frame_offset, int center,
                         float scale, float preemph, float eps, float pscale, float dither,
                         unsigned dither_seed, int conditioning, int remove_dc,
                         float frame_preemph, float frame_keep0, int energy_source,
                         int log_kind, int feature_kind, void* stream) {
  Params p{T, F, L, S, M, n_packed, n_fft, dft_form, frame_offset, center, scale, preemph, eps,
           pscale, dither, dither_seed, remove_dc, energy_source, log_kind, frame_preemph,
           frame_keep0, feature_kind};
  if (bad_params(p, B, melf_w, bases)) return cudaErrorInvalidValue;
  const bool tensor = dft_form == kBf16x3;
  if (tensor && (dft_hi == nullptr || dft_lo == nullptr)) return cudaErrorInvalidValue;
  const Args a{audio, lengths, out, window, mel_w, melf_w, mel_off, mel_meta, twiddle, bases,
               dft_hi, dft_lo, nullptr, B, p, Polyphase{1, 1, 0, 0},
               static_cast<cudaStream_t>(stream)};
  const Launch fn{a};
  const bool i16 = audio_is_int16 != 0, dth = dither > 0.f, cnd = conditioning != 0;
  return tensor ? dispatch<false, true>(fn, i16, dth, cnd) : dispatch<false, false>(fn, i16, dth, cnd);
}

// The same with the fused resample: audio [B, T] and lengths [B] at sr_in;
// taps [up, K] float32 (input_scale folded in); F frames of the resampled
// signal, ceil(T * up / down) samples long. Dither keys on 16 kHz positions.
// No centered framing and no bf16x3 form.
int mfcc_frontend_logmel_resample(const void* audio, int audio_is_int16,
                                  const int* lengths, float* out, const float* window,
                                  const float* mel_w, const float* melf_w, const int* mel_off,
                                  const int* mel_meta, const float* twiddle, const int* bases,
                                  const float* taps, int B, int T, int F, int L, int S, int M,
                                  int n_packed, int n_fft, int dft_form, int up, int down,
                                  int half_len, int K, float preemph, float eps, float pscale,
                                  float dither, unsigned dither_seed, int conditioning,
                                  int remove_dc, float frame_preemph, float frame_keep0,
                                  int energy_source, int log_kind, int feature_kind,
                                  void* stream) {
  Params p{T, F, L, S, M, n_packed, n_fft, dft_form, 0, kNoCenter, 1.f, preemph, eps, pscale,
           dither, dither_seed, remove_dc, energy_source, log_kind, frame_preemph, frame_keep0,
           feature_kind};
  if (bad_params(p, B, melf_w, bases) || dft_form == kBf16x3 || up < 1 || down < 1 || K < 1 ||
      half_len < 10 * down) {
    return cudaErrorInvalidValue;
  }
  const Args a{audio, lengths, out, window, mel_w, melf_w, mel_off, mel_meta, twiddle, bases,
               nullptr, nullptr, taps, B, p, Polyphase{up, down, half_len, K},
               static_cast<cudaStream_t>(stream)};
  return dispatch<true, false>(Launch{a}, audio_is_int16 != 0, dither > 0.f, conditioning != 0);
}

// Registers, local (spilled) bytes a thread and blocks an SM of the
// instantiation for (int16 rows, fused resample, dither, conditioning,
// bf16x3) at smem_bytes of dynamic shared memory, into out[0..3).
int mfcc_frontend_kernel_info(int audio_is_int16, int resample, int dither, int conditioning,
                              int bf16x3, int smem_bytes, int* out) {
  const Info fn{smem_bytes, out};
  const bool i16 = audio_is_int16 != 0, dth = dither != 0, cnd = conditioning != 0;
  if (bf16x3) return resample ? cudaErrorInvalidValue : dispatch<false, true>(fn, i16, dth, cnd);
  return resample ? dispatch<true, false>(fn, i16, dth, cnd) : dispatch<false, false>(fn, i16, dth, cnd);
}

const char* mfcc_frontend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
