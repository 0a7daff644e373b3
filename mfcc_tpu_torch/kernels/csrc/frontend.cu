// Fused MFCC front-end for Hopper (sm_90a): audio rows -> [log-mel | energy].
//
// Replaces mfcc_tpu/kernels/frontend.py::_make_radix4_kernel (:905), slab
// mode, launched from _fused_logmel_energy (:1295) through pl.pallas_call
// (:1552), with its dither, frame-first conditioning, ln / ln_stab / db /
// ln_floor epilogue branches and its PLP, spectrogram and SSC feature
// kinds. Plain version and wrapper:
// mfcc_tpu_torch/kernels/frontend.py (logmel_prefix_reference,
// logmel_prefix).
//
// Per utterance b and frame f < F (default branches):
//   x[t]   = float(audio[b, t]) * scale              (int16 or float32 rows)
//   y[t]   = x[t] - c * x[t-1], x[-1] = 0; then y[t] = 0 for t >= lengths[b]
//   X[k]   = rfft(y[f*S : f*S+L] * window, n=512)    (zero past T and past L)
//   P[k]   = |X[k]|^2 * pscale                       (k < 257)
//   out[b, f, m] = ln(where(mel_m <= 0, eps, mel_m)), mel_m = sum_k P[k] mel[k, m]
//   out[b, f, M] = where(E <= 0, eps, E),             E = sum_k P[k] (unlogged)
// The dither, conditioning and log-kind branches are described below.
//
// Bound at the main path (classic13_deltas, batch 64 x 10 s, int16 rows,
// T = 160,080, F = 999, M = 26; H100 SXM peaks):
//   bytes: 20.49 MB int16 in + 6.90 MB out = 27.4 MB -> 8.2 us at 3.35 TB/s.
//   operations, the function's minimum (not this kernel's form): 0.4 k window
//     + 6.66 k for a split-radix 256-point complex FFT (4N log2 N - 6N + 8)
//     + 1.78 k real split (its 1/2 scalings fold into pscale) + 0.77 k |X|^2
//     + 0.92 k mel (the 459 nonzero weights) + 0.26 k energy + 53 clamp/ln
//     = 10,839 FLOP per frame x 56,836 frames that hold samples, plus 2 per
//     sample of pre-emphasis = 0.634 GFLOP -> 9.47 us at 67 TFLOP/s fp32.
//     The operations set the bound; chip_smoke.py computes it from each
//     run's inputs. This kernel's radix-2 form does ~14.8 k per frame.
//   A dense [257, 27] projection would add ~13 kFLOP per frame, and a direct
//   DFT ~400 kFLOP per frame (~0.39 ms at this batch).
//
// Design. One block per (utterance, tile of 32 frames), 8 warps:
//   1. The tile's sample span, 31*160+400 = 5,360 samples, is staged once in
//      shared memory as fp32 after convert, pre-emphasis and zeroing. Each
//      input byte is read about once (the 240-sample overlap between tiles
//      and the x[t-1] re-read are served by L1/L2); pre-emphasis reads the
//      previous tile's last sample from global memory, so only t = 0 sees
//      x[-1] = 0. Zeroing follows pre-emphasis, so y[length] = 0, and it
//      does not rely on the padding being zero.
//   2. Each warp takes one frame at a time: the windowed frame is packed as
//      256 complex points (even samples real, odd imaginary) in bit-reversed
//      order, and an in-place radix-2 FFT runs in shared memory with
//      __syncwarp between stages. Twiddles come from a host table computed
//      in float64 (no in-kernel sincosf). Every sum is fp32 FMA: no TF32,
//      no bf16 (1-pass reduced precision breaks the 1e-4 log-mel gate,
//      docs/KERNEL.md section 3).
//   3. The real split gives X[k] and X[256-k] from Z[k] and Z[256-k]; |X|^2
//      goes to a per-warp shared row of 257 powers.
//   4. Lane m sums filter m over its nonzero band [mel_lo[m], mel_hi[m])
//      (exact: the skipped weights are zero), takes the clamp and ln; the
//      energy (the all-ones column of the TPU kernel) is a warp sum of all
//      257 powers. Nothing but the [F, M+1] prefix reaches device memory.
// It is far from the bound: the shared-memory radix-2 FFT is latency-bound
// (one frame per warp, a __syncwarp per stage). Register-resident radix-8/16
// FFTs with several frames per warp are the next step.
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
// never reaches device memory. Shared memory at 44.1 kHz (up = 160,
// K = 56): 14,830-sample window + 35.8 KB table + the 21.5 KB x row on top
// of the 55.5 KB above = 172 KB, one block per SM.
// Bound at mfcc39_48k (batch 64 x 10 s int16, lengths 480,000 - 1,713*i):
//   bytes: 54.5 MB int16 in + 6.9 MB out -> ~18 us;
//   operations: 91 FLOP per output sample that holds signal (61 symmetric
//   taps folded) x ~9.1 M = 0.83 GFLOP, plus the front-end's 0.63 GFLOP
//   -> ~22 us: operations bound it (chip_smoke.py computes it per run).
//
// Dither (kDither; replaces _gather_frames' slab dither, frontend.py
// :537-546, and the hash of mfcc_tpu/ops/dither.py::dither_field :113-136).
// Every staged sample 0 <= t < length (at 16 kHz: output positions in the
// fused form, masked at the output length) becomes
//   x[t] + sigma * noise(t),  noise(t) = BoxMuller16(fmix32(fmix32(
//       (t / S) * GOLDEN ^ seed') + t % S)),  seed' = fmix32(seed) (host)
// before pre-emphasis (mfcc_tpu_torch/ops/dither.py states the contract).
// The hash is native uint32; the uniforms (k + 0.5) * 2^-16 and the cos
// polynomial use __fmul_rn / __fadd_rn, so nvcc contracts none of them into
// an FMA and they stay bit-equal to the numpy contract; only logf and sqrtf
// may differ by ulps. The plain form stages x[t0-1 .. t0+span) once,
// dithered, in a shared row (as the fused form's resampled row), and
// pre-emphasizes from there, so the hash runs once per staged sample.
// Cost per sample that holds signal: 30 float operations (uniforms 4, ln,
// -2x, sqrt, cos 20, r cos, sigma n, the add) and 25 integer ones (two
// fmix32, the row key, t / S and t % S, the 16-bit halves and their
// conversions).
//
// Frame-first conditioning (kCond; replaces _make_conditioning :620-655,
// _win_energy_np :244-251, and the staging without pre-emphasis of
// _gather_preemph :1643-1651): the staged signal is x zeroed at t >= length
// (the host passes preemph = 0 in "frame" mode), and per frame, in the
// warp that transforms it, over the frame's L <= 512 samples f[n]:
//   mu   = sum f / L (remove_dc; else 0), a warp sum;
//   E    = sum (f - mu)^2 (raw_frame; a second pass over shared memory,
//          not sum f^2 - L mu^2, which cancels);
//   g[0] = (f0 - mu)(1 - c), g[n] = (fn - mu) - c (fn-1 - mu) (c = 0
//          outside "frame" mode), folded into the pack loop, which reads
//          fr[a] and fr[a-1] from the staged row (no extra shared memory);
//   E    = sum (w g)^2 (windowed_frame), from the packed values;
// and lane M holds max(E, eps) for the two frame energies.
//
// Epilogue log kinds (_make_epilogue :693-702), a warp-uniform switch:
//   ln: ln(where(m <= 0, eps, m)); ln_stab: ln(m + 1e-6);
//   db: 10 log10(where(m <= 0, eps, m)); ln_floor: ln(max(m, eps)).
// logmel80 (M = 80): the [257][80] mel matrix takes 82 KB of shared memory,
// 132 KB in all, so one block fits an SM.
//
// Bound of the new branches at kaldi_mfcc b64 x 10 s (F = 998, M = 23):
// conditioning adds 6L - 1 = 2,399 operations per frame (mean, centering,
// raw energy, frame pre-emphasis), 0.74 GFLOP in all -> 11.0 us; dither 55
// operations per sample that holds signal (the integer ones counted at the
// fp32 rate), +0.50 G -> 18.5 us. Both stay bound by operations; logmel80 at
// b256 is bound by its 83 MB of output (38 us). chip_smoke.py computes every
// bound from its run's inputs. The kernel stays latency-bound as above: on
// an H100 SXM at 700 W the dither adds ~18 % to kaldi_mfcc's kernel time
// and the conditioning ~2 %.
//
// Feature kinds (feature_kind, a warp-uniform switch in step 4 of both
// forms; _make_epilogue :660-712):
//   logmel (mfcc and logmel configs): the log kind of the band sum, above.
//   plp (the PLP branch, :682-692): o[m] = the band sum, unlogged; lane M
//     the energy. ops/chain.py plp_base does the rest in tensor code.
//   spectrogram (the multi-tile output, :308-311): the identity projection,
//     o[m] = log kind of P[m] for m < M = 257, lane M the energy. No matrix
//     is staged (257 x 257 floats are 264 KB, over the 227 KB a block may
//     have; 50 KB in all at kaldi_spectrogram), and the lane loop covers the
//     258 output lanes in 9 warp passes.
//   ssc (:965-975 and epilogue_ssc :673-677): per bin q[k] = P[k] <= 0 ?
//     eps : P[k], then o[m] = sum q[k] melf[k, m] / sum q[k] mel[k, m] over
//     the band (IEEE division), with melf[k, m] = f_k mel[k, m] rounded once
//     from float64 on the host; o[M] = 0. P is indexed by bin here, so the
//     TPU kernel's per-lane clamp of eps / lanes_per_bin (a workaround for
//     its scrambled radix-4 lane order) is not needed. Both [257, M]
//     matrices are staged: 53 KB at M = 26, 104 KB in all.
// Bounds at b64 x 10 s int16 (chip_smoke.py computes them per run):
// kaldi_spectrogram is bound by bytes (20.5 MB in + 65.9 MB of
// [64, 998, 258] out: ~26 us); kaldi_plp (~11 us, kaldi_mfcc's operations
// less the logs) and ssc26 (~10 us: the clamps, two sums per weight and the
// divisions instead of the logs and the energy) by operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "polyphase.cuh"

namespace {

constexpr int kNfft = 512;
constexpr int kHalf = kNfft / 2;      // complex FFT size
constexpr int kLog2Half = 8;
constexpr int kBins = kNfft / 2 + 1;  // 257
constexpr int kTile = 32;             // frames per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPowStride = 260;       // per-warp power row, padded to 16 B

// energy_source and log_kind codes (kernels/frontend.py ENERGY_SOURCES, LOG_KINDS)
enum { kPspec = 0, kRawFrame = 1, kWindowedFrame = 2 };
enum { kLn = 0, kLnStab = 1, kDb = 2, kLnFloor = 3 };
// feature_kind codes (kernels/frontend.py FEATURE_KINDS)
enum { kLogmel = 0, kPlp = 1, kSpectrogram = 2, kSsc = 3 };

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// Staged [257, M] matrices, in floats: mel (none for the spectrogram's
// identity), then melf for ssc.
__host__ __device__ inline int mel_floats(int feature_kind, int M) {
  const int one = align4(kBins * M);
  return feature_kind == kSpectrogram ? 0 : feature_kind == kSsc ? 2 * one : one;
}

// Dynamic shared memory layout, in floats (every offset 16-byte aligned).
// in_len and taps are the fused resample's input window and tap table (0
// without it); the signal row at offset 0 holds the input window first. xs
// is the staged x[t0-1 .. t0+span) row of the fused resample and of dither.
// kernels/frontend.py smem_bytes mirrors it.
struct Layout {
  int span, win, mel, tw, buf, pw, xs, tab, total;
};

__host__ __device__ inline Layout layout(int S, int L, int mels, int in_len, int taps,
                                         bool xs) {
  Layout l;
  l.span = (kTile - 1) * S + L;
  l.win = align4(l.span > in_len ? l.span : in_len);
  l.mel = l.win + kNfft;
  l.tw = l.mel + mels;
  l.buf = l.tw + 2 * kHalf;
  l.pw = l.buf + 2 * kHalf * kWarps;
  l.xs = l.pw + kPowStride * kWarps;
  l.tab = l.xs + (xs ? align4(l.span + 1) : 0);
  l.total = l.tab + align4(taps);
  return l;
}

__host__ __device__ inline int resample_window(int S, int L, const Polyphase& pp) {
  return pp_input_span((kTile - 1) * S + L + 1, pp);  // x[t0-1 .. t0+span)
}

// Per-config scalars of one launch.
struct Params {
  int T, F, L, S, M;
  float scale, preemph, eps, pscale;
  // dither (kDither): sigma and the host-premixed seed fmix32(seed)
  float dither;
  uint32_t seed;
  // conditioning (kCond); frame_keep0 = 1 - frame_preemph, rounded on the host
  int remove_dc, energy_source, log_kind;
  float frame_preemph, frame_keep0;
  int feature_kind;
};

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

__device__ inline float log_lane(float m, const Params& p) {
  switch (p.log_kind) {
    case kLnStab: return logf(m + 1e-6f);
    case kDb: return 10.f * log10f(m <= 0.f ? p.eps : m);
    case kLnFloor: return logf(fmaxf(m, p.eps));
    default: return logf(m <= 0.f ? p.eps : m);
  }
}

template <typename Sample, bool kResample, bool kDither, bool kCond>
__global__ void __launch_bounds__(kThreads)
logmel_kernel(const Sample* __restrict__ audio, const int* __restrict__ lengths,
              float* __restrict__ out, const float* __restrict__ window,
              const float* __restrict__ mel, const float* __restrict__ melf,
              const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
              const float2* __restrict__ twiddle, const float* __restrict__ taps, Params p,
              Polyphase pp) {
  extern __shared__ __align__(16) float smem[];
  const int T = p.T, F = p.F, L = p.L, S = p.S, M = p.M;
  const int kind = p.feature_kind;
  const float preemph = p.preemph;
  const int mels = mel_floats(kind, M);
  const Layout lay = kResample ? layout(S, L, mels, resample_window(S, L, pp), pp.up * pp.K, true)
                               : layout(S, L, mels, 0, 0, kDither);
  float* sig = smem;
  float* win = smem + lay.win;
  float* melw = smem + lay.mel;
  float* melfw = melw + align4(kBins * M);  // ssc only
  float2* tw = reinterpret_cast<float2*>(smem + lay.tw);

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTile;
  const long long t0 = static_cast<long long>(f0) * S;
  const Sample* row = audio + static_cast<size_t>(b) * T;

  for (int i = threadIdx.x; i < kNfft; i += kThreads) win[i] = i < L ? window[i] : 0.f;
  if (kind != kSpectrogram) {
    for (int i = threadIdx.x; i < kBins * M; i += kThreads) melw[i] = mel[i];
  }
  if (kind == kSsc) {
    for (int i = threadIdx.x; i < kBins * M; i += kThreads) melfw[i] = melf[i];
  }
  for (int i = threadIdx.x; i < kHalf; i += kThreads) tw[i] = twiddle[i];

  if constexpr (kResample) {
    // 1r. the input window and the taps; x[t0-1 .. t0+span) by the FIR
    //     (x[-1] = 0, and 0 past the output length), dithered at output
    //     positions under kDither; then pre-emphasis and zeroing into the
    //     signal row, over the input window
    const int len_in = max(0, min(lengths[b], T));
    const long long len = pp_output_length(len_in, pp);
    const long long lo = pp_first_input(t0 - 1, pp);
    const int in_len = resample_window(S, L, pp);
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
  } else if constexpr (kDither) {
    // 1d. x[t0-1 .. t0+span) converted and dithered (0 outside [0, length))
    //     into the xs row, then pre-emphasis and zeroing from there
    const int len = min(lengths[b], T);
    float* xs = smem + lay.xs;  // xs[i] = x[t0 - 1 + i]
    for (int i = threadIdx.x; i <= lay.span; i += kThreads) {
      const long long t = t0 - 1 + i;
      xs[i] = (t >= 0 && t < len)
                  ? dithered(to_f32(row[t]) * p.scale, static_cast<uint32_t>(t), p)
                  : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < lay.span; i += kThreads) {
      sig[i] = t0 + i < len ? xs[i + 1] - preemph * xs[i] : 0.f;
    }
  } else {
    // 1. stage the tile's span: convert, pre-emphasis, then zero t >= length
    const int len = min(lengths[b], T);
    for (int i = threadIdx.x; i < lay.span; i += kThreads) {
      const long long t = t0 + i;
      float y = 0.f;
      if (t < len) {
        const float x = to_f32(row[t]) * p.scale;
        const float xp = t > 0 ? to_f32(row[t - 1]) * p.scale : 0.f;
        y = x - preemph * xp;
      }
      sig[i] = y;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float2* z = reinterpret_cast<float2*>(smem + lay.buf) + warp * kHalf;
  float* pw = smem + lay.pw + warp * kPowStride;

  for (int fl = warp; fl < kTile; fl += kWarps) {
    const int f = f0 + fl;
    if (f >= F) break;  // warp-uniform
    const float* fr = sig + fl * S;

    // 2. windowed frame as 256 complex points, bit-reversed for the DIT FFT
    float e_frame = 0.f;  // kCond: the raw or windowed frame energy
    if constexpr (kCond) {
      // 2c. conditioning over the frame's L samples: mean, raw energy of
      //     the centered frame, then frame pre-emphasis folded into the
      //     pack, and the windowed energy of what is packed
      float mu = 0.f;
      if (p.remove_dc) {
        float s = 0.f;
        for (int a = lane; a < L; a += 32) s += fr[a];
        mu = warp_sum(s) / static_cast<float>(L);
      }
      float e = 0.f;
      if (p.energy_source == kRawFrame) {
        for (int a = lane; a < L; a += 32) {
          const float d = fr[a] - mu;
          e += d * d;
        }
      }
      const float c = p.frame_preemph;
      for (int n = lane; n < kHalf; n += 32) {
        const int a = 2 * n;
        float g0 = 0.f, g1 = 0.f;
        if (a < L) {
          const float d = fr[a] - mu;
          g0 = a == 0 ? d * p.frame_keep0 : d - c * (fr[a - 1] - mu);
          if (a + 1 < L) g1 = (fr[a + 1] - mu) - c * d;
        }
        const float re = g0 * win[a], im = g1 * win[a + 1];
        if (p.energy_source == kWindowedFrame) e += re * re + im * im;
        z[__brev(n) >> (32 - kLog2Half)] = make_float2(re, im);
      }
      if (p.energy_source != kPspec) e_frame = warp_sum(e);
    } else {
      for (int n = lane; n < kHalf; n += 32) {
        const int a = 2 * n;
        const float re = a < L ? fr[a] * win[a] : 0.f;
        const float im = a + 1 < L ? fr[a + 1] * win[a + 1] : 0.f;
        z[__brev(n) >> (32 - kLog2Half)] = make_float2(re, im);
      }
    }
    __syncwarp();
    for (int lg = 0; lg < kLog2Half; ++lg) {
      const int half = 1 << lg;
      for (int j = lane; j < kHalf / 2; j += 32) {
        const int pos = j & (half - 1);
        const int i0 = ((j >> lg) << (lg + 1)) + pos;
        const int i1 = i0 + half;
        // e^{-2 pi i pos / (2 half)} = table entry pos * 512 / (2 half)
        const float2 w = tw[pos << (kLog2Half - lg)];
        const float2 u = z[i0];
        const float2 v = z[i1];
        const float vr = v.x * w.x - v.y * w.y;
        const float vi = v.x * w.y + v.y * w.x;
        z[i0] = make_float2(u.x + vr, u.y + vi);
        z[i1] = make_float2(u.x - vr, u.y - vi);
      }
      __syncwarp();
    }

    // 3. real split: Xe = (Z[k] + conj Z[256-k]) / 2, Xo = (Z[k] - conj Z[256-k]) / 2i,
    //    X[k] = Xe + W^k Xo and X[256-k] = conj(Xe - W^k Xo), W = e^{-2 pi i / 512}
    for (int k = lane; k <= kHalf / 2; k += 32) {
      const float2 a = z[k];
      const float2 c = z[(kHalf - k) & (kHalf - 1)];
      const float er = 0.5f * (a.x + c.x);
      const float ei = 0.5f * (a.y - c.y);
      const float orr = 0.5f * (a.y + c.y);
      const float oi = -0.5f * (a.x - c.x);
      const float2 w = tw[k];
      const float wr = orr * w.x - oi * w.y;
      const float wi = orr * w.y + oi * w.x;
      const float xr = er + wr, xi = ei + wi;
      pw[k] = (xr * xr + xi * xi) * p.pscale;
      if (k != kHalf / 2) {
        const float yr = er - wr, yi = ei - wi;
        pw[kHalf - k] = (yr * yr + yi * yi) * p.pscale;
      }
    }
    __syncwarp();

    // 4. per output lane, by feature kind: the mel projection over each
    //    filter's nonzero band, then the log kind (logmel) or nothing
    //    (plp); the log kind of power bin m (spectrogram); the centroid of
    //    the clamped powers (ssc). Then the energy lane (0 for ssc).
    float* o = out + (static_cast<size_t>(b) * F + f) * (M + 1);
    for (int m = lane; m < M; m += 32) {
      if (kind == kSpectrogram) {
        o[m] = log_lane(pw[m], p);
        continue;
      }
      const int hi = mel_hi[m];
      if (kind == kSsc) {
        float num = 0.f, den = 0.f;
        for (int k = mel_lo[m]; k < hi; ++k) {
          const float q = pw[k] <= 0.f ? p.eps : pw[k];
          num += q * melfw[k * M + m];
          den += q * melw[k * M + m];
        }
        o[m] = __fdiv_rn(num, den);
        continue;
      }
      float acc = 0.f;
      for (int k = mel_lo[m]; k < hi; ++k) acc += pw[k] * melw[k * M + m];
      o[m] = kind == kPlp ? acc : log_lane(acc, p);
    }
    if (kind == kSsc) {
      if (lane == 0) o[M] = 0.f;
    } else if (kCond && p.energy_source != kPspec) {
      if (lane == 0) o[M] = fmaxf(e_frame, p.eps);
    } else {
      float e = 0.f;
      for (int k = lane; k < kBins; k += 32) e += pw[k];
      e = warp_sum(e);
      if (lane == 0) o[M] = e <= 0.f ? p.eps : e;
    }
    __syncwarp();  // z and pw are rewritten by the warp's next frame
  }
}

struct Args {
  const void* audio;
  const int* lengths;
  float* out;
  const float *window, *mel, *melf;
  const int *mel_lo, *mel_hi;
  const float *twiddle, *taps;
  int B;
  Params p;
  Polyphase pp;
  cudaStream_t stream;
};

template <typename Sample, bool kResample, bool kDither, bool kCond>
cudaError_t launch(const Args& a) {
  const Params& p = a.p;
  const int mels = mel_floats(p.feature_kind, p.M);
  const Layout lay =
      kResample ? layout(p.S, p.L, mels, resample_window(p.S, p.L, a.pp), a.pp.up * a.pp.K, true)
                : layout(p.S, p.L, mels, 0, 0, kDither);
  const size_t bytes = static_cast<size_t>(lay.total) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel<Sample, kResample, kDither, kCond>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.F + kTile - 1) / kTile, a.B);
  logmel_kernel<Sample, kResample, kDither, kCond><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const Sample*>(a.audio), a.lengths, a.out, a.window, a.mel, a.melf,
      a.mel_lo, a.mel_hi, reinterpret_cast<const float2*>(a.twiddle), a.taps, p, a.pp);
  return cudaGetLastError();
}

// Picks the instantiation for the sample type and the dither and
// conditioning branches.
template <bool kResample>
cudaError_t dispatch(const Args& a, bool is_int16, bool dither, bool cond) {
  if (is_int16) {
    if (dither) {
      return cond ? launch<int16_t, kResample, true, true>(a)
                  : launch<int16_t, kResample, true, false>(a);
    }
    return cond ? launch<int16_t, kResample, false, true>(a)
                : launch<int16_t, kResample, false, false>(a);
  }
  if (dither) {
    return cond ? launch<float, kResample, true, true>(a)
                : launch<float, kResample, true, false>(a);
  }
  return cond ? launch<float, kResample, false, true>(a)
              : launch<float, kResample, false, false>(a);
}

bool bad_params(const Params& p, int B, const float* melf) {
  return p.L < 1 || p.L > kNfft || p.S < 1 || p.M < 1 || B < 1 || p.F < 1 ||
         p.energy_source < kPspec || p.energy_source > kWindowedFrame ||
         p.log_kind < kLn || p.log_kind > kLnFloor || p.feature_kind < kLogmel ||
         p.feature_kind > kSsc || (p.feature_kind == kSpectrogram && p.M != kBins) ||
         (p.feature_kind == kSsc && melf == nullptr);
}

}  // namespace

extern "C" {

// Launches the front-end on `stream`; returns cudaGetLastError() (0 = launched).
// audio [B, T] int16 (audio_is_int16 != 0) or float32; lengths [B] int32;
// out [B, F, M+1] float32; window [>= L] float32; mel [257, M] float32;
// melf [257, M] float32 (ssc; may be null otherwise); mel_lo / mel_hi [M]
// int32; twiddle [256, 2] float32. L <= 512.
// dither > 0 adds the contract noise (dither_seed = fmix32(cfg.dither_seed));
// conditioning != 0 takes the frame-first branch (remove_dc, frame_preemph
// and frame_keep0 = 1 - frame_preemph, energy_source 0 pspec / 1 raw_frame /
// 2 windowed_frame); log_kind 0 ln / 1 ln_stab / 2 db / 3 ln_floor;
// feature_kind 0 logmel / 1 plp / 2 spectrogram (M = 257) / 3 ssc.
int mfcc_frontend_logmel(const void* audio, int audio_is_int16, const int* lengths,
                         float* out, const float* window, const float* mel,
                         const float* melf, const int* mel_lo, const int* mel_hi,
                         const float* twiddle, int B, int T, int F, int L, int S, int M,
                         float scale, float preemph, float eps, float pscale, float dither,
                         unsigned dither_seed, int conditioning, int remove_dc,
                         float frame_preemph, float frame_keep0, int energy_source,
                         int log_kind, int feature_kind, void* stream) {
  const Params p{T, F, L, S, M, scale, preemph, eps, pscale, dither, dither_seed,
                 remove_dc, energy_source, log_kind, frame_preemph, frame_keep0,
                 feature_kind};
  if (bad_params(p, B, melf)) return cudaErrorInvalidValue;
  const Args a{audio, lengths, out, window, mel, melf, mel_lo, mel_hi, twiddle, nullptr, B,
               p, Polyphase{1, 1, 0, 0}, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, audio_is_int16 != 0, dither > 0.f, conditioning != 0);
}

// The same with the fused resample: audio [B, T] and lengths [B] at sr_in;
// taps [up, K] float32 (input_scale folded in); F frames of the resampled
// signal, ceil(T * up / down) samples long. Dither keys on 16 kHz positions.
int mfcc_frontend_logmel_resample(const void* audio, int audio_is_int16,
                                  const int* lengths, float* out, const float* window,
                                  const float* mel, const float* melf, const int* mel_lo,
                                  const int* mel_hi, const float* twiddle,
                                  const float* taps, int B, int T, int F, int L,
                                  int S, int M, int up, int down, int half_len, int K,
                                  float preemph, float eps, float pscale, float dither,
                                  unsigned dither_seed, int conditioning, int remove_dc,
                                  float frame_preemph, float frame_keep0,
                                  int energy_source, int log_kind, int feature_kind,
                                  void* stream) {
  const Params p{T, F, L, S, M, 1.f, preemph, eps, pscale, dither, dither_seed,
                 remove_dc, energy_source, log_kind, frame_preemph, frame_keep0,
                 feature_kind};
  if (bad_params(p, B, melf) || up < 1 || down < 1 || K < 1 || half_len < 10 * down) {
    return cudaErrorInvalidValue;
  }
  const Args a{audio, lengths, out, window, mel, melf, mel_lo, mel_hi, twiddle, taps, B, p,
               Polyphase{up, down, half_len, K}, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, audio_is_int16 != 0, dither > 0.f, conditioning != 0);
}

const char* mfcc_frontend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
