// Polyphase FIR shared by the port's resampling kernels (resample.cu, and
// the fused resample of frontend.cu): scipy resample_poly's algebra
// (mfcc_tpu_torch/ops/resample.py, the reference's _stream_design) with
// the filter's n_pre_pad leading zeros dropped. Output j is
//
//   a = j*down + half_len,  p = a mod up,  q = a div up
//   y[j] = sum_{i<K} h[p][i] * x[q - i]
//
// where h [up][K] holds the filter phase by phase (polyphase_design, zeros
// past its end) and x[u] = 0 outside the signal. Input indices are int64:
// at 44.1 kHz (up = 160, down = 441) j*down passes 2^31 after ~4.9 M output
// samples.
//
// The staged tap table (kernels/resample.py device_table) holds h with a
// row stride of pp_stride taps, zeros past K:
//   up = 1: K rounded up to a multiple of down * kPpR1 (63 at 48 kHz, K =
//           61), so every residue class c of the taps i = c + down*k has
//           the same length, a multiple of kPpR1;
//   up > 1: K rounded up to odd (57 at 44.1 kHz, K = 56), so the rows of
//           the 32 phases a warp reads at once start in 32 distinct banks.
//
// The FIR is register-blocked, fp32 FMA, one of two ways:
//   up = 1: a thread takes kPpR1 consecutive outputs j + r. For each class
//     c, output r reads z[r - k] = x[q_j - c + down*(r - k)] with tap
//     h[c + down*k]: a 1-D convolution over k whose kPpR1 samples slide
//     in registers (one new sample and one tap per step, kPpR1 FMAs), so
//     loads per FMA are (2*stride + down*(kPpR1 - 1)) / (kPpR1*stride):
//     0.33 at 48 kHz, against 2 for one output a thread. Every lane reads
//     the same tap (a broadcast); lanes' samples lie kPpR1*down = 21 apart,
//     in distinct banks for float samples and odd down (int16 samples pair
//     up in words: at most 2-way). The sum runs class by class.
//   up > 1: a thread takes kPpRU outputs up apart, j + up*r: one phase, so
//     each tap is loaded once for kPpRU outputs, and samples down apart.
//     Consecutive lanes take consecutive j (consecutive columns s of the
//     [row][column] grid i = s + up*row), hence phases 121 apart at 44.1
//     kHz, rows 57*121 = 17 banks apart: no conflict. The sum runs i = 0 ..
//     K-1, as before.
// The kPpR1 (or kPpRU) independent accumulators break the K-deep chain of
// dependent FMAs.
//
// A kernel stages a window of x, starting at input index `lo`, in shared
// memory: n outputs from j0 read inputs [pp_first_input(j0),
// pp_first_input(j0) + pp_window(n)), laid out from the 16-byte boundary at
// or below the window's flat index (pp_stage_floats). The window may hold
// int16 samples (int16 rows), converted exactly in registers. pp_stage
// copies it with cp.async, 16 bytes a copy, and pp_mask zeroes the samples
// outside the row's valid range once they land; resample.cu overlaps the
// next tile's copies with the FIR. Where a window or the table does not fit
// a block, resample.cu reads it from device memory (PpGlobalWindow,
// PpGlobalTaps).

#pragma once

#include <stdint.h>

constexpr int kPpR1 = 7;  // consecutive outputs a thread at up = 1
constexpr int kPpRU = 4;  // outputs a thread, up apart, at up > 1

struct Polyphase {
  int up, down, half_len, K;
};

__host__ __device__ inline int pp_stride(const Polyphase& pp) {
  const int block = pp.down * kPpR1;
  return pp.up == 1 ? (pp.K + block - 1) / block * block : pp.K | 1;
}

// Taps an output reads: the padded row at up = 1 (its zeros included), K else.
__host__ __device__ inline int pp_taps(const Polyphase& pp) {
  return pp.up == 1 ? pp_stride(pp) : pp.K;
}

__host__ __device__ inline long long pp_anchor(long long j, const Polyphase& pp) {
  return j * pp.down + pp.half_len;  // >= 0 for every j >= -1 (half_len >= 10*down)
}

// Lowest input index that outputs from j on read (may be negative).
__host__ __device__ inline long long pp_first_input(long long j, const Polyphase& pp) {
  return pp_anchor(j, pp) / pp.up - (pp_taps(pp) - 1);
}

// Input samples that n >= 1 consecutive outputs read, for any first output:
// q grows by at most ceil((n-1)*down/up) across them.
__host__ __device__ inline int pp_input_span(int n, const Polyphase& pp) {
  return static_cast<int>(
             (static_cast<long long>(n - 1) * pp.down + pp.up - 1) / pp.up) +
         pp_taps(pp);
}

// The window pp_block reads for n outputs: at up = 1 the last thread's
// kPpR1 outputs may run past n.
__host__ __device__ inline int pp_window(int n, const Polyphase& pp) {
  return pp_input_span(pp.up == 1 ? (n + kPpR1 - 1) / kPpR1 * kPpR1 : n, pp);
}

// Floats of shared memory pp_stage needs for n samples (16-byte multiple).
template <typename Sample>
__host__ __device__ inline int pp_stage_floats(int n) {
  constexpr int V = 16 / static_cast<int>(sizeof(Sample));
  return ((n + V - 1) / V * V + V) * static_cast<int>(sizeof(Sample)) / 4;
}

// ceil(n * up / down): the output samples n input samples give.
__host__ __device__ inline long long pp_output_length(long long n, const Polyphase& pp) {
  return (n * pp.up + pp.down - 1) / pp.down;
}

__device__ __forceinline__ uint32_t pp_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronous (lands at pp_copies_wait).
__device__ __forceinline__ void pp_copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(pp_smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void pp_copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// This thread's copies have landed, but for the newest `newer` groups.
template <int newer>
__device__ __forceinline__ void pp_copies_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(newer) : "memory");
}

// Starts copying x[base + lo + i], i < n, from the flat array x of `total`
// samples (base = the row's first sample) into dst (16-byte aligned,
// pp_stage_floats(n) floats), 16-byte vectors from the boundary at or below
// the window's flat index; vectors that would leave the array, and all of
// them where x is not 16-byte aligned, by scalar loads (0 outside the
// array). Returns the shift: the window is dst + shift. Samples outside
// the row's valid range are zeroed by pp_mask once the copies land.
template <typename Sample>
__device__ __forceinline__ int pp_stage(Sample* dst, const Sample* x, long long total, long long base,
                                        long long lo, int n, bool aligned) {
  constexpr int V = 16 / static_cast<int>(sizeof(Sample));  // samples a vector
  const long long flat = base + lo;
  const int shift = static_cast<int>(((flat % V) + V) % V);
  const long long fa = flat - shift;
  const int nv = (n + shift + V - 1) / V;
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const long long f = fa + static_cast<long long>(V) * v;
    if (aligned && f >= 0 && f + V <= total) {
      pp_copy16(dst + V * v, x + f);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) dst[V * v + k] = f + k >= 0 && f + k < total ? x[f + k] : Sample(0);
    }
  }
  return shift;
}

// Whether window samples lie outside [0, len): a block-uniform test.
__device__ __forceinline__ bool pp_needs_mask(long long lo, int n, long long len) {
  return lo < 0 || lo + n > len;
}

// Zeroes the window's samples (in[i] is input index lo + i, i < n) outside
// [0, len): the row's start, and past its length.
template <typename Sample>
__device__ __forceinline__ void pp_mask(Sample* in, long long lo, int n, long long len) {
  const int head = static_cast<int>(min(static_cast<long long>(n), max(-lo, 0LL)));
  const int from = static_cast<int>(max(0LL, min(static_cast<long long>(n), len - lo)));
  for (int i = threadIdx.x; i < head; i += blockDim.x) in[i] = Sample(0);
  for (int i = from + threadIdx.x; i < n; i += blockDim.x) in[i] = Sample(0);
}

// A staged sample as float: int16 through the exponent trick (2^23 * 1.5 +
// v is exact for |v| < 2^22; one integer add and one float add).
__device__ __forceinline__ float pp_sample(float v) { return v; }
__device__ __forceinline__ float pp_sample(int16_t v) {
  return __int_as_float(0x4B400000 + static_cast<int>(v)) - 12582912.f;
}

// What the FIR reads its window and taps through: a pointer (shared memory,
// the staged window and table), or, in resample.cu's global branches, these
// views of device memory read through the read-only path (__ldg; the table
// and the rows' windows stay in L2). PpGlobalWindow's in[i] is x[lo + i] of
// the row x, 0 outside [0, len), so it needs no staging and no pp_mask.
template <typename Sample>
struct PpGlobalWindow {
  const Sample* x;
  long long lo, len;
  __device__ __forceinline__ Sample operator[](long long i) const {
    const long long u = lo + i;
    return u >= 0 && u < len ? __ldg(x + u) : Sample(0);
  }
  __device__ __forceinline__ PpGlobalWindow operator+(long long d) const { return {x, lo + d, len}; }
  __device__ __forceinline__ PpGlobalWindow operator-(long long d) const { return {x, lo - d, len}; }
};

struct PpGlobalTaps {
  const float* t;
  __device__ __forceinline__ float operator[](int i) const { return __ldg(t + i); }
  __device__ __forceinline__ PpGlobalTaps operator+(int d) const { return {t + d}; }
};

// up = 1: outputs j .. j + kPpR1 - 1 into acc, from the window `in` (in[0]
// is input index lo) and the table row `tab`. kD > 0 fixes down at compile
// time (the steps' offsets become immediates); kD = 0 reads it from pp.
// In and Tab are pointers or the global views above.
template <int kD, typename In, typename Tab>
__device__ __forceinline__ void pp_consecutive(float (&acc)[kPpR1], long long j, long long lo,
                                               const In& in, const Tab& tab,
                                               const Polyphase& pp) {
  constexpr int R = kPpR1;
  const int D = kD > 0 ? kD : pp.down;
  const int Kc = pp_stride(pp) / D;  // a multiple of R
  const int base = static_cast<int>(pp_anchor(j, pp) - lo);  // q = a at up = 1
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 1
  for (int c = 0; c < D; ++c) {
    auto z = in + (base - c);  // z[D*m] = x[q - c + D*m]
    auto h = tab + c;          // h[D*k] = tap c + D*k
    float w[R];                // w[m mod R] = z[D*m], m in [r - k] over r < R
#pragma unroll
    for (int m = 1; m < R; ++m) w[m] = pp_sample(z[D * m]);
#pragma unroll 1
    for (int k0 = 0; k0 < Kc; k0 += R, z = z - D * R, h = h + D * R) {
#pragma unroll
      for (int kk = 0; kk < R; ++kk) {
        w[(R - kk) % R] = pp_sample(z[-D * kk]);
        const float hk = h[D * kk];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(hk, w[(r - kk + R) % R], acc[r]);
      }
    }
  }
}

// up > 1: outputs j + up*r for r < nr into acc (the others read a safe
// index and are not used).
template <typename In, typename Tab>
__device__ __forceinline__ void pp_strided(float (&acc)[kPpRU], long long j, int nr, long long lo,
                                  const In& in, const Tab& tab, const Polyphase& pp) {
  constexpr int R = kPpRU;
  const long long a = pp_anchor(j, pp);
  const auto h = tab + static_cast<int>(a % pp.up) * pp_stride(pp);
  const int base = static_cast<int>(a / pp.up - lo);
  int idx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    idx[r] = r < nr ? base + r * pp.down : pp.K - 1;
    acc[r] = 0.f;
  }
#pragma unroll 2
  for (int i = 0; i < pp.K; ++i) {
    const float hi = h[i];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(hi, pp_sample(in[idx[r] - i]), acc[r]);
  }
}

// The block's n outputs j0 + i, i < n, from the staged window (in[0] is
// input index lo, pp_window(n) samples) and table: put(i, y) for every
// i < n, y the FIR's output for i in [live_lo, live_hi) and 0 elsewhere
// (no FIR for a thread's outputs that are all outside).
template <typename In, typename Tab, typename Put>
__device__ __forceinline__ void pp_block(long long j0, int n, int live_lo, int live_hi, long long lo,
                                const In& in, const Tab& tab, const Polyphase& pp,
                                const Put& put) {
  if (pp.up == 1) {
    const int groups = (n + kPpR1 - 1) / kPpR1;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const int i0 = g * kPpR1;
      float acc[kPpR1];
      if (i0 < live_hi && i0 + kPpR1 > live_lo) {
        if (pp.down == 3) {  // 48 kHz -> 16 kHz
          pp_consecutive<3>(acc, j0 + i0, lo, in, tab, pp);
        } else {
          pp_consecutive<0>(acc, j0 + i0, lo, in, tab, pp);
        }
      } else {
#pragma unroll
        for (int r = 0; r < kPpR1; ++r) acc[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kPpR1; ++r) {
        const int i = i0 + r;
        if (i < n) put(i, i >= live_lo && i < live_hi ? acc[r] : 0.f);
      }
    }
  } else {
    const int rows = (n + pp.up - 1) / pp.up;
    const int groups = pp.up * ((rows + kPpRU - 1) / kPpRU);
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const int i0 = g % pp.up + pp.up * kPpRU * (g / pp.up);
      const int nr = i0 < n ? min(kPpRU, (n - 1 - i0) / pp.up + 1) : 0;
      float acc[kPpRU];
      if (nr > 0 && i0 < live_hi) {
        pp_strided(acc, j0 + i0, nr, lo, in, tab, pp);
      } else {
#pragma unroll
        for (int r = 0; r < kPpRU; ++r) acc[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kPpRU; ++r) {
        const int i = i0 + r * pp.up;
        if (r < nr) put(i, i >= live_lo && i < live_hi ? acc[r] : 0.f);
      }
    }
  }
}
