// Polyphase FIR shared by the port's resampling kernels (resample.cu, and
// the fused resample of frontend.cu): scipy resample_poly's algebra
// (mfcc_tpu_torch/ops/resample.py, the reference's _stream_design) with
// the filter's n_pre_pad leading zeros dropped. Output j is
//
//   a = j*down + half_len,  p = a mod up,  q = a div up
//   y[j] = sum_{i<K} table[p*K + i] * x[q - i]
//
// where table [up][K] holds the filter phase by phase (polyphase_design,
// zeros past its end) and x[u] = 0 outside the signal. Input indices are
// int64: at 44.1 kHz (up = 160, down = 441) j*down passes 2^31 after
// ~4.9 M output samples.
//
// A kernel stages a window of x, starting at input index `lo`, in shared
// memory: outputs [j0, j0 + n) read inputs [pp_first_input(j0),
// pp_first_input(j0) + pp_input_span(n)).

#pragma once

struct Polyphase {
  int up, down, half_len, K;
};

__host__ __device__ inline long long pp_anchor(long long j, const Polyphase& pp) {
  return j * pp.down + pp.half_len;  // >= 0 for every j >= -1 (half_len >= 10*down)
}

// Lowest input index that outputs from j on read (may be negative).
__host__ __device__ inline long long pp_first_input(long long j, const Polyphase& pp) {
  return pp_anchor(j, pp) / pp.up - (pp.K - 1);
}

// Input samples that n >= 1 consecutive outputs read, for any first output:
// q grows by at most ceil((n-1)*down/up) across them.
__host__ __device__ inline int pp_input_span(int n, const Polyphase& pp) {
  return static_cast<int>(
             (static_cast<long long>(n - 1) * pp.down + pp.up - 1) / pp.up) +
         pp.K;
}

// ceil(n * up / down): the output samples n input samples give.
__host__ __device__ inline long long pp_output_length(long long n, const Polyphase& pp) {
  return (n * pp.up + pp.down - 1) / pp.down;
}

// Output j from the staged window `in` (in[0] is input index lo) and the
// staged table `tab`; fp32 FMA over the phase's K taps.
__device__ inline float pp_output(long long j, long long lo, const float* in,
                                  const float* tab, const Polyphase& pp) {
  const long long a = pp_anchor(j, pp);
  const float* h = tab + static_cast<int>(a % pp.up) * pp.K;
  const float* x = in + (a / pp.up - lo);
  float acc = 0.f;
  for (int i = 0; i < pp.K; ++i) acc = fmaf(h[i], x[-i], acc);
  return acc;
}
