// Polyphase resampler for Hopper (sm_90a): float32 rows [B, T] at sr_in ->
// [B, n_out] at sr_out, n_out = ceil(T * up / down); scipy resample_poly
// with constant (zero) padding.
//
// Replaces mfcc_tpu/kernels/resample.py::resample_pallas (:104, kernel
// _make_kernel :79, pallas_call :128), which takes integer decimation only;
// this kernel takes every ratio whose tap table fits its shared memory, so
// the JAX package's two-dot XLA path for 44.1 kHz and 8 kHz needs no port
// of its own. Plain version and wrapper: mfcc_tpu_torch/kernels/resample.py
// (resample_reference, polyphase_resample).
//
// Bound at the main path's shapes (48 kHz -> 16 kHz, [64, 480,080] ->
// [64, 160,027]; H100 SXM peaks): bytes 122.9 MB in + 41.0 MB out = 164 MB
// -> 49 us at 3.35 TB/s; operations 91 FLOP per output (the 61 symmetric
// taps folded) = 0.93 GFLOP -> 14 us at 67 TFLOP/s fp32. Bytes bound it;
// chip_smoke.py computes the bound from each run's inputs.
//
// Design. One block per (row, tile of 2,048 outputs), 256 threads: the
// block stages the tile's input window (tile*down/up + K samples, zero
// outside the row) and the [up][K] tap table in shared memory with
// coalesced loads, then each thread computes 8 outputs by the polyphase
// dot of polyphase.cuh (fp32 FMA). Every input byte is read about once
// from device memory (the K-sample halo between tiles is L2's). A tap table
// larger than the shared-memory budget is refused by the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

#include "polyphase.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileOut = 2048;  // outputs per block (kernels/resample.py TILE_OUT)

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

__global__ void __launch_bounds__(kThreads)
resample_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ table, int T, int n_out, Polyphase pp) {
  extern __shared__ __align__(16) float smem[];
  float* tab = smem;
  float* in = smem + align4(pp.up * pp.K);

  const int b = blockIdx.y;
  const long long j0 = static_cast<long long>(blockIdx.x) * kTileOut;
  const int n = static_cast<int>(min(static_cast<long long>(kTileOut), n_out - j0));
  const long long lo = pp_first_input(j0, pp);
  const int in_len = pp_input_span(n, pp);
  const float* row = x + static_cast<size_t>(b) * T;

  for (int i = threadIdx.x; i < pp.up * pp.K; i += kThreads) tab[i] = table[i];
  for (int i = threadIdx.x; i < in_len; i += kThreads) {
    const long long u = lo + i;
    in[i] = (u >= 0 && u < T) ? row[u] : 0.f;
  }
  __syncthreads();

  float* out = y + static_cast<size_t>(b) * n_out + j0;
  for (int jj = threadIdx.x; jj < n; jj += kThreads) {
    out[jj] = pp_output(j0 + jj, lo, in, tab, pp);
  }
}

// Shared memory for this ratio, in bytes (kernels/resample.py smem_bytes).
long long smem_bytes(const Polyphase& pp) {
  return (static_cast<long long>(align4(pp.up * pp.K)) + pp_input_span(kTileOut, pp)) *
         static_cast<long long>(sizeof(float));
}

}  // namespace

extern "C" {

// Launches the resampler on `stream`; returns cudaGetLastError() (0 = launched).
// x [B, T] float32; y [B, n_out] float32; table [up, K] float32.
int mfcc_resample(const float* x, float* y, const float* table, int B, int T,
                  int n_out, int up, int down, int half_len, int K, void* stream) {
  if (B < 1 || T < 1 || n_out < 1 || up < 1 || down < 1 || K < 1) {
    return cudaErrorInvalidValue;
  }
  const Polyphase pp{up, down, half_len, K};
  const long long bytes = smem_bytes(pp);
  cudaError_t err = cudaFuncSetAttribute(
      resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_out + kTileOut - 1) / kTileOut, B);
  resample_kernel<<<grid, kThreads, static_cast<size_t>(bytes),
                    static_cast<cudaStream_t>(stream)>>>(x, y, table, T, n_out, pp);
  return cudaGetLastError();
}

const char* mfcc_resample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
