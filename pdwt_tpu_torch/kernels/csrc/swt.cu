// The last step of the TI step's fused norm for Hopper (sm_90a), with a plain
// C interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py, which
// links this file with the other sources into one library).
//
// The two Pallas kernels of pdwt_tpu/kernels/swt_pallas.py's 2D path,
// _make_swt_fwd_kernel (swt_pallas.py:95) and _make_swt_inv_kernel
// (swt_pallas.py:231, with its fused soft/hard/garrote threshold), are
// kernels 13's and 14's functions in the fd scheme on float32 data: one
// float32 sum per output and pass, the taps in order, one FMA each.  So
// kernels 5 and 6, and their padded forms, have no entry point of their
// own: kernels/swt.py launches kernel 13's and 14's (swt_matmul.cu:
// pdwt_swt_fwd_level_2d_mxu, pdwt_swt_inv_level_2d_mxu, and their padded
// forms) with scheme FD on float32, on their launch plans in fd
// (kernels/swt_matmul.py), and counts the launches under kernels 5's and
// 6's names.
//
// Kernel 5 also takes the TI step's thresholded L1 norm as it stores (its
// norm launches: pdwt_swt_fwd_level_2d_mxu with a norm mode, in fd only,
// onto swt_fwd_mxu_kernel<FD, 1, mode>): each block sums max(|x| - b, 0)
// (soft; hard and garrote likewise, mxu_common.cuh: thresh_l1) over the H,
// V, D values it writes, and |A| on the last level, into one float32
// partial; pdwt_swt_norm_sum_2d (below) then adds a call's partials, and
// kernel 7's norm launches' (mxu1d.cu: pdwt_fwd_level_1d_norm).  It
// replaces the ~95 plain torch launches of ops/norms.py: thresholded_norm1
// (abs, sub, clamp_min, sum a band), which read each band four times and
// wrote it three times; the epilogue reads nothing more than the stores, so
// it adds no device memory traffic.

#include "mxu_common.cuh"

// The entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).

namespace {

constexpr int kSumThreads = 1024;

// The fused norm's last step (no TPU kernel: JAX sums the norm in XLA): the
// n partials of a call's kernel-5 norm launches, each thread a fixed strided
// share in float64, then a tree over the block in shared memory, into one
// float32.  The order never changes, so neither does the sum.  Bound:
// latency, one block reading about 20,000 floats that kernel 5 just wrote
// (L2), a few microseconds.
__global__ void __launch_bounds__(kSumThreads)
swt_norm_sum_kernel(const float* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ double s[kSumThreads];
  double t = 0.0;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kSumThreads) t += partials[i];
  s[threadIdx.x] = t;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = (float)s[0];
}

}  // namespace

// The sum of n >= 1 float32 partials (device memory) into the float at `out`.
extern "C" int pdwt_swt_norm_sum_2d(const float* partials, int n, float* out, void* stream) {
  if (n < 1 || !partials || !out) return cudaErrorInvalidValue;
  swt_norm_sum_kernel<<<1, kSumThreads, 0, (cudaStream_t)stream>>>(partials, n, out);
  return cudaGetLastError();
}
