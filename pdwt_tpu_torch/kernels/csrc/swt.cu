// Stationary (a-trous) 2D wavelet kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py, which
// links this file with the other sources into one library).
//
// The entry points of the two Pallas kernels of
// pdwt_tpu/kernels/swt_pallas.py's 2D path, each onto a body of
// swt_matmul.cu in the fd scheme on float32 data:
//
//   pdwt_swt_fwd_level_2d <- _make_swt_fwd_kernel  (swt_pallas.py:95), onto
//                            swt_fwd_mxu_kernel<FD, 1> (kernel 13's body)
//   pdwt_swt_inv_level_2d <- _make_swt_inv_kernel  (swt_pallas.py:231), onto
//                            swt_inv_mxu_kernel<FD> (kernel 14's body)
//
// Index spec (pdwt_tpu_torch/core/conv.py, the same as pdwt_tpu/core/conv.py),
// per axis, at level L with dilation f = 2^(L-1):
//   analysis   out[n] = sum_j t[j] * x[(n + (j - cen) f) mod N],  cen = fwd_center(hlen)
//   synthesis  out[n] = sum_band sum_j t_band[j] * x_band[(n + (j - cen) f) mod N],
//              cen = swt_inv_center(hlen)
// with t the reversed filter (correlation order).  The wrappers compute f and
// cen with those Python helpers and pass them in, and fold the synthesis's
// 1/2 per pass into the inverse's taps, so the kernels hard-code no offset and
// no scale.
//
// The exact analysis is kernel 13's function in the fd scheme with float32
// details, and the exact synthesis with its fused soft/hard/garrote threshold
// kernel 14's on float32 subbands: one float32 sum per output and pass, the
// taps in order, one FMA each.  So both run those bodies, which stage halo
// windows of rows of one residue class mod f, sum register-blocked strips
// (band_strip.cuh) and take their geometry from a launch plan made on the
// host (kernels/swt_matmul.py: swt_fwd_launch_plan, swt_inv_launch_plan, in
// fd); a body of their own would repeat that code line for line.  The
// analysis runs its passes in that body's order, rows (axis -2) first, then
// the columns, as the Pallas kernel does (swt_pallas.py:129-133); its plain
// version (kernels/swt.py) runs the columns first, so the two differ by
// float32 roundoff.  The entry points below are kept apart so that their
// wrappers count their own launches.
//
// Kernel 5 also takes the TI step's thresholded L1 norm as it stores (the
// norm launches of pdwt_swt_fwd_level_2d, onto swt_fwd_mxu_kernel<FD, 1,
// mode>, one instance a threshold mode): each block sums max(|x| - b, 0)
// (soft; hard and garrote likewise, mxu_common.cuh: thresh_l1) over the H,
// V, D values it writes, and |A| on the last level, into one float32
// partial; pdwt_swt_norm_sum_2d (below) then adds a call's partials.  It
// replaces the ~95 plain torch launches of ops/norms.py: thresholded_norm1
// (abs, sub, clamp_min, sum a band), which read each band four times and
// wrote it three times; the epilogue reads nothing more than the stores, so
// it adds no device memory traffic.
//
// Kernels 5 and 6 also have padded entry points (pdwt_swt_fwd_level_2d_padded,
// pdwt_swt_inv_level_2d_padded, at the end of this file), the counterparts of
// swt_pallas.py:935 swt_fwd_level_2d_padded and :960 swt_inv_level_2d_padded:
// the same bodies (swt_matmul.cu: swt_fwd_padded_kernel<FD, false> on
// fwd_tile<FD, 1, true>, swt_inv_mxu_kernel<FD, true>) on local shards that
// hold their ring halo (parallel/sharded.py), reading no wrapped index; the
// tiers' padded entry points of kernels 13 and 14 (swt_matmul.cu) run the
// other instances of those bodies.
//
// Bound: device memory, per level.  The forward reads the image once and
// writes four full-size planes; the inverse reads four planes and writes one.

#include "mxu_common.cuh"

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).
// `taps` is a (4, hlen) float32 device buffer of kernels/_launch.py:
// dual_taps in the fd scheme (the second values 0); `cen` is the center in
// taps, undilated.

namespace pdwt_swtmm {
int launch_fwd(const void* x, float* a, void* h, void* v, void* d, int B, int R, int C,
               const float* taps, int hlen, int os, int f, int cen, int scheme, int in_bf16,
               int det_bf16, int lr, int lc, int gc, int nph, int nt, int threads, int gx,
               int gy, int gz, int smem, void* stream, pdwt_mxu::NormOut nrm);
}  // namespace pdwt_swtmm

// Kernel 5 runs kernel 13's body (swt_matmul.cu: swt_fwd_mxu_kernel, output
// step 1) in the fd scheme on a float32 image into four float32 planes.
// `cen` = fwd_center(hlen); the launch plan is
// kernels/swt_matmul.py:swt_fwd_launch_plan's for fd, checked by the
// launcher it calls (pdwt_swtmm::launch_fwd).  norm_mode 0 is the plain
// launch; 1 soft, 2 hard, 3 garrote a norm launch, which also writes the
// thresholded L1 norm of H, V and D at the float at `beta` (device memory),
// plus |A| where `approx`, as gx gy gz float32 partials to `partials`.
extern "C" int pdwt_swt_fwd_level_2d(const float* x, float* a, float* h, float* v, float* d,
                                     int B, int R, int C, const float* taps, int hlen, int f,
                                     int cen, int lr, int lc, int gc, int nph, int nt,
                                     int threads, int gx, int gy, int gz, int smem,
                                     int norm_mode, const float* beta, float* partials,
                                     int approx, void* stream) {
  return pdwt_swtmm::launch_fwd(x, a, h, v, d, B, R, C, taps, hlen, 1, f, cen, pdwt_mxu::FD, 0, 0,
                                lr, lc, gc, nph, nt, threads, gx, gy, gz, smem, stream,
                                {norm_mode, beta, partials, approx});
}

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

extern "C" int pdwt_swt_inv_level_2d_mxu(const float* a, const void* h, const void* v,
                                         const void* d, void* out, int B, int R, int C,
                                         const float* taps, int hlen, int f, int cen, int scheme,
                                         int det_bf16, int out_bf16, int thresh_mode,
                                         const float* beta, int lr, int lc, int gc, int nph,
                                         int nt, int threads, int gx, int gy, int gz, int smem,
                                         void* stream);

// Kernel 6 runs kernel 14's body (swt_matmul.cu: swt_inv_mxu_kernel) in the fd
// scheme on float32 subbands into a float32 output.  `taps` holds the halved
// filters; `cen` = swt_inv_center(hlen); thresh_mode: 0 none, 1 soft, 2 hard,
// 3 garrote of H, V and D with the float at `beta` (device memory; unread when
// thresh_mode is 0); the launch plan is kernels/swt_matmul.py:
// swt_inv_launch_plan's for fd, checked by the entry point.
extern "C" int pdwt_swt_inv_level_2d(const float* a, const float* h, const float* v,
                                     const float* d, float* out, int B, int R, int C,
                                     const float* taps, int hlen, int f, int cen,
                                     int thresh_mode, const float* beta, int lr, int lc, int gc,
                                     int nph, int nt, int threads, int gx, int gy, int gz,
                                     int smem, void* stream) {
  return pdwt_swt_inv_level_2d_mxu(a, h, v, d, out, B, R, C, taps, hlen, f, cen, pdwt_mxu::FD,
                                   0, 0, thresh_mode, beta, lr, lc, gc, nph, nt, threads, gx, gy,
                                   gz, smem, stream);
}

namespace pdwt_swtmm {
int launch_fwd_padded(const void* x, float* a, void* h, void* v, void* d, int B, int R, int C,
                      int Ro, int Co, const float* taps, int hlen, int os, int f, int scheme,
                      int in_bf16, int det_bf16, int lr, int lc, int gc, int nph, int nt,
                      int threads, int gx, int gy, int gz, int smem, void* stream);
int launch_swt_inv_padded(const float* a, const void* h, const void* v, const void* d, void* out,
                          int B, int Ri, int Ci, int R, int C, const float* taps, int hlen, int f,
                          int scheme, int det_bf16, int out_bf16, int lr, int lc, int gc,
                          int nph, int nt, int threads, int gx, int gy, int gz, int smem,
                          void* stream);
}  // namespace pdwt_swtmm

// The padded entry points of kernels 5 and 6 (the sharded SWT,
// parallel/sharded.py), on the a-trous bodies of swt_matmul.cu with index
// tables that do not wrap.  Kernel 5's: an (B, R, C) float32 input that
// holds its halo -> four (B, Ro, Co) planes, out[n] = sum_j t[j] x[n + j f]
// per axis; taps as kernel 5's, the plan kernels/swt.py:
// swt_fwd_padded_launch_plan's.  Refused where Ro + (hlen - 1) f > R (or
// the columns'): a stored output would read outside the input.
extern "C" int pdwt_swt_fwd_level_2d_padded(const float* x, float* a, float* h, float* v,
                                            float* d, int B, int R, int C, int Ro, int Co,
                                            const float* taps, int hlen, int f, int lr, int lc,
                                            int gc, int nph, int nt, int threads, int gx, int gy,
                                            int gz, int smem, void* stream) {
  return pdwt_swtmm::launch_fwd_padded(x, a, h, v, d, B, R, C, Ro, Co, taps, hlen, 1, f,
                                       pdwt_mxu::FD, 0, 0, lr, lc, gc, nph, nt, threads, gx, gy,
                                       gz, smem, stream);
}

// Kernel 6's: four (B, Ri, Ci) float32 subbands that hold their halo ->
// (B, R, C), out[n] = sum_band sum_j t_band[j] x_band[n + j f] per axis, no
// threshold; the halved taps as kernel 6's, the plan kernels/swt.py:
// swt_inv_padded_launch_plan's.  Refused where R + (hlen - 1) f > Ri (or
// the columns').
extern "C" int pdwt_swt_inv_level_2d_padded(const float* a, const float* h, const float* v,
                                            const float* d, float* out, int B, int Ri, int Ci,
                                            int R, int C, const float* taps, int hlen, int f,
                                            int lr, int lc, int gc, int nph, int nt, int threads,
                                            int gx, int gy, int gz, int smem, void* stream) {
  return pdwt_swtmm::launch_swt_inv_padded(a, h, v, d, out, B, Ri, Ci, R, C, taps, hlen, f,
                                           pdwt_mxu::FD, 0, 0, lr, lc, gc, nph, nt, threads, gx,
                                           gy, gz, smem, stream);
}
