// Batched 1D wavelet kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (pdwt_tpu_torch/kernels/_build.py, which links this
// file with the other sources into one library).
//
// The entry points of the four Pallas kernels of the batched 1D part of
// pdwt_tpu/kernels/swt_pallas.py, each onto a body of mxu1d.cu in the fd
// scheme on float32 data:
//
//   pdwt_fwd_level_1d     <- _make_1d_fwd_kernel     (swt_pallas.py:395), onto
//                            fwd1d_strip_kernel<FD, 2> (kernel 15's decimated body)
//   pdwt_inv_level_1d     <- _make_1d_inv_kernel     (swt_pallas.py:455), onto
//                            inv1d_strip_kernel<FD, 2> (kernel 16's polyphase body)
//   pdwt_swt_fwd_level_1d <- _make_swt1d_fwd_kernel  (swt_pallas.py:528), onto
//                            fwd1d_strip_kernel<FD, 1> (kernel 15's a-trous body)
//   pdwt_swt_inv_level_1d <- _make_swt1d_inv_kernel  (swt_pallas.py:593), onto
//                            inv1d_strip_kernel<FD, 1> (kernel 16's a-trous body)
//
// Every kernel filters along the last axis of a (B, N) batch of signals.
// Index spec (pdwt_tpu_torch/core/conv.py, the same as pdwt_tpu/core/conv.py),
// with t the reversed filter (correlation order):
//   decimated analysis   out[n]      = sum_j t[j] * x[(2n - cen + j) mod N],
//                        cen = fwd_center(hlen), N even
//   polyphase synthesis  out[2m + q] = sum_band sum_b t_band[p_q + 2b] *
//                                      x_band[(m + o_q + b) mod M],
//                        (p, o, nb, lo, hi) = poly_geometry(hlen)
//   a-trous analysis     out[n] = sum_j t[j] * x[(n - cen + j*f) mod N],
//                        cen = fwd_center(hlen) * f
//   a-trous synthesis    out[n] = sum_band sum_j t_band[j] * x_band[(n - cen + j*f) mod N],
//                        cen = swt_inv_center(hlen) * f
// at level L with dilation f = 2^(L-1).  The wrappers (kernels/batched1d.py)
// compute the offsets with those Python helpers and pass them in, and fold the
// a-trous synthesis's single 1/2 (one pass in 1D) into its taps, so the kernels
// hard-code no offset and no scale.
//
// Kernels 7 and 8 also have padded entry points (pdwt_fwd_level_1d_padded,
// pdwt_inv_level_1d_padded, at the end of this file), the counterparts of
// swt_pallas.py:995 fwd_level_1d_padded and :1018 inv_level_1d_padded: the
// same bodies on signals or bands the caller extended or padded, reading
// no wrapped index, for the boundary modes.  So do kernels 9 and 10
// (pdwt_swt_fwd_level_1d_padded, pdwt_swt_inv_level_1d_padded), the
// counterparts of swt_pallas.py:1043 and :1069, on local shards that hold
// their ring halo, for the sharded SWT (parallel/sharded.py).
//
// The four exact kernels are kernels 15's and 16's functions in the fd scheme
// on float32 data: every output sums the taps in order, each one FMA into one
// float32 sum per filter (a synthesis: the low taps on the low band, then the
// high taps on the high band), as the plain versions do.  So they run those
// bodies, which stage each group of 32 signals' windows once, sum
// register-blocked strips (band_strip.cuh) and take their geometry from a
// launch plan made on the host (kernels/mxu1d.py: fwd1d_launch_plan,
// inv1d_launch_plan, in fd); the zero taps that pad a filter to the strip's
// chunk, or a parity's table to the common origin, leave a finite sum as it
// is.  The entry points below are kept apart so that their wrappers count
// their own launches; this file holds no kernel of its own.
//
// Bound: device memory.  Per level a kernel reads its input once and writes
// its output once; 2*hlen FMAs per output are cheap beside the bytes.

#include "mxu_common.cuh"

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).

extern "C" int pdwt_fwd_level_1d_mxu(const void* x, float* lo, void* hi, int B, int N,
                                     const float* taps, int hlen, int f, int cen, int scheme,
                                     int in_bf16, int hi_bf16, int lc, int gc, int nt, int threads,
                                     int gx, int gy, int gz, int smem, void* stream);

// `taps` is the (4, hlen) float32 device buffer of kernels/_launch.py:
// dual_taps in fd (the second values 0); `cen` = fwd_center(hlen); N is
// even; the launch plan is kernels/mxu1d.py:fwd1d_launch_plan's (fd,
// decimated), checked by the entry point it calls.
extern "C" int pdwt_fwd_level_1d(const float* x, float* lo, float* hi, int B, int N,
                                 const float* taps, int hlen, int cen, int lc, int gc, int nt,
                                 int threads, int gx, int gy, int gz, int smem, void* stream) {
  return pdwt_fwd_level_1d_mxu(x, lo, hi, B, N, taps, hlen, 1, cen, pdwt_mxu::FD, 0, 0, lc, gc,
                               nt, threads, gx, gy, gz, smem, stream);
}
namespace pdwt_m1d {
int launch_fwd_norm(const float* x, float* lo, float* hi, int B, int N, const float* taps,
                    int hlen, int cen, int lc, int gc, int nt, int threads, int gx, int gy,
                    int gz, int smem, void* stream, pdwt_mxu::NormOut nrm);
}  // namespace pdwt_m1d

// Kernel 7's norm launches: pdwt_fwd_level_1d's arguments and plan, then
// norm_mode (1 soft, 2 hard, 3 garrote), beta (one float on the device)
// and partials.  The high band is stored thresholded at beta, and the L1
// norm of what is stored goes to gx gy float32 partials, one a block
// (mxu1d.cu: fwd1d_strip_kernel<FD, 2, false, mode>), which
// pdwt_swt_norm_sum_2d (swt.cu) adds.  It takes the place of the plain
// threshold and the norm of the details in the batched 1D denoising step
// (the five torch passes a band of ops/threshold.py and the abs and sum of
// ops/norms.py: norm1), which read each band about seven times and wrote
// it four; the epilogue moves no byte more than the plain launch.
extern "C" int pdwt_fwd_level_1d_norm(const float* x, float* lo, float* hi, int B, int N,
                                      const float* taps, int hlen, int cen, int lc, int gc,
                                      int nt, int threads, int gx, int gy, int gz, int smem,
                                      int norm_mode, const float* beta, float* partials,
                                      void* stream) {
  return pdwt_m1d::launch_fwd_norm(x, lo, hi, B, N, taps, hlen, cen, lc, gc, nt, threads, gx, gy,
                                   gz, smem, stream, {norm_mode, beta, partials, 0});
}

extern "C" int pdwt_inv_level_1d_mxu(const float* lo, const void* hi, void* out, int B, int M,
                                     const float* taps, int hlen, int f, int cen, const int* geo,
                                     int scheme, int hi_bf16, int out_bf16, int lc, int gc,
                                     int nt, int threads, int gx, int gy, int gz, int smem,
                                     void* stream);

// `taps` is the (4, hlen) float32 device buffer of kernels/_launch.py:
// dual_taps in fd (the second values 0); geo: p[0], p[1], o[0], o[1], nb[0],
// nb[1], lo, hi of poly_geometry(hlen), on the host; the launch plan is
// kernels/mxu1d.py:inv1d_launch_plan's (fd, polyphase), checked by the entry
// point it calls.
extern "C" int pdwt_inv_level_1d(const float* lo, const float* hi, float* out, int B, int M,
                                 const float* taps, int hlen, const int* geo, int lc, int gc,
                                 int nt, int threads, int gx, int gy, int gz, int smem,
                                 void* stream) {
  return pdwt_inv_level_1d_mxu(lo, hi, out, B, M, taps, hlen, 1, 0, geo, pdwt_mxu::FD, 0, 0, lc,
                               gc, nt, threads, gx, gy, gz, smem, stream);
}

extern "C" int pdwt_swt_fwd_level_1d_mxu(const void* x, float* lo, void* hi, int B, int N,
                                         const float* taps, int hlen, int f, int cen, int scheme,
                                         int in_bf16, int hi_bf16, int lc, int gc, int nt,
                                         int threads, int gx, int gy, int gz, int smem,
                                         void* stream);

// `taps` is the (4, hlen) float32 device buffer of kernels/_launch.py:
// dual_taps in fd (the second values 0); `cen` is the dilated center,
// fwd_center(hlen) * f; the launch plan is kernels/mxu1d.py:
// fwd1d_launch_plan's (fd, a-trous), checked by the entry point it calls.
extern "C" int pdwt_swt_fwd_level_1d(const float* x, float* lo, float* hi, int B, int N,
                                     const float* taps, int hlen, int f, int cen, int lc, int gc,
                                     int nt, int threads, int gx, int gy, int gz, int smem,
                                     void* stream) {
  return pdwt_swt_fwd_level_1d_mxu(x, lo, hi, B, N, taps, hlen, f, cen, pdwt_mxu::FD, 0, 0, lc,
                                   gc, nt, threads, gx, gy, gz, smem, stream);
}

extern "C" int pdwt_swt_inv_level_1d_mxu(const float* lo, const void* hi, void* out, int B, int M,
                                         const float* taps, int hlen, int f, int cen,
                                         const int* geo, int scheme, int hi_bf16, int out_bf16,
                                         int lc, int gc, int nt, int threads, int gx, int gy,
                                         int gz, int smem, void* stream);

// `taps` is the (4, hlen) float32 device buffer of kernels/_launch.py:
// dual_taps in fd of the halved filters (the second values 0); `cen` is the
// dilated center, swt_inv_center(hlen) * f; the launch plan is
// kernels/mxu1d.py:inv1d_launch_plan's (fd, a-trous), checked by the entry
// point it calls.
extern "C" int pdwt_swt_inv_level_1d(const float* lo, const float* hi, float* out, int B, int N,
                                     const float* taps, int hlen, int f, int cen, int lc, int gc,
                                     int nt, int threads, int gx, int gy, int gz, int smem,
                                     void* stream) {
  return pdwt_swt_inv_level_1d_mxu(lo, hi, out, B, N, taps, hlen, f, cen, nullptr, pdwt_mxu::FD,
                                   0, 0, lc, gc, nt, threads, gx, gy, gz, smem, stream);
}

namespace pdwt_m1d {
int launch_fwd_padded(const void* x, float* lo, void* hi, int B, int N, int n_out,
                      const float* taps, int hlen, int scheme, int in_bf16, int hi_bf16, int lc,
                      int gc, int nt, int threads, int gx, int gy, int gz, int smem,
                      void* stream);
int launch_inv_padded(const float* lo, const void* hi, void* out, int B, int M, const int* pad,
                      const float* taps, int hlen, const int* geo, int scheme, int hi_bf16,
                      int out_bf16, int lc, int gc, int nt, int threads, int gx, int gy, int gz,
                      int smem, void* stream);
int launch_swt_fwd_padded(const void* x, float* lo, void* hi, int B, int N, int n_out,
                          const float* taps, int hlen, int f, int scheme, int in_bf16,
                          int hi_bf16, int lc, int gc, int nt, int threads, int gx, int gy,
                          int gz, int smem, void* stream);
int launch_swt_inv_padded(const float* lo, const void* hi, void* out, int B, int M, int n_out,
                          const float* taps, int hlen, int f, int scheme, int hi_bf16,
                          int out_bf16, int lc, int gc, int nt, int threads, int gx, int gy,
                          int gz, int smem, void* stream);
}  // namespace pdwt_m1d

// The padded entry points of kernels 7 and 8 (the boundary modes,
// core/separable.py: the mode route), on the polyphase and decimated
// bodies of mxu1d.cu with index tables that do not wrap.  Kernel 7's: (B,
// N) float32 signals that hold their extension -> two (B, n_out) bands,
// out[n] = sum_j t[j] x[2n + j]; taps as kernel 7's, the plan
// kernels/batched1d.py: fwd1d_padded_launch_plan's.
extern "C" int pdwt_fwd_level_1d_padded(const float* x, float* lo, float* hi, int B, int N,
                                        int n_out, const float* taps, int hlen, int lc, int gc,
                                        int nt, int threads, int gx, int gy, int gz, int smem,
                                        void* stream) {
  return pdwt_m1d::launch_fwd_padded(x, lo, hi, B, N, n_out, taps, hlen, pdwt_mxu::FD, 0, 0, lc,
                                     gc, nt, threads, gx, gy, gz, smem, stream);
}

// Kernel 8's: two padded (B, M) float32 bands -> (B, pad[2]); `pad` holds
// base, off and n_out (band_strip.cuh: PadAxis); taps and geometry as
// kernel 8's, the plan kernels/batched1d.py: inv1d_padded_launch_plan's.
extern "C" int pdwt_inv_level_1d_padded(const float* lo, const float* hi, float* out, int B,
                                        int M, const int* pad, const float* taps, int hlen,
                                        const int* geo, int lc, int gc, int nt, int threads,
                                        int gx, int gy, int gz, int smem, void* stream) {
  return pdwt_m1d::launch_inv_padded(lo, hi, out, B, M, pad, taps, hlen, geo, pdwt_mxu::FD, 0, 0,
                                     lc, gc, nt, threads, gx, gy, gz, smem, stream);
}

// The padded entry points of kernels 9 and 10 (the sharded SWT,
// parallel/sharded.py), on the a-trous bodies of mxu1d.cu with index tables
// that do not wrap.  Kernel 9's: (B, N) float32 signals that hold their
// halo -> two (B, n_out) bands, out[n] = sum_j t[j] x[n + j f]; taps as
// kernel 9's, the plan kernels/batched1d.py: swt_fwd1d_padded_launch_plan's.
// Refused where n_out + (hlen - 1) f > N: an output would read outside.
extern "C" int pdwt_swt_fwd_level_1d_padded(const float* x, float* lo, float* hi, int B, int N,
                                            int n_out, const float* taps, int hlen, int f,
                                            int lc, int gc, int nt, int threads, int gx, int gy,
                                            int gz, int smem, void* stream) {
  return pdwt_m1d::launch_swt_fwd_padded(x, lo, hi, B, N, n_out, taps, hlen, f, pdwt_mxu::FD, 0,
                                         0, lc, gc, nt, threads, gx, gy, gz, smem, stream);
}

// Kernel 10's: two (B, M) float32 bands that hold their halo -> (B, n_out),
// out[n] = sum_band sum_j t_band[j] x_band[n + j f]; the halved taps as
// kernel 10's, the plan kernels/batched1d.py: swt_inv1d_padded_launch_plan's.
// Refused where n_out + (hlen - 1) f > M.
extern "C" int pdwt_swt_inv_level_1d_padded(const float* lo, const float* hi, float* out, int B,
                                            int M, int n_out, const float* taps, int hlen, int f,
                                            int lc, int gc, int nt, int threads, int gx, int gy,
                                            int gz, int smem, void* stream) {
  return pdwt_m1d::launch_swt_inv_padded(lo, hi, out, B, M, n_out, taps, hlen, f, pdwt_mxu::FD,
                                         0, 0, lc, gc, nt, threads, gx, gy, gz, smem, stream);
}
