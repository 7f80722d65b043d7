// The 2D level entry points of the precision tiers for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py
// links this file with the other sources into one library).
//
// The kernels of the two Pallas kernels of pdwt_tpu/kernels/matmul_pallas.py
// run bodies that other files hold, each redesigned for Hopper's CUDA cores on
// band_strip.cuh and templated on the compute scheme:
//
//   swt_matmul.cu: swt_fwd_mxu_kernel<S, 2> <- _fwd_mxu_kernel  (matmul_pallas.py:242)
//   separable.cu:  inv_level_kernel<S>      <- _inv_mxu_kernel  (matmul_pallas.py:360)
//
// The analysis is kernel 13's body at output step 2 and dilation 1, the
// synthesis kernel 2's body; kernels 1 and 2 (and their padded forms) are
// these entry points with scheme FD on float32 (kernels/separable.py).  Each
// body already computed its function in the TPU kernel's sum order (rows,
// axis -2, first, then columns, the float32 row-pass result split per
// scheme in between; every output one float32 sum per scheme term, taps in
// order), so the b-schemes match their plain versions bit for bit.  The index spec is core/conv.py's:
//   analysis   out[n]      = sum_j t[j] * x[(2n - cen + j) mod N]
//   synthesis  out[2m + q] = sum_band sum_b t_band[p_q + 2b] * x_band[(m + o_q + b) mod M]
// Types: the analysis reads float32 or bf16 and writes a float32
// approximation and float32 or bf16 details; the synthesis reads a float32
// approximation with float32 or bf16 details and writes float32 or bf16.
// Each also has a padded entry point (at the end of this file), the
// counterpart of its wrapper's pad_fn= (matmul_pallas.py:306, :442): the
// same body on an input the caller padded with the ring halo, reading no
// wrapped index.

namespace pdwt_swtmm {
int launch_fwd(const void* x, float* a, void* h, void* v, void* d, int B, int R, int C,
               const float* taps, int hlen, int os, int f, int cen, int scheme, int in_bf16,
               int det_bf16, int lr, int lc, int gc, int nph, int nt, int threads, int gx,
               int gy, int gz, int smem, void* stream);
}

namespace pdwt_swtmm {
int launch_fwd_padded(const void* x, float* a, void* h, void* v, void* d, int B, int R, int C,
                      int Ro, int Co, const float* taps, int hlen, int os, int f, int scheme,
                      int in_bf16, int det_bf16, int lr, int lc, int gc, int nph, int nt,
                      int threads, int gx, int gy, int gz, int smem, void* stream);
}

namespace pdwt_sep {
int launch_inv_padded(const float* a, const void* h, const void* v, const void* d, void* out,
                      int B, int Mr, int Mc, const int* pad, const float* taps, int hlen,
                      const int* geo, int scheme, int det_bf16, int out_bf16, int lr, int lc,
                      int nt, int threads, int gx, int gy, int gz, int smem, void* stream);
int launch_inv_level(const float* a, const void* h, const void* v, const void* d, void* out,
                     int B, int Mr, int Mc, const float* taps, int hlen, const int* geo,
                     int scheme, int det_bf16, int out_bf16, int lr, int lc, int nt, int threads,
                     int gx, int gy, int gz, int smem, void* stream);
}

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).
// `scheme` is the index in kernels/matmul.py:SCHEMES; the *_bf16 flags pick
// bf16 (1) or float32 (0) storage; `taps` is a (4, hlen) float32 device
// buffer (the low filter's first and second values, then the high filter's,
// correlation order).

// Kernel 11 runs kernel 13's body (swt_matmul.cu: swt_fwd_mxu_kernel) at
// output step 2 on an even (B, R, C) image; `cen` is fwd_center(hlen).  The
// launch plan (kernels/matmul.py:fwd_launch_plan: tile lr x lc subband
// positions, column stride gc = 1, nph output phases, nt padded taps,
// threads, grid (gx, gy, gz), dynamic shared-memory bytes) is checked by the
// launcher, which refuses one that does not add up.
extern "C" int pdwt_fwd_level_2d_mxu(const void* x, float* a, void* h, void* v, void* d, int B,
                                     int R, int C, const float* taps, int hlen, int cen,
                                     int scheme, int in_bf16, int det_bf16, int lr, int lc,
                                     int gc, int nph, int nt, int threads, int gx, int gy,
                                     int gz, int smem, void* stream) {
  return pdwt_swtmm::launch_fwd(x, a, h, v, d, B, R, C, taps, hlen, 2, 1, cen, scheme, in_bf16,
                                det_bf16, lr, lc, gc, nph, nt, threads, gx, gy, gz, smem,
                                stream);
}

// Kernel 12 runs kernel 2's body (separable.cu: inv_level_kernel) in the
// scheme.  `geo` is poly_geometry(hlen); the launch plan
// (kernels/matmul.py: inv_level_launch_plan for the scheme: tile lr x lc,
// nt padded taps per parity, threads, grid (gx, gy, gz), dynamic
// shared-memory bytes) is checked by the launcher, which refuses one that
// does not add up.
extern "C" int pdwt_inv_level_2d_mxu(const float* a, const void* h, const void* v, const void* d,
                                     void* out, int B, int Mr, int Mc, const float* taps, int hlen,
                                     const int* geo, int scheme, int det_bf16, int out_bf16,
                                     int lr, int lc, int nt, int threads, int gx, int gy, int gz,
                                     int smem, void* stream) {
  return pdwt_sep::launch_inv_level(a, h, v, d, out, B, Mr, Mc, taps, hlen, geo, scheme,
                                    det_bf16, out_bf16, lr, lc, nt, threads, gx, gy, gz, smem,
                                    stream);
}

// The padded entry points of kernels 11 and 12 (the sharded DWT under the
// precision tiers, parallel/sharded.py: the ring halo is the pad), on the
// same bodies with index tables that do not wrap.  Kernel 11's: a (B, R, C)
// input (bf16 where in_bf16) that holds its odd extension and halo -> four
// (B, Ro, Co) subbands, A float32 and H, V, D bf16 where det_bf16, out[n] =
// sum_j t[j] x[2n + j] per axis (swt_matmul.cu: fwd_padded_kernel<S,
// true>); taps as kernel 11's, the plan kernels/matmul.py:
// fwd_padded_launch_plan's.  Refused where 2 (Ro - 1) + hlen > R (or the
// columns'): a stored output would read outside the input.
extern "C" int pdwt_fwd_level_2d_mxu_padded(const void* x, float* a, void* h, void* v, void* d,
                                            int B, int R, int C, int Ro, int Co,
                                            const float* taps, int hlen, int scheme, int in_bf16,
                                            int det_bf16, int lr, int lc, int gc, int nph, int nt,
                                            int threads, int gx, int gy, int gz, int smem,
                                            void* stream) {
  return pdwt_swtmm::launch_fwd_padded(x, a, h, v, d, B, R, C, Ro, Co, taps, hlen, 2, 1, scheme,
                                       in_bf16, det_bf16, lr, lc, gc, nph, nt, threads, gx, gy,
                                       gz, smem, stream);
}

// Kernel 12's: four padded (B, Mr, Mc) subbands (A float32, H, V, D bf16
// where det_bf16) -> (B, n_out_r, n_out_c), bf16 where out_bf16
// (separable.cu: inv_level_kernel<S, true, true>); `pad` (6 ints: base, off,
// n_out of the rows, then of the columns), taps, geometry and plan
// (kernels/matmul.py: inv_padded_launch_plan) as pdwt_sep::launch_inv_padded
// takes them.
extern "C" int pdwt_inv_level_2d_mxu_padded(const float* a, const void* h, const void* v,
                                            const void* d, void* out, int B, int Mr, int Mc,
                                            const int* pad, const float* taps, int hlen,
                                            const int* geo, int scheme, int det_bf16,
                                            int out_bf16, int lr, int lc, int nt, int threads,
                                            int gx, int gy, int gz, int smem, void* stream) {
  return pdwt_sep::launch_inv_padded(a, h, v, d, out, B, Mr, Mc, pad, taps, hlen, geo, scheme,
                                     det_bf16, out_bf16, lr, lc, nt, threads, gx, gy, gz, smem,
                                     stream);
}
