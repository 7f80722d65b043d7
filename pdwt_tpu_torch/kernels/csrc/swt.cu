// Stationary (a-trous) 2D wavelet kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py, which
// links this file with the other sources into one library).
//
// The two Pallas kernels of pdwt_tpu/kernels/swt_pallas.py's 2D path:
//
//   swt_fwd_level_kernel  <- _make_swt_fwd_kernel  (swt_pallas.py:95)
//   pdwt_swt_inv_level_2d <- _make_swt_inv_kernel  (swt_pallas.py:231), an entry
//                            point onto swt_matmul.cu's swt_inv_mxu_kernel in fd
//
// Index spec (pdwt_tpu_torch/core/conv.py, the same as pdwt_tpu/core/conv.py),
// per axis, at level L with dilation f = 2^(L-1):
//   analysis   out[n] = sum_j t[j] * x[(n - cen + j*f) mod N],  cen = fwd_center(hlen) * f
//   synthesis  out[n] = sum_band sum_j t_band[j] * x_band[(n - cen + j*f) mod N],
//              cen = swt_inv_center(hlen) * f
// with t the reversed filter (correlation order).  The wrappers compute f and
// cen with those Python helpers and pass them in, and fold the synthesis's
// 1/2 per pass into the inverse's taps, so the kernels hard-code no offset and
// no scale.
//
// Forward.  The dilated support is (hlen-1)*f samples per axis: 13*f for db7,
// 416 at level 6.  A block that staged a square input window would need
// (32 + 13f)^2 floats per plane, past shared memory from f = 8 on.  So a block
// owns 32 consecutive columns (one per lane) and up to TROWS rows of ONE
// residue class mod f (rows rho, rho+f, rho+2f, ...).  Every row tap of those
// rows lands on the same class, so the block stages T + hlen - 1 rows at any f.
// Pass 1 filters along the columns straight from device memory: for tap j a
// warp reads 32 consecutive floats shifted by j*f, coalesced, through the
// read-only path (L1), with the periodic index stepping by f mod C, so any f
// (even one larger than the image) wraps right.  Pass 2 filters along the rows
// from shared memory.  Shared memory: 2 * (T + hlen - 1) * 32 floats, at most
// 40.7 KB (hlen = 128), whatever the level.
//
// Inverse (redesigned for Hopper's CUDA cores).  The exact synthesis with its
// fused soft/hard/garrote threshold is kernel 14's function in the fd scheme
// on float32 subbands: one float32 sum per output, rows then columns, each
// detail thresholded once in float32 as it is staged, with a float32 beta read
// from a device buffer.  So it runs kernel 14's body, which stages halo
// windows of rows of one residue class, sums register-blocked strips
// (band_strip.cuh) and takes its geometry from a launch plan made on the host;
// a body of its own would repeat that code line for line.  The entry point
// below is kept apart so that its wrapper counts its own launches.
//
// Bound: device memory, per level.  The forward reads the image once and
// writes four full-size planes; the inverse reads four planes and writes one.
// The forward's hlen column taps re-read each input element
// hlen * (T + hlen - 1) / T times (about 20x for db7), from L1/L2 rather than
// HBM.

#include <cuda_runtime.h>

#include "mxu_common.cuh"

#define PDWT_MAX_HLEN 128

namespace {

using pdwt_mxu::wrapl;

struct Taps {
  float lo[PDWT_MAX_HLEN];
  float hi[PDWT_MAX_HLEN];
};

constexpr int TX = 32;     // output columns per block, one per lane
constexpr int TY = 8;      // warps per block
constexpr int TROWS = 32;  // most output rows per block, one residue class mod f

// Which rows a block owns: class rho (blockIdx.y % fr), rows
// rho + (q0 + t) * f for t in [0, T), q0 = (blockIdx.y / fr) * T.
struct RowClass {
  int rho, q0;
};

__device__ __forceinline__ RowClass row_class(int fr, int T) {
  return {static_cast<int>(blockIdx.y % fr), static_cast<int>(blockIdx.y / fr) * T};
}

// ---------------------------------------------------------------------------
// Forward level.  Replaces _make_swt_fwd_kernel (swt_pallas.py:95).
// Pass 1, along the columns: lo and hi of each staged row into shared memory.
// Pass 2, along the rows: A = lo rows of lo, H = hi rows of lo, V = lo rows of
// hi, D = hi rows of hi, written once each.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(TX * TY)
swt_fwd_level_kernel(const float* __restrict__ x, float* __restrict__ a,
                     float* __restrict__ h, float* __restrict__ v,
                     float* __restrict__ d, int B, int R, int C, int hlen, int f,
                     int cen, int T, int fr, const __grid_constant__ Taps taps) {
  extern __shared__ float smem[];
  const int S = T + hlen - 1;  // staged rows
  float* s_lo = smem;          // S x TX
  float* s_hi = s_lo + S * TX; // S x TX
  const int tx = threadIdx.x, ty = threadIdx.y;
  const RowClass rc = row_class(fr, T);
  const int c = blockIdx.x * TX + tx;
  // lanes past the last column filter a valid one and store nothing
  const int col0 = wrapl((long long)(c < C ? c : C - 1) - cen, C);
  const int fc = f % C;

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const float* xb = x + (size_t)b * R * C;
    for (int s = ty; s < S; s += TY) {
      const float* row = xb + (size_t)wrapl(rc.rho + (long long)(rc.q0 + s) * f - cen, R) * C;
      float lo = 0.f, hi = 0.f;
      int k = col0;
      for (int j = 0; j < hlen; ++j) {
        const float val = __ldg(row + k);
        lo = fmaf(taps.lo[j], val, lo);
        hi = fmaf(taps.hi[j], val, hi);
        k += fc;
        if (k >= C) k -= C;
      }
      s_lo[s * TX + tx] = lo;
      s_hi[s * TX + tx] = hi;
    }
    __syncthreads();

    for (int t = ty; t < T; t += TY) {
      float aa = 0.f, hh = 0.f, vv = 0.f, dd = 0.f;
      for (int j = 0; j < hlen; ++j) {
        const float l = s_lo[(t + j) * TX + tx];
        const float g = s_hi[(t + j) * TX + tx];
        aa = fmaf(taps.lo[j], l, aa);
        hh = fmaf(taps.hi[j], l, hh);
        vv = fmaf(taps.lo[j], g, vv);
        dd = fmaf(taps.hi[j], g, dd);
      }
      const long long r = rc.rho + (long long)(rc.q0 + t) * f;
      if (r < R && c < C) {
        const size_t o = ((size_t)b * R + r) * C + c;
        a[o] = aa;
        h[o] = hh;
        v[o] = vv;
        d[o] = dd;
      }
    }
    __syncthreads();
  }
}

Taps make_taps(const float* lo, const float* hi, int hlen) {
  Taps t = {};
  for (int i = 0; i < hlen; ++i) {
    t.lo[i] = lo[i];
    t.hi[i] = hi[i];
  }
  return t;
}

// Grid and block geometry of one level: columns in blockIdx.x, (class,
// chunk) in blockIdx.y, batch in blockIdx.z.
struct Geometry {
  dim3 grid;
  int T, fr;
  size_t smem;
};

cudaError_t geometry(int B, int R, int C, int hlen, int f, Geometry* g) {
  if (hlen < 2 || hlen > PDWT_MAX_HLEN || B < 1 || R < 1 || C < 1 || f < 1)
    return cudaErrorInvalidValue;
  const long long nq = (R + (long long)f - 1) / f;  // rows of class 0
  g->fr = f < R ? f : R;
  g->T = nq < TROWS ? static_cast<int>(nq) : TROWS;
  const long long gy = g->fr * ((nq + g->T - 1) / g->T);
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  g->grid = dim3((C + TX - 1) / TX, static_cast<unsigned>(gy), B < 65535 ? B : 65535);
  g->smem = sizeof(float) * 2 * (size_t)(g->T + hlen - 1) * TX;
  return cudaSuccess;
}

}  // namespace

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).
// The forward's `cen` is its dilated center, fwd_center(hlen) * f.

extern "C" int pdwt_swt_fwd_level_2d(const float* x, float* a, float* h, float* v, float* d,
                                     int B, int R, int C, const float* taps_lo,
                                     const float* taps_hi, int hlen, int f, int cen,
                                     void* stream) {
  Geometry g;
  cudaError_t e = geometry(B, R, C, hlen, f, &g);
  if (e != cudaSuccess) return e;
  swt_fwd_level_kernel<<<g.grid, dim3(TX, TY), g.smem, (cudaStream_t)stream>>>(
      x, a, h, v, d, B, R, C, hlen, f, cen, g.T, g.fr, make_taps(taps_lo, taps_hi, hlen));
  return cudaGetLastError();
}

// Kernel 6 runs kernel 14's body (swt_matmul.cu: swt_inv_mxu_kernel) in the fd
// scheme on float32 subbands and a float32 output: see the file's note.
extern "C" int pdwt_swt_inv_level_2d_mxu(const float* a, const void* h, const void* v,
                                         const void* d, void* out, int B, int R, int C,
                                         const float* taps, int hlen, int f, int cen, int scheme,
                                         int det_bf16, int out_bf16, int thresh_mode,
                                         const float* beta, int lr, int lc, int gc, int nph,
                                         int nt, int threads, int gx, int gy, int gz, int smem,
                                         void* stream);

// `taps` is the (4, hlen) float32 device buffer of pdwt_swt_inv_level_2d_mxu in
// the fd scheme (the second values 0); `cen` = swt_inv_center(hlen), in taps;
// thresh_mode: 0 none, 1 soft, 2 hard, 3 garrote of H, V and D with the float at
// `beta` (device memory; unread when thresh_mode is 0); the launch plan is
// kernels/swt_matmul.py:swt_inv_launch_plan's for fd, checked by the entry point.
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
