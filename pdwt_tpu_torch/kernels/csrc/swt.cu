// Stationary (a-trous) 2D wavelet kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py, which
// links this file with separable.cu into one library).
//
// Two kernels, one per Pallas kernel of pdwt_tpu/kernels/swt_pallas.py:
//
//   swt_fwd_level_kernel  <- _make_swt_fwd_kernel  (swt_pallas.py:95)
//   swt_inv_level_kernel  <- _make_swt_inv_kernel  (swt_pallas.py:231)
//
// Index spec (pdwt_tpu_torch/core/conv.py, the same as pdwt_tpu/core/conv.py),
// per axis, at level L with dilation f = 2^(L-1):
//   analysis   out[n] = sum_j t[j] * x[(n - cen + j*f) mod N],  cen = fwd_center(hlen) * f
//   synthesis  out[n] = sum_band sum_j t_band[j] * x_band[(n - cen + j*f) mod N],
//              cen = swt_inv_center(hlen) * f
// with t the reversed filter (correlation order).  The wrapper computes f and
// cen with those Python helpers and passes them in, and folds the synthesis's
// 1/2 per pass into the inverse's taps, so the kernels hard-code no offset and
// no scale.
//
// Design.  The dilated support is (hlen-1)*f samples per axis: 13*f for db7,
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
// Bound: device memory, per level.  The forward reads the image once and
// writes four full-size planes; the inverse reads four planes and writes one.
// The hlen column taps re-read each input element hlen * (T + hlen - 1) / T
// times (about 20x for db7), from L1/L2 rather than HBM.

#include <cuda_runtime.h>

#include "mxu_common.cuh"

#define PDWT_MAX_HLEN 128

namespace {

using pdwt_mxu::kGarrote;
using pdwt_mxu::kHard;
using pdwt_mxu::kNone;
using pdwt_mxu::kSoft;
using pdwt_mxu::thresh;
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

// ---------------------------------------------------------------------------
// Inverse level.  Replaces _make_swt_inv_kernel (swt_pallas.py:231), whose
// optional soft/hard/garrote threshold of H, V, D with one scalar beta is
// applied here as each detail is read (MODE), so thresholded details never
// reach device memory.  beta is read from a one-float device buffer, so a beta
// computed on the device needs no host round trip.
// The JAX kernel and the plain version synthesise along the rows, then the
// columns; this one runs the same sum along the columns first, so that its
// row pass stays in one residue class (see the file's note):
//   pass 1  u1 = sum_j tl[j] A[., c_j] + th[j] V[., c_j],
//           u2 = sum_j tl[j] H[., c_j] + th[j] D[., c_j],   c_j = c - cen + j*f
//   pass 2  out = sum_i tl[i] u1[r_i, .] + th[i] u2[r_i, .], r_i = r - cen + i*f
// Each of the four terms A, H, V, D meets the same product of a row tap and a
// column tap as in the rows-first order; only the rounding differs.
// ---------------------------------------------------------------------------
template <int MODE>
__global__ void __launch_bounds__(TX * TY)
swt_inv_level_kernel(const float* __restrict__ a, const float* __restrict__ h,
                     const float* __restrict__ v, const float* __restrict__ d,
                     float* __restrict__ out, int B, int R, int C, int hlen, int f,
                     int cen, int T, int fr, const float* __restrict__ beta,
                     const __grid_constant__ Taps taps) {
  extern __shared__ float smem[];
  const int S = T + hlen - 1;
  float* s_u1 = smem;           // S x TX, from (A, V)
  float* s_u2 = s_u1 + S * TX;  // S x TX, from (H, D)
  const int tx = threadIdx.x, ty = threadIdx.y;
  const RowClass rc = row_class(fr, T);
  const int c = blockIdx.x * TX + tx;
  const int col0 = wrapl((long long)(c < C ? c : C - 1) - cen, C);
  const int fc = f % C;
  const float bt = MODE == kNone ? 0.f : __ldg(beta);

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    for (int s = ty; s < S; s += TY) {
      const size_t roff =
          ((size_t)b * R + wrapl(rc.rho + (long long)(rc.q0 + s) * f - cen, R)) * C;
      const float *ar = a + roff, *hr = h + roff, *vr = v + roff, *dr = d + roff;
      float u1 = 0.f, u2 = 0.f;
      int k = col0;
      for (int j = 0; j < hlen; ++j) {
        u1 = fmaf(taps.lo[j], __ldg(ar + k), u1);
        u2 = fmaf(taps.lo[j], thresh(__ldg(hr + k), MODE, bt), u2);
        k += fc;
        if (k >= C) k -= C;
      }
      k = col0;
      for (int j = 0; j < hlen; ++j) {
        u1 = fmaf(taps.hi[j], thresh(__ldg(vr + k), MODE, bt), u1);
        u2 = fmaf(taps.hi[j], thresh(__ldg(dr + k), MODE, bt), u2);
        k += fc;
        if (k >= C) k -= C;
      }
      s_u1[s * TX + tx] = u1;
      s_u2[s * TX + tx] = u2;
    }
    __syncthreads();

    for (int t = ty; t < T; t += TY) {
      float acc = 0.f;
      for (int i = 0; i < hlen; ++i) acc = fmaf(taps.lo[i], s_u1[(t + i) * TX + tx], acc);
      for (int i = 0; i < hlen; ++i) acc = fmaf(taps.hi[i], s_u2[(t + i) * TX + tx], acc);
      const long long r = rc.rho + (long long)(rc.q0 + t) * f;
      if (r < R && c < C) out[((size_t)b * R + r) * C + c] = acc;
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
// `cen` is the dilated center: fwd_center(hlen) * f forward,
// swt_inv_center(hlen) * f inverse.

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

// thresh_mode: 0 none, 1 soft, 2 hard, 3 garrote of H, V and D with the float
// at `beta` (device memory; unread when thresh_mode is 0).
extern "C" int pdwt_swt_inv_level_2d(const float* a, const float* h, const float* v,
                                     const float* d, float* out, int B, int R, int C,
                                     const float* taps_lo, const float* taps_hi, int hlen,
                                     int f, int cen, int thresh_mode, const float* beta,
                                     void* stream) {
  Geometry g;
  cudaError_t e = geometry(B, R, C, hlen, f, &g);
  if (e != cudaSuccess) return e;
  if (thresh_mode != kNone && beta == nullptr) return cudaErrorInvalidValue;
  const Taps taps = make_taps(taps_lo, taps_hi, hlen);
  const dim3 block(TX, TY);
  cudaStream_t st = (cudaStream_t)stream;
  switch (thresh_mode) {
    case kNone:
      swt_inv_level_kernel<kNone><<<g.grid, block, g.smem, st>>>(
          a, h, v, d, out, B, R, C, hlen, f, cen, g.T, g.fr, beta, taps);
      break;
    case kSoft:
      swt_inv_level_kernel<kSoft><<<g.grid, block, g.smem, st>>>(
          a, h, v, d, out, B, R, C, hlen, f, cen, g.T, g.fr, beta, taps);
      break;
    case kHard:
      swt_inv_level_kernel<kHard><<<g.grid, block, g.smem, st>>>(
          a, h, v, d, out, B, R, C, hlen, f, cen, g.T, g.fr, beta, taps);
      break;
    case kGarrote:
      swt_inv_level_kernel<kGarrote><<<g.grid, block, g.smem, st>>>(
          a, h, v, d, out, B, R, C, hlen, f, cen, g.T, g.fr, beta, taps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
