// Batched 1D wavelet kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (pdwt_tpu_torch/kernels/_build.py, which links this
// file with the other sources into one library).
//
// The entry points of the four Pallas kernels of the batched 1D part of
// pdwt_tpu/kernels/swt_pallas.py:
//
//   fwd_level_1d_kernel      <- _make_1d_fwd_kernel      (swt_pallas.py:395)
//   mxu1d.cu: inv1d_strip_kernel<FD, 2>
//                            <- _make_1d_inv_kernel      (swt_pallas.py:455)
//   mxu1d.cu: fwd1d_strip_kernel<FD, 1>
//                            <- _make_swt1d_fwd_kernel   (swt_pallas.py:528)
//   mxu1d.cu: inv1d_strip_kernel<FD, 1>
//                            <- _make_swt1d_inv_kernel   (swt_pallas.py:593)
//
// The polyphase synthesis (kernel 8) and the a-trous pair (kernels 9 and 10)
// run the bodies of kernels 15 and 16 in the fd scheme on float32 data (see
// their entry points below); the notes on layout and bound here are the
// decimated analysis's, the one body this file still holds.
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
// hard-code no offset and no scale.  Each band's sum runs over its taps in the
// order of the plain version, so the two differ only by FMA contraction.
//
// Layout.  The TPU kernels transpose each tile so that the signal runs along
// sublanes; here the signal axis is contiguous and runs along the lanes, so a
// warp's loads of one tap are 32 neighbouring floats.  A block has NT threads
// laid out TW x RB: TW consecutive output positions (a power of two, 32..NT)
// of each of RB = NT / TW signals, so short signals fill the block with rows
// instead of idling lanes.  The grid is one-dimensional, (signal group, tile)
// flattened, so any batch fits (65 535 caps only gridDim.y and .z); offsets
// into the batch are size_t.
//
// Periodic boundaries are an index mod N at load time; nothing is padded on
// the host, and a support wider than the signal (n = 10 with hlen 16) wraps
// as often as it needs.
//
// Bound: device memory.  Per level the kernel reads its input once and writes
// its output once; the taps' re-reads of neighbouring samples hit shared
// memory, and 2*hlen FMAs per output are cheap beside the bytes.

#include <cuda_runtime.h>

#include "mxu_common.cuh"

#define PDWT_MAX_HLEN 128

namespace {

struct Taps {
  float lo[PDWT_MAX_HLEN];
  float hi[PDWT_MAX_HLEN];
};

constexpr int NT = 256;  // threads per block

__device__ __forceinline__ int wrapl(long long i, int n) {
  const int r = static_cast<int>(i % n);
  return r < 0 ? r + n : r;
}

// The block's signal group and tile: signal row = group * RB + threadIdx.y,
// output position = tile * TW + threadIdx.x.
struct Place {
  long long row;
  int pos0;
};

__device__ __forceinline__ Place place(int ntile) {
  const unsigned g = blockIdx.x / ntile, t = blockIdx.x % ntile;
  return {(long long)g * blockDim.y + threadIdx.y, static_cast<int>(t) * (int)blockDim.x};
}

// ---------------------------------------------------------------------------
// Decimated analysis level.  Replaces _make_1d_fwd_kernel (swt_pallas.py:395).
// Output n reads x[2n - cen + j]: read straight from memory, a warp's load of
// one tap spans 64 floats at stride 2.  So the block stages, for each of its
// rows, the window x[w0 .. w0 + 2*TW + hlen - 2), w0 = 2*pos0 - cen, with
// coalesced loads, split by parity into E[i] = x[w0 + 2i] and O[i] = x[w0 + 2i
// + 1] (the even/odd split of core/conv.py:_fma_analysis).  Tap j = 2a reads
// E[tx + a], tap j = 2a + 1 reads O[tx + a]: consecutive words across the
// warp, free of bank conflicts.  Shared memory: RB * 2 * (TW + ceil(hlen/2))
// floats, at most 6 KB.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
fwd_level_1d_kernel(const float* __restrict__ x, float* __restrict__ lo,
                    float* __restrict__ hi, int B, int N, int hlen, int cen, int ntile,
                    const __grid_constant__ Taps taps) {
  extern __shared__ float smem[];
  const int TW = blockDim.x, tx = threadIdx.x;
  const int S = TW + (hlen + 1) / 2;  // staged samples per parity
  float* E = smem + threadIdx.y * 2 * S;
  float* O = E + S;
  const Place pl = place(ntile);
  const int M = N / 2;
  const bool live = pl.row < B;
  if (live) {
    const float* xr = x + (size_t)pl.row * N;
    const long long w0 = 2LL * pl.pos0 - cen;
    for (int i = tx; i < 2 * S; i += TW) {
      long long k = w0 + i;
      if (k < 0 || k >= N) k = wrapl(k, N);
      (i & 1 ? O : E)[i >> 1] = __ldg(xr + k);
    }
  }
  __syncthreads();
  const int n = pl.pos0 + tx;
  if (!live || n >= M) return;
  float l = 0.f, h = 0.f;
  for (int j = 0; j < hlen; ++j) {
    const float v = (j & 1 ? O : E)[tx + (j >> 1)];
    l = fmaf(taps.lo[j], v, l);
    h = fmaf(taps.hi[j], v, h);
  }
  const size_t o = (size_t)pl.row * M + n;
  lo[o] = l;
  hi[o] = h;
}

Taps make_taps(const float* lo, const float* hi, int hlen) {
  Taps t = {};
  for (int i = 0; i < hlen; ++i) {
    t.lo[i] = lo[i];
    t.hi[i] = hi[i];
  }
  return t;
}

// Block shape and grid for `npos` output positions per signal: TW a power of
// two in [32, NT], RB = NT / TW signals per block, one block per (signal
// group, tile of TW positions).
struct Geometry {
  dim3 grid, block;
  int ntile;
};

cudaError_t geometry(int B, int npos, int hlen, Geometry* g) {
  if (hlen < 2 || hlen > PDWT_MAX_HLEN || B < 1 || npos < 1) return cudaErrorInvalidValue;
  int tw = 32;
  while (tw < NT && tw < npos) tw *= 2;
  const int rb = NT / tw;
  g->ntile = (npos + tw - 1) / tw;
  const long long blocks = (long long)g->ntile * (((long long)B + rb - 1) / rb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  g->grid = dim3(static_cast<unsigned>(blocks));
  g->block = dim3(tw, rb);
  return cudaSuccess;
}

}  // namespace

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).

extern "C" int pdwt_fwd_level_1d(const float* x, float* lo, float* hi, int B, int N,
                                 const float* taps_lo, const float* taps_hi, int hlen,
                                 int cen, void* stream) {
  if (N < 2 || N % 2) return cudaErrorInvalidValue;
  Geometry g;
  cudaError_t e = geometry(B, N / 2, hlen, &g);
  if (e != cudaSuccess) return e;
  const size_t smem = sizeof(float) * g.block.y * 2 * (g.block.x + (hlen + 1) / 2);
  fwd_level_1d_kernel<<<g.grid, g.block, smem, (cudaStream_t)stream>>>(
      x, lo, hi, B, N, hlen, cen, g.ntile, make_taps(taps_lo, taps_hi, hlen));
  return cudaGetLastError();
}

// Kernels 8, 9 and 10 run the bodies of kernels 15 and 16 (mxu1d.cu:
// inv1d_strip_kernel<FD, 2>, fwd1d_strip_kernel<FD, 1>,
// inv1d_strip_kernel<FD, 1>) in the fd scheme on float32 data: every output
// sums the taps in order, each one FMA into one float32 sum per filter (a
// synthesis: the low taps on the low band, then the high taps on the high
// band), as the direct kernels they replace did (the zero taps that pad a
// filter to the strip's chunk, or a parity's table to the common origin,
// leave a finite sum as it is).
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
