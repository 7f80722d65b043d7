// Register-blocked band sums for the kernels redesigned for Hopper's CUDA
// cores: the banded-product inverses (swt_matmul.cu's swt_inv_mxu_kernel,
// ns_matmul.cu's ns_inv_mxu_kernel, mxu1d.cu's inv1d_strip_kernel), the
// banded-product analyses (swt_matmul.cu's swt_fwd_mxu_kernel, kernel 13,
// in fd the exact kernel 5 and, at output step 2, kernel 11 and in fd the
// exact kernel 1; mxu1d.cu's fwd1d_strip_kernel, kernel 15 and, in fd, the
// exact kernels 7 and 9; ns_matmul.cu's ns_fwd_mxu_kernel) and the
// polyphase inverse of separable.cu (the exact kernel 2 and, in the tiers'
// schemes, kernel 12); and the tails (kernels 3 and 4), which run the work
// of kernels 1 and 2 level by level in one launch over a thread-block
// cluster (launch_clusters, below).
//
// A thread computes a strip of P outputs of one filtered line (along the
// window's rows or columns, at a step xs between samples; OS samples apart,
// 2 for a decimated analysis), for R sums at once that read the same data,
// each sum over `nbands` staged bands of CH-padded taps.  It slides a
// register window over the line: a chunk of CH taps loads OS (P - 1) + CH
// samples once and CH taps per sum as float4 broadcasts, then does
// R * CH * P multiply-adds (fully unrolled), so a
// shared-memory load feeds 2.7 (P = 8, CH = 4, R = 1) to 9 (R = 3, CH = 8)
// multiply-adds.  Each output keeps one float32 sum per scheme term (Acc), in
// the plain version's order: band outer, tap inner; the zero taps that pad a
// filter to CH leave every sum as it is (0 * x + s = s for finite x).
//
// The tables below let the staging index its window with one 32-bit add per
// sample: the wrapped global row and column of each window entry are computed
// once per block.
//
// Why the CUDA cores and not the tensor cores: the fd scheme is a float32 x
// float32 sum (TF32 keeps 10 mantissa bits), a tensor-core product reorders
// each output's float32 sum (the b-schemes would no longer match their plain
// versions bit for bit), and at the float32 rate the arithmetic of these
// passes already fits inside their bytes bound; what bounds them is the
// staging and the shared-memory traffic around each multiply-add.

#pragma once

#include <utility>

#include "mxu_common.cuh"

namespace pdwt_strip {

using namespace pdwt_mxu;

// Does the scheme read the taps' second value?
template <int S>
constexpr bool kTapLo = (S == B2F || S == B3);

// Strip length of the passes that read the staged bands: 8 outputs for the
// one-term schemes, 4 for the others (their accumulators take 2-3x the
// registers).  The launch plans in kernels/swt_matmul.py, kernels/ns_matmul.py
// and kernels/mxu1d.py mirror it (kernels/_launch.py: ROW_STRIP).
template <int S>
constexpr int kRowStrip = (S == FD || S == B1) ? 8 : 4;
constexpr int kColStrip = 8;

// acc[k][p] += sum_b sum_j t[k][b][j] * x_b[(OS p + j) * xs], for p < P,
// k < R, b < nbands, j < nt (a multiple of CH): x_b = x + b * bstride (its
// second operand lo_off further on), t[k][b] = t1 + k * kstride + b * nt
// (16-byte aligned; the second values at the same offset of t2).
template <int S, int P, int R, int CH, int OS = 1, typename St>
__device__ __forceinline__ void band_strip(Acc<S> (&acc)[R][P], const St* __restrict__ x,
                                           int lo_off, int bstride, int nbands, int xs,
                                           const float* __restrict__ t1,
                                           const float* __restrict__ t2, int kstride, int nt) {
  static_assert(CH % 4 == 0, "taps are read as float4");
  constexpr int ND = OS * (P - 1) + CH;  // samples a chunk reads
  for (int b = 0; b < nbands; ++b) {
    const St* xb = x + b * bstride;
    for (int c = 0; c < nt; c += CH) {
      float d1[ND], d2[ND];
      const St* xc = xb + c * xs;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        d1[i] = to_f(xc[i * xs]);
        d2[i] = kDataLo<S> ? to_f(xc[lo_off + i * xs]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float ta[CH], tb[CH];
        const int o = k * kstride + b * nt + c;
#pragma unroll
        for (int q = 0; q < CH / 4; ++q) {
          const float4 u = reinterpret_cast<const float4*>(t1 + o)[q];
          ta[4 * q] = u.x, ta[4 * q + 1] = u.y, ta[4 * q + 2] = u.z, ta[4 * q + 3] = u.w;
          if constexpr (kTapLo<S>) {
            const float4 w = reinterpret_cast<const float4*>(t2 + o)[q];
            tb[4 * q] = w.x, tb[4 * q + 1] = w.y, tb[4 * q + 2] = w.z, tb[4 * q + 3] = w.w;
          } else {
            tb[4 * q] = tb[4 * q + 1] = tb[4 * q + 2] = tb[4 * q + 3] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < CH; ++j)
#pragma unroll
          for (int p = 0; p < P; ++p)
            acc[k][p].add(ta[j], tb[j], d1[OS * p + j], d2[OS * p + j]);
      }
    }
  }
}

// tab[w] = (base + step * w) mod n for w < nw: two 64-bit remainders per
// thread, then a 32-bit one per entry.
__device__ __forceinline__ void fill_index(int* tab, int nw, long long base, long long step,
                                           int n) {
  const unsigned long long b0 = wrapl(base, n), s = wrapl(step, n);
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    const unsigned long long x = b0 + s * w;
    tab[w] = x >> 32 ? (int)(x % n) : (int)((unsigned)x % (unsigned)n);
  }
}

// The padded entry points (kernels 1, 2, 7 and 8 on a boundary mode) read
// the array the caller extended or padded and never wrap: tab[w] = base +
// step * w, clamped into [0, n).  A clamped entry feeds only outputs that
// the launch does not store (the entry points refuse a plan whose stored
// outputs would read outside the input), so every load stays inside it.
__device__ __forceinline__ void fill_clamped(int* tab, int nw, long long base, long long step,
                                             int n) {
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    const long long x = base + step * w;
    tab[w] = x < 0 ? 0 : (x >= n ? n - 1 : (int)x);
  }
}

// The index table of a periodic launch (mod n) or, where PAD, of a padded
// one: a compile-time choice, so the periodic instances keep their code.
template <bool PAD>
__device__ __forceinline__ void fill_table(int* tab, int nw, long long base, long long step,
                                           int n) {
  if constexpr (PAD)
    fill_clamped(tab, nw, base, step, n);
  else
    fill_index(tab, nw, base, step, n);
}

// One axis of a padded polyphase synthesis (kernels 2 and 8 on a boundary
// mode): stored output i (< n_out) is the periodic body's output t = i +
// off (off 0 or 1), t = 2m + q summing the coefficients base + m + o_q + b
// (b < nb_q) of the array it is given, with no wrap.  kernels/_launch.py:
// pad_axis makes it from the synthesis's offset in the zero-stuffed domain.
struct PadAxis {
  int base, off, n_out;
};

// Do the stored outputs of a padded synthesis read inside the n
// coefficients of their axis?  (tests/test_torch_modes_kernels.py holds a
// model of it to core/conv.py: check_padded_synthesis, which the wrappers
// run first.)
inline bool pad_axis_ok(const PadAxis& p, const Poly& g, int n) {
  if (p.off < 0 || p.off > 1 || p.n_out < 1) return false;
  for (int q = 0; q < 2; ++q) {
    const long long last = (long long)p.off + p.n_out - 1 - q;  // the last t of parity q, less q
    if (last < 0) continue;
    const long long m0 = (p.off - q + 1) / 2, m1 = last / 2;
    if (m1 < m0) continue;
    if (p.base + m0 + g.o[q] < 0 || p.base + m1 + g.o[q] + g.nb[q] - 1 > (long long)n - 1)
      return false;
  }
  return true;
}

// The positions a padded synthesis's grid covers along one axis: t up to
// off + n_out - 1, two outputs a position.
inline long long pad_positions(const PadAxis& p) { return ((long long)p.off + p.n_out + 1) / 2; }

// dst[e] = src[idx(e)] (0 where idx(e) < 0) for e < n, around `work`: the
// loads of the first blockDim.x values are issued before work() runs and
// stored after it, so their latency hides behind it (the taps, behind the
// first staging).
template <typename I, typename W>
__device__ __forceinline__ void fill_around(float* dst, int n, const float* __restrict__ src,
                                            I idx, W work) {
  const int e0 = threadIdx.x, i0 = e0 < n ? idx(e0) : -1;
  const float v0 = i0 >= 0 ? __ldg(src + i0) : 0.f;
  work();
  if (e0 < n) dst[e0] = v0;
  for (int e = e0 + blockDim.x; e < n; e += blockDim.x) {
    const int i = idx(e);
    dst[e] = i >= 0 ? __ldg(src + i) : 0.f;
  }
}

// The index in a (4, hlen) taps buffer (the low filter's first and second
// values, then the high filter's) of entry e of the shared arrays
// [lo1 | hi1] [lo2 | hi2], nt taps each; -1 (a zero tap) past hlen.
__device__ __forceinline__ int dual_tap(int e, int nt, int hlen) {
  const int k = e % nt, u = e / nt;  // u: lo1, hi1, lo2, hi2
  return k < hlen ? ((u & 1) * 2 + (u >> 1)) * hlen + k : -1;
}

// Sources of up to four bands, float32 or bf16 (bit k of `bf16` set: band k
// is bf16); passed by value, so an unrolled band index stays in registers.
// Built from constant flags at the call site (one inlined staging per
// storage type), the type test folds away; a flag known only at run time is
// tested at every load and keeps fewer loads in flight (it cost kernels 2,
// 10 and 16 5-16 % on an H100, PERF.md section 6).
struct Bands {
  const void* p[4];
  unsigned bf16;
};

// Bit k of CG set: band k is float32 that this launch wrote before a
// barrier (the tails' approximation chain), read with a coherent load
// (ld.global.cg, cached in L2 only); the others go through the read-only
// path (__ldg, ld.global.nc), valid only for data no thread of the launch
// writes.  A template argument, so the level kernels' stagings are the
// same code as without it.
template <unsigned CG = 0>
__device__ __forceinline__ float load_band(const Bands& b, int k, size_t o) {
  if (CG >> k & 1) return __ldcg(static_cast<const float*>(b.p[k]) + o);
  return (b.bf16 >> k & 1) ? load_f(static_cast<const __nv_bfloat16*>(b.p[k]) + o)
                           : load_f(static_cast<const float*>(b.p[k]) + o);
}

// Stage the nr x nc windows of NB bands at dst + k * bstride (row-major,
// pitch nc, or `pitch` where given; second operand lo_off further on):
// sample (i, w) of band k =
// src_k[rowoff + rows[i] * n_c + cols[w]], thresholded first where bit k of
// `thr` is set.  Lanes run along the window's columns, so a warp reads
// consecutive addresses where the columns are; each thread issues LOADS
// loads before it uses one, so the staging pays the memory latency once per
// batch, not once per sample.
template <int S, int NB, int LOADS, unsigned CG = 0, typename St>
__device__ __forceinline__ void stage_bands(const Bands src, unsigned thr, size_t rowoff, int n_c,
                                            const int* rows, const int* cols, int nr, int nc,
                                            St* dst, int bstride, int lo_off, int mode,
                                            float beta, int pitch = 0) {
  constexpr int U = LOADS / NB;
  const int pt = pitch ? pitch : nc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int w = lane; w < nc; w += 32) {
    const int cw = cols[w];
    for (int i0 = warp; i0 < nr; i0 += nw * U) {
      float v[NB][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * nw;
        const size_t o = rowoff + (size_t)rows[i < nr ? i : nr - 1] * n_c + cw;
#pragma unroll
        for (int k = 0; k < NB; ++k) v[k][u] = load_band<CG>(src, k, o);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * nw;
        if (i >= nr) break;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          const float x = (thr >> k & 1) ? thresh(v[k][u], mode, beta) : v[k][u];
          St* d = dst + k * bstride;
          stage<S>(x, d, d + lo_off, i * pt + w);
        }
      }
    }
  }
}

// Stage the nr x nc windows of NB bands at dst + k * bstride (pitch `pitch`,
// second operand lo_off further on): sample (i, w) of band k =
// src_k[row_base(i) + cols[w]], split per scheme.  Lanes run along the
// window's columns and warps along its rows; each thread issues NB x UR x UW
// loads (rows nw apart, columns 32 apart, those past the window's edge
// clamped onto it and not stored) before it stores one, so a window of up
// to nw UR rows by 32 UW columns costs one round trip to memory.
template <int S, int NB, int UR, int UW, unsigned CG = 0, typename St, typename FR>
__device__ __forceinline__ void stage_window(const Bands& src, FR row_base, const int* cols,
                                             int nr, int nc, St* dst, int pitch, int bstride,
                                             int lo_off) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i0 = warp; i0 < nr; i0 += nw * UR) {
    for (int w0 = lane; w0 < nc; w0 += 32 * UW) {
      float v[NB][UR][UW];
#pragma unroll
      for (int a = 0; a < UR; ++a) {
        const int i = i0 + a * nw;
        const size_t rb = row_base(i < nr ? i : nr - 1);
#pragma unroll
        for (int c = 0; c < UW; ++c) {
          const int w = w0 + 32 * c;
          const size_t o = rb + cols[w < nc ? w : nc - 1];
#pragma unroll
          for (int k = 0; k < NB; ++k) v[k][a][c] = load_band<CG>(src, k, o);
        }
      }
#pragma unroll
      for (int a = 0; a < UR; ++a) {
#pragma unroll
        for (int c = 0; c < UW; ++c) {
          const int i = i0 + a * nw, w = w0 + 32 * c;
          if (i >= nr || w >= nc) continue;
#pragma unroll
          for (int k = 0; k < NB; ++k) {
            St* d = dst + k * bstride;
            stage<S>(v[k][a][c], d, d + lo_off, i * pitch + w);
          }
        }
      }
    }
  }
}

// A store_tile callback that does nothing.
struct NoSeen {
  __device__ __forceinline__ void operator()(float) const {}
};

// A store_tile map that stores each tile value as it is.
struct AsIs {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};

// Copy an nr x nc float tile (pitch `pitch`) to the output rows orow(i) and
// columns ocol(u) where they fall inside (n_r, n_c); lanes along the columns.
// map(v) is stored in place of each tile value v, and seen(v) is called
// with each value stored, by the thread that stores it.
template <typename TO, typename FR, typename FC, typename FV = NoSeen, typename FM = AsIs>
__device__ __forceinline__ void store_tile(TO* __restrict__ out, size_t plane, int n_r, int n_c,
                                           const float* ob, int pitch, int nr, int nc, FR orow,
                                           FC ocol, FV seen = {}, FM map = {}) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < nr; i += nw) {
    const long long r = orow(i);
    if (r >= n_r) continue;
    TO* dst = out + plane + (size_t)r * n_c;
    for (int u = lane; u < nc; u += 32) {
      const long long c = ocol(u);
      if (c < n_c) {
        const float v = map(ob[i * pitch + u]);
        dst[c] = from_f<TO>(v);
        seen(v);
      }
    }
  }
}

// Pitch of a temp read by lanes along its rows: an odd number of 32-bit
// words, so the lanes fall on distinct banks.
template <typename St>
__host__ __device__ constexpr int temp_pitch(int w) {
  if constexpr (sizeof(St) == 4) return w | 1;
  return ((w + 1) / 4) * 4 + 2;  // w <= pitch, pitch = 2 mod 4
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Does a launch plan's grid cover (R, C) positions (B planes) at dilation f
// with lr x lc tiles, rows of one residue class and columns consecutive (gc
// = 1) or of one class (gc = f)?
inline bool grid_fits(int B, int R, int C, int f, int lr, int lc, int gc, int gx, int gy,
                      int gz) {
  const long long want_x = gc == 1 ? (C + (long long)lc - 1) / lc : axis_blocks(C, f, lc);
  return gx == want_x && gy == axis_blocks(R, f, lr) && gy <= 65535 &&
         gz == (B < 65535 ? B : 65535);
}

// The fused deep levels of the 2D DWT (the tails, kernels 3 and 4): one
// launch of B * nb blocks, nb per batch item; where it runs more than one
// level, the nb blocks of an item form one thread-block cluster (cs = nb)
// and meet at a cluster barrier between levels.  Per level (in launch
// order): the three detail planes and the tile (lr x lc positions, nph
// output phases of the analysis) that the item's blocks share, tile k on
// block k mod nb.  kernels/separable.py: tail_launch_plan makes the plan.
#define PDWT_MAX_TAIL_LEVELS 16

struct TailTile {
  int lr, lc, nph;
};

struct TailArgs {
  void* det[3 * PDWT_MAX_TAIL_LEVELS];
  TailTile tile[PDWT_MAX_TAIL_LEVELS];
};

// Is cs a cluster size the tails take, and does the plan put an item's
// blocks in one cluster where levels meet at a barrier?
inline bool tail_grid_ok(int B, int levels, int nb, int cs, int threads) {
  return (cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == 16) && nb >= 1 &&
         cs == (levels == 1 ? 1 : nb) && (long long)B * nb < (1LL << 31) && threads >= 32 &&
         threads <= 256 && threads % 32 == 0;
}

// Launch `kernel` on `grid` blocks of `threads` in clusters of cs along x
// (cudaLaunchKernelEx; a cluster of more than 8 needs the non-portable
// opt-in).  A plan the card cannot hold (no cluster of cs blocks with this
// shared memory fits: cudaOccupancyMaxActiveClusters) is refused with
// cudaErrorInvalidValue; nothing falls back to a smaller cluster.
template <typename... KArgs, typename... Args>
cudaError_t launch_clusters(void (*kernel)(KArgs...), int grid, int threads, size_t smem, int cs,
                            void* stream, Args&&... args) {
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  if (cs > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (fit < 1) return cudaErrorInvalidValue;
  e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace pdwt_strip
