// The 2D a-trous level kernels of the precision tiers for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py
// links this file with the other sources into one library).
//
// Two kernels, one per Pallas kernel of pdwt_tpu/kernels/swt_matmul_pallas.py:
//
//   swt_fwd_mxu_kernel  <- _swt_fwd_mxu_kernel  (swt_matmul_pallas.py:166)
//   swt_inv_mxu_kernel  <- _swt_inv_mxu_kernel  (swt_matmul_pallas.py:293)
//
// The forward's per-tile work (fwd_tile) is templated on its output step:
// at step 2 and dilation 1 it is also the tiers' decimated 2D analysis
// (kernel 11, _fwd_mxu_kernel of matmul_pallas.py:242), reached through
// matmul.cu's entry point.  In the fd scheme on float32 data the forward at
// step 1 is also the exact a-trous analysis (kernel 5) and the inverse the
// exact synthesis (kernel 6), reached through swt.cu's entry points; the
// forward at step 2 is the exact decimated analysis (kernel 1,
// _make_fwd_kernel of separable_pallas.py:234) and, level by level in one
// launch spread over a thread-block cluster, the forward tail (kernel 3,
// fwd_tail_kernel below, _make_tail_fwd_kernel of separable_pallas.py:576),
// both reached through separable.cu's entry points.
//
// On the TPU each pass of a stationary level is a banded matrix product on the
// MXU whose band has stride f = 2^(level-1), in a compute scheme (b1, fd, b2f,
// b2d, b3; mxu_common.cuh states each).  Here the band is evaluated directly on
// the CUDA cores: every output sums only its hlen non-zero taps, with the
// operands rounded per scheme as they are staged in shared memory.  The index
// spec is core/conv.py's, as in swt.cu, per axis:
//   analysis   out[n] = sum_j t[j] * x[(n + (j - cen) f) mod N],  cen = fwd_center(hlen)
//   synthesis  out[n] = sum_band sum_j t_band[j] * x_band[(n + (j - cen) f) mod N],
//              cen = swt_inv_center(hlen), the 1/2 per pass folded into the taps
// The order of the passes is the TPU kernels': the forward runs along the rows
// (axis -2) first, then the columns (A @ x, then t @ B); the inverse
// synthesises along the rows (A, H) and (V, D) into two temps, then along the
// columns.  The float32 row-pass result is split per scheme before the column
// pass (for b1 and b2f rounded to bf16), so the order shows at bf16 level.
// The fused threshold of the inverse (soft, hard, garrote; one beta read from
// a device buffer) is applied in float32 to each staged detail before its
// split, as the TPU kernel's det() does (swt_matmul_pallas.py:335-342).
//
// Layout.  Both kernels are redesigned for Hopper's CUDA cores on
// band_strip.cuh: a block owns a tile of rows of one residue class mod f by
// consecutive columns (or one residue class where a consecutive window would
// grow more than 1.4x), so the staged windows do not grow with the level and
// any size and dilation runs; register-blocked strips; the taps from a small
// device buffer, read around the first staging; and a launch plan from the
// host (kernels/swt_matmul.py), which the entry point checks.  Each kernel's
// own comment below says how it runs.
//
// Bound.  At 1024^2 a level reads one image and writes four planes (forward)
// or the reverse: 4.2 MiB of bf16 in and 4 MiB of float32 plus 6 MiB of bf16
// out at level 1 (about 4 us at 3.35 TB/s); db7's six passes of 14 taps over
// a 1024^2 plane are 88 M multiply-adds per term, 0.18 GFLOP per level and
// term, 3 us for b1 and up to 8 us for b3 on the float32 cores: the level is
// close to balanced, and the staging matters as much as the sums.  Each input
// sample is staged once per window and split then, never per tap; the
// row-pass temps never leave shared memory.

#include <cooperative_groups.h>

#include "band_strip.cuh"

namespace {

using namespace pdwt_mxu;
using namespace pdwt_strip;

// ---------------------------------------------------------------------------
// Forward level, output step OS: 1 (a-trous, dilation f) or 2 (decimated, f
// = 1).  Replaces _swt_fwd_mxu_kernel (swt_matmul_pallas.py:166) at OS = 1
// and, through matmul.cu's entry point, _fwd_mxu_kernel
// (matmul_pallas.py:242) at OS = 2 (in fd, through separable.cu's,
// _make_fwd_kernel of separable_pallas.py:234): the same sums in the same
// order (rows
// first, both filters from one read, the row-pass result split per scheme,
// then the columns), at another step between outputs.  Redesigned for
// Hopper's CUDA cores (band_strip.cuh), as the inverse below and the rank-r
// analysis (ns_matmul.cu), in this kernel's pass order: rows first.  A block
// owns lr output rows of one residue class mod f (window row i <-> input row
// OS (rho + f q0) + (i - cen) f, dilation 1 inside the window) by lc output
// columns, consecutive (gc = 1: a tap steps dc = f window columns; always at
// OS = 2) or one residue class (gc = f, dc = 1, where a consecutive window
// would grow more than 1.4x).  Per batch item: stage the input window (WR =
// OS (lr - 1) + nt rows by WC = OS (lc - 1) + (nt - 1) dc + 1 columns,
// wrapped through 32-bit index tables, up to 18 loads per thread in flight,
// split into the scheme's operands; one staging per input type, the type a
// constant in each: band_strip.cuh, Bands); along the rows, each thread
// takes a strip of kRowStrip output rows (OS window rows apart) of one
// window column, lanes along the columns, and sums the low and the high
// filter from one read of each sample (R = 2) into two shared temps, split
// again; along the columns, each thread takes a strip of kColStrip outputs
// dc apart (reading temp columns OS dc apart) of one temp row, lanes along
// the rows (the temps' pitches are odd numbers of words), and sums both
// filters on the low temp (A, V) and on the high temp (H, D) into float
// tiles in the window's place, written out with lanes along the columns:
// all four at once (nph = 1) or (A, V) then (H, D) when shared memory is
// short (nph = 2, half the tiles).  Every output keeps one float32 sum per
// scheme term in the plain version's order: taps in order, the row-pass
// result split in between.  The taps (the (4, hlen) device buffer) are
// padded with zeros to nt, a multiple of 8, and read around the first
// staging.  The plans (kernels/swt_matmul.py: swt_fwd_launch_plan at OS =
// 1; kernels/matmul.py: fwd_launch_plan at OS = 2) pick the tile so that the deep levels and
// small images still fill the card, and the launcher refuses a plan that
// does not add up.
// ---------------------------------------------------------------------------
constexpr int kFwdCh = 8;  // taps per chunk of the forward's strips

// Shared-memory bytes of the forward at output step os: taps, index tables,
// the window (which holds the 4 / nph output tiles once the row pass is
// done), the two temps.  kernels/_launch.py:fwd_smem mirrors it.
template <int S>
size_t fwd_smem(int os, int lr, int lc, int dc, int nt, int nph) {
  using St = Stage<S>;
  const size_t nd = kDataLo<S> ? 2 : 1;
  const size_t WR = (size_t)os * (lr - 1) + nt;
  const size_t WC = (size_t)os * (lc - 1) + (size_t)(nt - 1) * dc + 1;
  const size_t win = nd * WR * WC * sizeof(St);
  const size_t tile = (4 / nph) * (size_t)lr * (lc + 1) * sizeof(float);
  return 16 * (size_t)nt + align16((WR + WC) * sizeof(int)) + align16(win > tile ? win : tile) +
         2 * nd * lr * temp_pitch<St>((int)WC) * sizeof(St);
}

// Geometry of one tile of the forward: an R x C input (plane), (R / OS) x
// (C / OS) outputs (Ro x Co in a padded launch), lr x lc of them in the
// tile at rows rho_r + f (q0r + i) and columns rho_c + gc (q0c + u).
struct FwdTile {
  int R, C, hlen, f, cen, lr, lc, gc, nph, nt;
  int rho_r, q0r, rho_c, q0c;
  int Ro, Co;  // read where PAD only
};

// One tile of one batch item, the per-tile work of the level kernel below
// and of the forward tail: fill the index tables, stage the window
// (stage_src(rows, cols, WR, WC, win) reads it from the input; the taps
// are read around it where load_taps), the row pass, the column pass,
// store the tiles (output plane offset oplane; A float32, H, V, D bf16
// where det_bf16).  Ends at a block barrier, so the next call may reuse
// the shared memory; the taps at its start stay.  PAD (kernel 1's padded
// entry point): the index tables do not wrap (band_strip.cuh: fill_table)
// and the outputs are Ro x Co.  NM (kernel 5's norm launches, float32
// details: soft, hard or garrote; kNone otherwise): each thread also adds to
// *nsum the term
// (thresh_l1<NM> at nrm's beta; |A| where nrm.approx) of every value it
// stores, so the sum counts each stored output once and nothing store_tile
// skips.
template <int S, int OS, bool PAD = false, int NM = kNone, typename SW>
__device__ __forceinline__ void fwd_tile(unsigned char* smem_raw, const FwdTile& g,
                                         const float* __restrict__ taps, bool load_taps,
                                         SW stage_src, float* a, void* h, void* v, void* d,
                                         int det_bf16, size_t oplane, NormOut nrm = {},
                                         float* nsum = nullptr) {
  using St = Stage<S>;
  constexpr int nd = kDataLo<S> ? 2 : 1;
  // at step 2 the column strips of the two- and three-term schemes hold
  // kRowStrip outputs: eight of them took b3 to 216 registers (one block an
  // SM) and 20-30 % more time on an H100 (PERF.md, section 6)
  constexpr int PR = kRowStrip<S>, PC = OS == 2 ? kRowStrip<S> : kColStrip;
  const int R = g.R, C = g.C, f = g.f, lr = g.lr, lc = g.lc, gc = g.gc, nph = g.nph, nt = g.nt;
  const int Ro = PAD ? g.Ro : R / OS, Co = PAD ? g.Co : C / OS, dc = f / gc;
  const int WR = OS * (lr - 1) + nt, WC = OS * (lc - 1) + (nt - 1) * dc + 1;
  const int TP = temp_pitch<St>(WC), OP = lc + 1;
  float* t1 = reinterpret_cast<float*>(smem_raw);  // lo | hi, first values
  float* t2 = t1 + 2 * nt;                          // second values
  int* rows = reinterpret_cast<int*>(t2 + 2 * nt);
  int* cols = rows + WR;
  unsigned char* p = smem_raw + 16 * (size_t)nt + align16((size_t)(WR + WC) * sizeof(int));
  St* win = reinterpret_cast<St*>(p);  // WR x WC, second operand WR * WC further on
  float* tile = reinterpret_cast<float*>(p);  // 4 / nph tiles of lr x OP, after the row pass
  const size_t wbytes = (size_t)nd * WR * WC * sizeof(St);
  const size_t tbytes = (size_t)(4 / nph) * lr * OP * sizeof(float);
  St* tmp = reinterpret_cast<St*>(p + align16(wbytes > tbytes ? wbytes : tbytes));
  const int TS = nd * lr * TP;  // temp stride: the low temp, then the high one

  // window column w <-> input column OS (rho_c + gc q0c) - cen f + gc w
  fill_table<PAD>(rows, WR, OS * (g.rho_r + (long long)f * g.q0r) - (long long)g.cen * f, f, R);
  fill_table<PAD>(cols, WC, OS * (g.rho_c + (long long)gc * g.q0c) - (long long)g.cen * f, gc, C);
  __syncthreads();
  auto tap = [&](int e) { return dual_tap(e, nt, g.hlen); };
  auto stage_win = [&] { stage_src(rows, cols, WR, WC, win); };
  if (load_taps)
    fill_around(t1, 4 * nt, taps, tap, stage_win);
  else
    stage_win();
  __syncthreads();
  // along the rows: window column w, output rows r0 + q (q < PR), both filters
  for (int it = threadIdx.x; it < (lr / PR) * WC; it += blockDim.x) {
    const int r0 = (it / WC) * PR, w = it % WC;
    Acc<S> acc[2][PR];
    band_strip<S, PR, 2, kFwdCh, OS>(acc, win + OS * r0 * WC + w, WR * WC, 0, 1, WC, t1, t2, nt,
                                     nt);
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int q = 0; q < PR; ++q)
        stage<S>(acc[k][q].total(), tmp + k * TS, tmp + k * TS + lr * TP, (r0 + q) * TP + w);
  }
  __syncthreads();
  // along the columns: temp row r, outputs t0 + dc q (q < PC), filter k on
  // temp u gives output u + 2k (A, H, V, D), in tile u + 2k (nph = 1) or k
  // (nph = 2, phase u)
  void* outs[4] = {a, h, v, d};
  for (int ph = 0; ph < nph; ++ph) {
    for (int it = threadIdx.x; it < lr * (lc / PC); it += blockDim.x) {
      const int r = it % lr, s = it / lr, t0 = s % dc + dc * (s / dc) * PC;
      for (int u = ph; u < 2; u += nph) {
        Acc<S> acc[2][PC];
        band_strip<S, PC, 2, kFwdCh, OS>(acc, tmp + u * TS + r * TP + OS * t0, lr * TP, 0, 1,
                                         dc, t1, t2, nt, nt);
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int q = 0; q < PC; ++q)
            tile[((nph == 1 ? u + 2 * k : k) * lr + r) * OP + t0 + dc * q] = acc[k][q].total();
      }
    }
    __syncthreads();
    auto orow = [&](int i) { return g.rho_r + (long long)f * (g.q0r + i); };
    auto ocol = [&](int u) { return g.rho_c + (long long)gc * (g.q0c + u); };
    for (int t = 0; t < 4 / nph; ++t) {
      const int o = nph == 1 ? t : ph + 2 * t;
      const float* tt = tile + t * lr * OP;
      if constexpr (NM != kNone) {
        const float b = __ldg(nrm.beta), b2 = b * b;
        float s = 0.f;
        if (o > 0)
          store_tile(static_cast<float*>(outs[o]), oplane, Ro, Co, tt, OP, lr, lc, orow, ocol,
                     [&](float x) { s += thresh_l1<NM>(x, b, b2); });
        else if (nrm.approx)
          store_tile(a, oplane, Ro, Co, tt, OP, lr, lc, orow, ocol,
                     [&](float x) { s += fabsf(x); });
        else
          store_tile(a, oplane, Ro, Co, tt, OP, lr, lc, orow, ocol);
        *nsum += s;
      } else if (o == 0) {
        store_tile(a, oplane, Ro, Co, tt, OP, lr, lc, orow, ocol);
      } else if (det_bf16) {
        store_tile(static_cast<__nv_bfloat16*>(outs[o]), oplane, Ro, Co, tt, OP, lr, lc, orow,
                   ocol);
      } else {
        store_tile(static_cast<float*>(outs[o]), oplane, Ro, Co, tt, OP, lr, lc, orow, ocol);
      }
    }
    __syncthreads();
  }
}

// R x C is the input, (R / OS) x (C / OS) each output.  NM (kernel 5's norm
// launches, fd at step 1 only, the threshold mode; `nrm` unread at kNone):
// every thread sums the terms of what it stores over the block's batch
// items, and the block reduces the sums (warp shuffles, then shared memory)
// to one float32 partial in its own slot of nrm.partials.  Each slot is
// written by one block and nothing else, so no atomics and the same sum
// every call.
template <int S, int OS, int NM = kNone>
__global__ void __launch_bounds__(256)
swt_fwd_mxu_kernel(const void* __restrict__ x, float* __restrict__ a, void* __restrict__ h,
                   void* __restrict__ v, void* __restrict__ d, int in_bf16, int det_bf16, int B,
                   int R, int C, int hlen, int f, int cen, const float* __restrict__ taps, int lr,
                   int lc, int gc, int nph, int nt, const NormOut nrm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Ro = R / OS, Co = C / OS;
  const int frr = f < Ro ? f : Ro, frc = gc == 1 ? 1 : (f < Co ? f : Co);
  const FwdTile g = {R,  C,  hlen, f,  cen, lr, lc, gc, nph, nt, (int)(blockIdx.y % frr),
                     (int)(blockIdx.y / frr) * lr, (int)(blockIdx.x % frc),
                     (int)(blockIdx.x / frc) * lc};
  float s = 0.f;  // NM: this thread's sum of the terms of what it stored
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const size_t plane = (size_t)b * R * C;
    // one staging per input type, each with the type a constant (Bands)
    auto stage_src = [&](const int* rows, const int* cols, int WR, int WC, Stage<S>* win) {
      auto row = [&](int i) { return plane + (size_t)rows[i] * C; };
      if (in_bf16)
        stage_window<S, 1, 6, 3>(Bands{{x}, 1u}, row, cols, WR, WC, win, WC, 0, WR * WC);
      else
        stage_window<S, 1, 6, 3>(Bands{{x}, 0u}, row, cols, WR, WC, win, WC, 0, WR * WC);
    };
    fwd_tile<S, OS, false, NM>(smem_raw, g, taps, b == (int)blockIdx.z, stage_src, a, h, v, d,
                               det_bf16, (size_t)b * Ro * Co, nrm, &s);
  }
  if constexpr (NM != kNone) {  // fwd_tile ended at a barrier: the shared memory is free
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    float* ws = reinterpret_cast<float*>(smem_raw);  // a float a warp (16 nt bytes of taps)
    if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += ws[w];
      nrm.partials[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = t;
    }
  }
}

// ---------------------------------------------------------------------------
// Padded forward level: kernel 11's padded entry point (matmul.cu:
// pdwt_fwd_level_2d_mxu_padded), in fd on float32 kernel 1's padded
// launch.  Replaces fwd_level_2d_padded
// (separable_pallas.py:355), which runs kernel 1's Pallas body on an input
// whose boundary extension the caller wrote as the pad, and the pad_fn= of
// fwd_level_2d_mxu (matmul_pallas.py:306), which runs kernel 11's on a
// local shard that the sharded DWT wrapped in its ring halo
// (parallel/sharded.py).  The port's boundary modes hand it the pywt
// extension (core/modes.py: extend by (hlen - 2, hlen - 1)) or, on a
// periodization axis, the odd extension wrapped at the periodic center (by
// the ring on a sharded axis).  It is kernel 11's per-tile work
// (fwd_tile<S, 2>, rows first, the taps in order, the row-pass result
// split per scheme) with index tables that do not wrap, on an R x C input
// that already holds every sample the Ro x Co outputs read:
//   out[n] = sum_j t[j] * x[2n + j] per axis, n < Ro (Co), R >= 2 (Ro - 1) + hlen.
// TIER false is kernel 1's instance (fd, float32 in and out: both storage
// types constants, the code kernel 1's padded launch had); TIER true
// reads the input and writes H, V, D in the types of the flags, as kernel
// 11 does.  Bound: device memory, as kernels 1 and 11: the extended input
// is read once and the four subbands written once; the extension the
// caller writes adds one read and one write of the image (a later PR may
// read the extension straight from index tables, ROADMAP).  Plan:
// kernels/matmul.py: fwd_padded_launch_plan (kernel 11's plan for Ro x Co
// outputs, kernel 1's in fd).
// ---------------------------------------------------------------------------
template <int S, bool TIER>
__global__ void __launch_bounds__(256)
fwd_padded_kernel(const void* __restrict__ x, float* __restrict__ a, void* __restrict__ h,
                  void* __restrict__ v, void* __restrict__ d, int in_bf16, int det_bf16, int B,
                  int R, int C, int Ro, int Co, int hlen, const float* __restrict__ taps, int lr,
                  int lc, int nph, int nt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xb = TIER ? in_bf16 : 0, db = TIER ? det_bf16 : 0;
  const FwdTile g = {R, C, hlen, 1, 0, lr, lc, 1, nph, nt, 0, (int)blockIdx.y * lr, 0,
                     (int)blockIdx.x * lc, Ro, Co};
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const size_t plane = (size_t)b * R * C;
    // one staging per input type, each with the type a constant (Bands)
    auto stage_src = [&](const int* rows, const int* cols, int WR, int WC, Stage<S>* win) {
      auto row = [&](int i) { return plane + (size_t)rows[i] * C; };
      if (xb)
        stage_window<S, 1, 6, 3>(Bands{{x}, 1u}, row, cols, WR, WC, win, WC, 0, WR * WC);
      else
        stage_window<S, 1, 6, 3>(Bands{{x}, 0u}, row, cols, WR, WC, win, WC, 0, WR * WC);
    };
    fwd_tile<S, 2, true>(smem_raw, g, taps, b == (int)blockIdx.z, stage_src, a, h, v, d, db,
                         (size_t)b * Ro * Co);
  }
}

// ---------------------------------------------------------------------------
// Padded a-trous forward level: kernel 13's padded entry point
// (pdwt_swt_fwd_level_2d_mxu_padded, below), in fd on float32 kernel 5's
// padded launch.  Replaces swt_fwd_level_2d_padded (swt_pallas.py:935) and the
// pad_fn= of swt_fwd_level_2d_mxu (swt_matmul_pallas.py:252), which the
// sharded SWT runs on a local shard that holds its ring halo
// (parallel/sharded.py), exact or under a bf16 tier.  It is kernel 13's
// per-tile work (fwd_tile<S, 1>, rows first, the taps in order) with index
// tables that do not wrap, at dilation f, on an R x C input that already
// holds every sample the Ro x Co outputs read:
//   out[n] = sum_j t[j] * x[n + j f] per axis, n < Ro (Co), R >= Ro + (hlen - 1) f.
// The halo is the bare periodic support, fwd_center(hlen) f rows and
// columns below and (hlen - 1) f - fwd_center(hlen) f above.  TIER as in
// fwd_padded_kernel (false: kernel 5's fd float32 instance).  Bound: device
// memory, as kernels 5 and 13: the padded input read once, four Ro x Co
// planes written once.  Plan: kernels/swt_matmul.py:
// swt_fwd_padded_launch_plan (kernel 13's plan for an Ro x Co image, kernel
// 5's in fd), rows of one residue class mod f as there.
// ---------------------------------------------------------------------------
template <int S, bool TIER>
__global__ void __launch_bounds__(256)
swt_fwd_padded_kernel(const void* __restrict__ x, float* __restrict__ a, void* __restrict__ h,
                      void* __restrict__ v, void* __restrict__ d, int in_bf16, int det_bf16,
                      int B, int R, int C, int Ro, int Co, int hlen, int f,
                      const float* __restrict__ taps, int lr, int lc, int gc, int nph, int nt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xb = TIER ? in_bf16 : 0, db = TIER ? det_bf16 : 0;
  const int frr = f < Ro ? f : Ro, frc = gc == 1 ? 1 : (f < Co ? f : Co);
  const FwdTile g = {R,  C,  hlen, f,  0,  lr, lc, gc, nph, nt, (int)(blockIdx.y % frr),
                     (int)(blockIdx.y / frr) * lr, (int)(blockIdx.x % frc),
                     (int)(blockIdx.x / frc) * lc, Ro, Co};
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const size_t plane = (size_t)b * R * C;
    auto stage_src = [&](const int* rows, const int* cols, int WR, int WC, Stage<S>* win) {
      auto row = [&](int i) { return plane + (size_t)rows[i] * C; };
      if (xb)
        stage_window<S, 1, 6, 3>(Bands{{x}, 1u}, row, cols, WR, WC, win, WC, 0, WR * WC);
      else
        stage_window<S, 1, 6, 3>(Bands{{x}, 0u}, row, cols, WR, WC, win, WC, 0, WR * WC);
    };
    fwd_tile<S, 1, true>(smem_raw, g, taps, b == (int)blockIdx.z, stage_src, a, h, v, d, db,
                         (size_t)b * Ro * Co);
  }
}

// ---------------------------------------------------------------------------
// Forward tail (kernel 3).  Replaces _make_tail_fwd_kernel
// (separable_pallas.py:576): all `levels` remaining analysis levels of a
// (B, R, C) float32 image in one launch, each level kernel 1's function
// (fwd_tile<FD, 2> above: rows first, the taps in order, one FMA each).
// Bound: launch count and latency, not bytes (a 128 x 128 level is 64 KiB,
// 0.02 us at 3.35 TB/s): the design spreads each level over the blocks of
// a thread-block cluster instead of one block (one SM) per item.  A batch
// item owns nb blocks, tile k of a level on block k mod nb, on the plan of
// kernels/separable.py: tail_launch_plan (a tile per level; with one
// level, kernel 1's plan and no barrier).  Level j's approximation goes to
// `scratch` (the wrapper's, L2-resident at these sizes: 64 KiB at 128^2)
// and the next level stages from it with coherent loads (load_band<CG>: the
// read-only path is valid only for data no thread of the launch writes)
// after a cluster barrier (release/acquire at cluster scope); the input
// stays on the read-only path.  H, V, D of each level and the last A go
// straight to the outputs.  The taps come from the (4, hlen) device buffer
// into shared memory once per block; no level sits in shared memory past
// its tile, so halos wider than a level need nothing special (the index
// tables wrap mod N).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
fwd_tail_kernel(const float* __restrict__ x, float* __restrict__ a_out, float* scratch,
                const __grid_constant__ TailArgs t, int B, int R, int C, int levels, int hlen,
                int cen, const float* __restrict__ taps, int nb, int nt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / nb, rank = blockIdx.x % nb;
  bool load_taps = true;
  const float* src = x;
  float* scr = scratch;
  int r = R, c = C;
  for (int l = 0; l < levels; ++l) {
    const int ro = r / 2, co = c / 2;
    const TailTile tt = t.tile[l];
    const int tx = (co + tt.lc - 1) / tt.lc, ntile = tx * ((ro + tt.lr - 1) / tt.lr);
    float* a = l == levels - 1 ? a_out : scr;
    const size_t plane = (size_t)b * r * c;
    for (int k = rank; k < ntile; k += nb) {
      const FwdTile g = {r, c, hlen, 1, cen, tt.lr, tt.lc, 1, tt.nph, nt,
                         0, (k / tx) * tt.lr, 0, (k % tx) * tt.lc};
      auto stage_src = [&](const int* rows, const int* cols, int WR, int WC, float* win) {
        auto row = [&](int i) { return plane + (size_t)rows[i] * c; };
        if (l == 0)
          stage_window<FD, 1, 6, 3>(Bands{{x}, 0u}, row, cols, WR, WC, win, WC, 0, WR * WC);
        else
          stage_window<FD, 1, 6, 3, 1u>(Bands{{src}, 0u}, row, cols, WR, WC, win, WC, 0,
                                        WR * WC);
      };
      fwd_tile<FD, 2>(smem_raw, g, taps, load_taps, stage_src, a, t.det[3 * l],
                      t.det[3 * l + 1], t.det[3 * l + 2], 0, (size_t)b * ro * co);
      load_taps = false;
    }
    if (l + 1 < levels) cooperative_groups::this_cluster().sync();
    src = a;
    scr = a + (size_t)B * ro * co;
    r = ro;
    c = co;
  }
}

// ---------------------------------------------------------------------------
// Inverse level.  Replaces _swt_inv_mxu_kernel (swt_matmul_pallas.py:293).
// Redesigned for Hopper's CUDA cores (band_strip.cuh).  A block owns lr rows
// of one residue class mod f (window row i <-> row rho + f (q0 + i - cen),
// dilation 1 inside the window) and lc columns that are either consecutive
// (gc = 1, for small f: the window's columns are consecutive in memory, so
// the staging loads and the stores are coalesced, and a tap steps dc = f
// window columns) or one residue class (gc = f, dc = 1, for large f, where a
// consecutive window would grow with f).  Per batch item: stage the
// thresholded, split windows of the four subbands (all four, or (A, H) then
// (V, D) when shared memory is short: nph = 2), synthesise along the rows
// into two shared temps, each one float32 sum over the low taps on the first
// band then the high taps on the second (strips of kRowStrip rows per
// thread, one window column per lane), split again; then along the columns,
// the low taps on the first temp then the high taps on the second (strips of
// kColStrip outputs dc apart per thread, one tile row per lane) into a float
// tile, written out with lanes along the columns.  The taps are padded with
// zeros to nt, a multiple of 8; the plan (kernels/swt_matmul.py:
// swt_inv_launch_plan) picks lr, lc, gc, nph, the threads, the grid and the
// shared-memory bytes, and the entry point refuses a plan that does not add
// up.
//
// PAD: kernel 14's padded entry point (pdwt_swt_inv_level_2d_mxu_padded,
// below): in fd on float32 subbands kernel 6's padded launch, which
// replaces swt_inv_level_2d_padded (swt_pallas.py:960); in the tiers'
// schemes the replacement of the pad_fn= of swt_inv_level_2d_mxu
// (swt_matmul_pallas.py:402): Ri x Ci subbands that
// hold their ring halo (swt_inv_center(hlen) f rows and columns below, the
// rest of the span (hlen - 1) f above), index tables that do not wrap
// (fill_table, cen = 0: out[n] = sum_band sum_j t_band[j] x_band[n + j f]
// per axis) and R x C outputs, Ri >= R + (hlen - 1) f; no threshold
// (the sharded denoising step thresholds apart, as JAX's does).  A
// compile-time choice, so the periodic instances (Ri = R, Ci = C) keep
// their code.
// ---------------------------------------------------------------------------
constexpr int kInvCh = 8;       // taps per chunk of the inverse's strips
constexpr int kStageLoads = 32;  // loads in flight per thread while staging

// Shared-memory bytes of the inverse: taps, index tables, the band windows
// (which hold the output tile once the row pass is done), the two temps.
// kernels/swt_matmul.py:_inv_smem mirrors it.
template <int S>
size_t inv_smem(int lr, int lc, int dc, int nt, int nph) {
  using St = Stage<S>;
  const size_t nd = kDataLo<S> ? 2 : 1;
  const size_t WR = lr + nt - 1, WC = lc + (size_t)(nt - 1) * dc;
  const size_t win = (nph == 1 ? 4 : 2) * nd * WR * WC * sizeof(St);
  const size_t tile = (size_t)lr * (lc + 1) * sizeof(float);
  return 16 * (size_t)nt + align16((WR + WC) * sizeof(int)) + align16(win > tile ? win : tile) +
         2 * nd * lr * temp_pitch<St>((int)WC) * sizeof(St);
}

template <int S, bool PAD = false>
__global__ void __launch_bounds__(256)
swt_inv_mxu_kernel(const float* __restrict__ a, const void* __restrict__ h,
                   const void* __restrict__ v, const void* __restrict__ d, void* __restrict__ out,
                   int det_bf16, int out_bf16, int B, int R, int C, int hlen, int f, int cen,
                   int mode, const float* __restrict__ beta, int lr, int lc, int gc, int nph,
                   int nt, const float* __restrict__ taps, int Rin, int Cin) {
  using St = Stage<S>;
  constexpr int nd = kDataLo<S> ? 2 : 1;
  constexpr int PR = kRowStrip<S>, PC = kColStrip;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dc = f / gc;
  const int WR = lr + nt - 1, WC = lc + (nt - 1) * dc, TP = temp_pitch<St>(WC);
  const int nbw = nph == 1 ? 4 : 2;
  float* t1 = reinterpret_cast<float*>(smem_raw);  // lo | hi, first values
  float* t2 = t1 + 2 * nt;                          // second values
  int* rows = reinterpret_cast<int*>(t2 + 2 * nt);
  int* cols = rows + WR;
  unsigned char* p = smem_raw + 16 * (size_t)nt + align16((size_t)(WR + WC) * sizeof(int));
  St* win = reinterpret_cast<St*>(p);  // band u, operand e at win + (u * nd + e) * WR * WC
  float* tile = reinterpret_cast<float*>(p);  // lr x (lc + 1), after the row pass
  const size_t wbytes = (size_t)nbw * nd * WR * WC * sizeof(St);
  const size_t tbytes = (size_t)lr * (lc + 1) * sizeof(float);
  St* tmp = reinterpret_cast<St*>(p + align16(wbytes > tbytes ? wbytes : tbytes));
  const int BS = nd * WR * WC, TS = nd * lr * TP;  // band and temp strides

  const int frr = f < R ? f : R, frc = gc == 1 ? 1 : (f < C ? f : C);
  const int rho_r = blockIdx.y % frr, q0r = (blockIdx.y / frr) * lr;
  const int rho_c = blockIdx.x % frc, q0c = (blockIdx.x / frc) * lc;
  const int Ri = PAD ? Rin : R, Ci = PAD ? Cin : C;  // the subbands' sides
  fill_table<PAD>(rows, WR, rho_r + (long long)f * (q0r - cen), f, Ri);
  fill_table<PAD>(cols, WC, rho_c + (long long)gc * q0c - (long long)cen * f, gc, Ci);
  const float bt = mode == kNone ? 0.f : __ldg(beta);
  const unsigned tb = det_bf16 ? 0xe : 0;  // H, V, D bf16
  const Bands all = {{a, h, v, d}, tb}, ah = {{a, h}, tb & 3}, vd = {{v, d}, tb >> 2};
  __syncthreads();
  auto tap = [&](int e) { return dual_tap(e, nt, hlen); };

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const size_t plane = (size_t)b * R * C, iplane = PAD ? (size_t)b * Ri * Ci : plane;
    for (int ph = 0; ph < nph; ++ph) {
      const unsigned thr = mode == kNone ? 0 : (nph == 1 ? 0xe : (ph == 0 ? 2 : 3));
      auto stage_phase = [&] {
        if (nph == 1)
          stage_bands<S, 4, kStageLoads>(all, thr, iplane, Ci, rows, cols, WR, WC, win, BS,
                                         WR * WC, mode, bt);
        else
          stage_bands<S, 2, kStageLoads>(ph == 0 ? ah : vd, thr, iplane, Ci, rows, cols, WR, WC,
                                         win, BS, WR * WC, mode, bt);
      };
      if (b == (int)blockIdx.z && ph == 0)
        fill_around(t1, 4 * nt, taps, tap, stage_phase);
      else
        stage_phase();
      __syncthreads();
      // along the rows: temp (u/2) from bands (u, u + 1) of this phase
      const int ntau = nbw / 2, per = (lr / PR) * WC;
      for (int it = threadIdx.x; it < ntau * per; it += blockDim.x) {
        const int tl = it / per, rem = it % per, r0 = (rem / WC) * PR, w = rem % WC;
        Acc<S> acc[1][PR];
        band_strip<S, PR, 1, kInvCh>(acc, win + 2 * tl * BS + r0 * WC + w, WR * WC, BS, 2, WC,
                                     t1, t2, 0, nt);
        St* dst = tmp + (ph * ntau + tl) * TS;
#pragma unroll
        for (int q = 0; q < PR; ++q)
          stage<S>(acc[0][q].total(), dst, dst + lr * TP, (r0 + q) * TP + w);
      }
      __syncthreads();
    }
    // along the columns: tile row r, outputs t0 + dc q (q < PC)
    for (int it = threadIdx.x; it < lr * (lc / PC); it += blockDim.x) {
      const int r = it % lr, s = it / lr, t0 = s % dc + dc * (s / dc) * PC;
      Acc<S> acc[1][PC];
      band_strip<S, PC, 1, kInvCh>(acc, tmp + r * TP + t0, lr * TP, TS, 2, dc, t1, t2, 0, nt);
#pragma unroll
      for (int q = 0; q < PC; ++q) tile[r * (lc + 1) + t0 + dc * q] = acc[0][q].total();
    }
    __syncthreads();
    auto orow = [&](int i) { return rho_r + (long long)f * (q0r + i); };
    auto ocol = [&](int u) { return rho_c + (long long)gc * (q0c + u); };
    if (out_bf16)
      store_tile(static_cast<__nv_bfloat16*>(out), plane, R, C, tile, lc + 1, lr, lc, orow, ocol);
    else
      store_tile(static_cast<float*>(out), plane, R, C, tile, lc + 1, lr, lc, orow, ocol);
    __syncthreads();
  }
}

}  // namespace

namespace pdwt_swtmm {

// Launch the forward at output step os (1: a-trous at dilation f, outputs R
// x C; 2: decimated, f = 1, R and C even, outputs R/2 x C/2) in compute
// scheme `scheme` (the index in kernels/matmul.py:SCHEMES; the input bf16
// where in_bf16, H, V, D bf16 where det_bf16) on its launch plan: tile lr x
// lc outputs, column stride gc (1 or f), nph output phases, nt padded taps,
// threads, grid (gx, gy, gz) and dynamic shared-memory bytes; a plan that
// does not add up is refused (cudaErrorInvalidValue).  `taps` is a (4,
// hlen) float32 device buffer: the low filter's first and second values,
// then the high filter's, correlation order; `cen` is fwd_center(hlen).
// Kernel 13's entry point (pdwt_swt_fwd_level_2d_mxu, below; kernel 5's
// launches in fd) runs it at os = 1, kernel 11's (matmul.cu:
// pdwt_fwd_level_2d_mxu; kernel 1's in fd) at os = 2.  A norm mode other
// than kNone (kernel 5's norm launches: fd, os = 1, float32 in and out)
// runs that mode's instance, which writes gx gy gz partials.
int launch_fwd(const void* x, float* a, void* h, void* v, void* d, int B, int R, int C,
               const float* taps, int hlen, int os, int f, int cen, int scheme, int in_bf16,
               int det_bf16, int lr, int lc, int gc, int nph, int nt, int threads, int gx,
               int gy, int gz, int smem, void* stream, NormOut nrm) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || R < 1 || C < 1 || f < 1 ||
      !(os == 1 || (os == 2 && f == 1 && !((R | C) & 1))))
    return cudaErrorInvalidValue;
  const int Ro = R / os, Co = C / os;
  if (nt < hlen || nt > PDWT_MXU_MAX_HLEN || nt % kFwdCh || !(gc == 1 || gc == f) ||
      !(nph == 1 || nph == 2) || lr < 1 || lc < 1 || threads < 32 || threads > 256 ||
      threads % 32 || lc % (kColStrip * (f / gc)) ||
      !grid_fits(B, Ro, Co, f, lr, lc, gc, gx, gy, gz))
    return cudaErrorInvalidValue;
  const bool norm = nrm.mode != kNone;
  if (norm && (nrm.mode < kSoft || nrm.mode > kGarrote || !nrm.beta || !nrm.partials ||
               scheme != FD || os != 1 || in_bf16 || det_bf16))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    if (lr % kRowStrip<S> || (size_t)smem != fwd_smem<S>(os, lr, lc, f / gc, nt, nph))
      return cudaErrorInvalidValue;
    auto launch = [&](auto kernel) -> cudaError_t {
      cudaError_t e = prepare(kernel, smem);
      if (e != cudaSuccess) return e;
      kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
          x, a, h, v, d, in_bf16, det_bf16, B, R, C, hlen, f, cen, taps, lr, lc, gc, nph, nt,
          nrm);
      return cudaGetLastError();
    };
    if constexpr (S == FD) {
      if (nrm.mode == kSoft) return launch(swt_fwd_mxu_kernel<FD, 1, kSoft>);
      if (nrm.mode == kHard) return launch(swt_fwd_mxu_kernel<FD, 1, kHard>);
      if (nrm.mode == kGarrote) return launch(swt_fwd_mxu_kernel<FD, 1, kGarrote>);
    }
    return os == 2 ? launch(swt_fwd_mxu_kernel<S, 2>) : launch(swt_fwd_mxu_kernel<S, 1>);
  });
}

// launch_fwd without a norm: kernel 11's entry point (kernel 1's launches).
int launch_fwd(const void* x, float* a, void* h, void* v, void* d, int B, int R, int C,
               const float* taps, int hlen, int os, int f, int cen, int scheme, int in_bf16,
               int det_bf16, int lr, int lc, int gc, int nph, int nt, int threads, int gx,
               int gy, int gz, int smem, void* stream) {
  return launch_fwd(x, a, h, v, d, B, R, C, taps, hlen, os, f, cen, scheme, in_bf16, det_bf16,
                    lr, lc, gc, nph, nt, threads, gx, gy, gz, smem, stream, NormOut{});
}

// Launch a padded forward (fwd_padded_kernel at output step os = 2,
// swt_fwd_padded_kernel at os = 1 and dilation f) in compute scheme
// `scheme`, the input bf16 where in_bf16, H, V, D bf16 where det_bf16: the
// fd float32 call takes TIER false (kernels 1 and 5's instance), every
// other one the scheme's TIER instance.  The plan fields are kernel 11's
// (os = 2, gc = 1) or 13's for Ro x Co outputs; refused
// (cudaErrorInvalidValue) where the plan does not add up or the outputs
// would read past the R x C input.
int launch_fwd_padded(const void* x, float* a, void* h, void* v, void* d, int B, int R, int C,
                      int Ro, int Co, const float* taps, int hlen, int os, int f, int scheme,
                      int in_bf16, int det_bf16, int lr, int lc, int gc, int nph, int nt,
                      int threads, int gx, int gy, int gz, int smem, void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || Ro < 1 || Co < 1 || f < 1 ||
      !(os == 1 || (os == 2 && f == 1)) ||
      R < (long long)os * (Ro - 1) + (long long)(hlen - 1) * f + 1 ||
      C < (long long)os * (Co - 1) + (long long)(hlen - 1) * f + 1)
    return cudaErrorInvalidValue;
  if (nt < hlen || nt > PDWT_MXU_MAX_HLEN || nt % kFwdCh || !(gc == 1 || gc == f) ||
      !(nph == 1 || nph == 2) || lr < 1 || lc < 1 || lc % (kColStrip * (f / gc)) ||
      threads < 32 || threads > 256 || threads % 32 ||
      !grid_fits(B, Ro, Co, f, lr, lc, gc, gx, gy, gz))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) -> cudaError_t {
    constexpr int S = decltype(sc)::value;
    if (lr % kRowStrip<S> || (size_t)smem != fwd_smem<S>(os, lr, lc, f / gc, nt, nph))
      return cudaErrorInvalidValue;
    auto launch = [&](auto k2, auto k1) -> cudaError_t {
      if (os == 2) {
        cudaError_t e = prepare(k2, smem);
        if (e != cudaSuccess) return e;
        k2<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
            x, a, h, v, d, in_bf16, det_bf16, B, R, C, Ro, Co, hlen, taps, lr, lc, nph, nt);
      } else {
        cudaError_t e = prepare(k1, smem);
        if (e != cudaSuccess) return e;
        k1<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
            x, a, h, v, d, in_bf16, det_bf16, B, R, C, Ro, Co, hlen, f, taps, lr, lc, gc, nph,
            nt);
      }
      return cudaGetLastError();
    };
    if constexpr (S == FD)
      if (!in_bf16 && !det_bf16)
        return launch(fwd_padded_kernel<FD, false>, swt_fwd_padded_kernel<FD, false>);
    return launch(fwd_padded_kernel<S, true>, swt_fwd_padded_kernel<S, true>);
  });
}

// Launch the padded a-trous synthesis (swt_inv_mxu_kernel<S, true>, no
// threshold) in compute scheme `scheme` on four Ri x Ci subbands (a
// float32, H, V, D bf16 where det_bf16) into an R x C output (bf16 where
// out_bf16), on kernel 14's plan for R x C (kernel 6's in fd); refused
// (cudaErrorInvalidValue) where the plan does not add up or the outputs
// would read past the subbands.
int launch_swt_inv_padded(const float* a, const void* h, const void* v, const void* d, void* out,
                          int B, int Ri, int Ci, int R, int C, const float* taps, int hlen, int f,
                          int scheme, int det_bf16, int out_bf16, int lr, int lc, int gc,
                          int nph, int nt, int threads, int gx, int gy, int gz, int smem,
                          void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || R < 1 || C < 1 || f < 1 ||
      Ri < R + (long long)(hlen - 1) * f || Ci < C + (long long)(hlen - 1) * f)
    return cudaErrorInvalidValue;
  if (nt < hlen || nt > PDWT_MXU_MAX_HLEN || nt % kInvCh || !(gc == 1 || gc == f) ||
      !(nph == 1 || nph == 2) || lr < 1 || lc < 1 || lc % (kColStrip * (f / gc)) ||
      threads < 32 || threads > 256 || threads % 32 ||
      !grid_fits(B, R, C, f, lr, lc, gc, gx, gy, gz))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) -> cudaError_t {
    constexpr int S = decltype(sc)::value;
    if (lr % kRowStrip<S> || (size_t)smem != inv_smem<S>(lr, lc, f / gc, nt, nph))
      return cudaErrorInvalidValue;
    auto kernel = swt_inv_mxu_kernel<S, true>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
        a, h, v, d, out, det_bf16, out_bf16, B, R, C, hlen, f, 0, kNone, nullptr, lr, lc, gc, nph,
        nt, taps, Ri, Ci);
    return cudaGetLastError();
  });
}

// Launch the forward tail (kernel 3) on its plan (kernels/separable.py:
// tail_launch_plan): nb blocks per batch item in clusters of cs, threads,
// dynamic shared-memory bytes (the largest level's), and each level's tile
// in `tiles` (lr, lc, nph per level, level 1 first); `det` holds the
// 3 * levels detail planes, (H, V, D) of level 1 first; `scratch` the
// approximations of levels 1 .. levels - 1, one after the other.  The
// taps and cen are kernel 1's.  A plan that does not add up, or that the
// card cannot hold, is refused (cudaErrorInvalidValue).
int launch_fwd_tail(const float* x, float* a, float* scratch, void* const* det, int B, int R,
                    int C, int levels, const float* taps, int hlen, int cen, int nb, int cs,
                    int nt, int threads, int smem, const int* tiles, void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || R < 2 || C < 2 || levels < 1 ||
      levels > PDWT_MAX_TAIL_LEVELS || R % (1 << levels) || C % (1 << levels) ||
      (levels > 1 && !scratch) || nt < hlen || nt > PDWT_MXU_MAX_HLEN || nt % kFwdCh ||
      !tail_grid_ok(B, levels, nb, cs, threads))
    return cudaErrorInvalidValue;
  TailArgs t = {};
  size_t need = 0;
  for (int l = 0; l < levels; ++l) {
    const TailTile tt = {tiles[3 * l], tiles[3 * l + 1], tiles[3 * l + 2]};
    if (tt.lr < 1 || tt.lc < 1 || tt.lr % kRowStrip<FD> || tt.lc % kColStrip ||
        !(tt.nph == 1 || tt.nph == 2))
      return cudaErrorInvalidValue;
    const size_t sm = fwd_smem<FD>(2, tt.lr, tt.lc, 1, nt, tt.nph);
    need = sm > need ? sm : need;
    t.tile[l] = tt;
    for (int k = 0; k < 3; ++k) t.det[3 * l + k] = det[3 * l + k];
  }
  if ((size_t)smem != need) return cudaErrorInvalidValue;
  return launch_clusters(fwd_tail_kernel, B * nb, threads, need, cs, stream, x, a, scratch, t, B,
                         R, C, levels, hlen, cen, taps, nb, nt);
}

}  // namespace pdwt_swtmm

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).
// `scheme` is the index in kernels/matmul.py:SCHEMES; the *_bf16 flags pick
// bf16 (1) or float32 (0) storage; `cen` is the center in taps
// (fwd_center(hlen) forward, swt_inv_center(hlen) inverse), f the dilation.

// The forward at dilation f on the launch plan of
// kernels/swt_matmul.py:swt_fwd_launch_plan (pdwt_swtmm::launch_fwd, os = 1):
// kernel 13, and kernel 5 in fd on float32.  norm_mode 0 is the plain
// launch; 1 soft, 2 hard, 3 garrote a norm launch of kernel 5 (scheme FD,
// float32 in and out, else refused), which also writes the thresholded L1
// norm of H, V and D at the float at `beta` (device memory), plus |A| where
// `approx`, as gx gy gz float32 partials to `partials`.
extern "C" int pdwt_swt_fwd_level_2d_mxu(const void* x, float* a, void* h, void* v, void* d,
                                         int B, int R, int C, const float* taps, int hlen, int f,
                                         int cen, int scheme, int in_bf16, int det_bf16, int lr,
                                         int lc, int gc, int nph, int nt, int threads, int gx,
                                         int gy, int gz, int smem, int norm_mode,
                                         const float* beta, float* partials, int approx,
                                         void* stream) {
  return pdwt_swtmm::launch_fwd(x, a, h, v, d, B, R, C, taps, hlen, 1, f, cen, scheme, in_bf16,
                                det_bf16, lr, lc, gc, nph, nt, threads, gx, gy, gz, smem, stream,
                                {norm_mode, beta, partials, approx});
}

// `taps` is a (4, hlen) float32 device buffer: the low filter's first and
// second values, then the high filter's, correlation order (the 1/2 per pass
// folded in).  thresh_mode: 0 none, 1 soft, 2 hard, 3 garrote of H, V and D
// with the float at `beta` (device memory; unread when thresh_mode is 0).
// The launch plan
// (kernels/swt_matmul.py:swt_inv_launch_plan): tile lr x lc, column stride gc
// (1 or f), nph band phases, nt padded taps, threads, grid (gx, gy, gz) and
// dynamic shared-memory bytes; a plan that does not add up is refused
// (cudaErrorInvalidValue).
extern "C" int pdwt_swt_inv_level_2d_mxu(const float* a, const void* h, const void* v,
                                         const void* d, void* out, int B, int R, int C,
                                         const float* taps, int hlen, int f, int cen, int scheme,
                                         int det_bf16, int out_bf16, int thresh_mode,
                                         const float* beta, int lr, int lc, int gc, int nph,
                                         int nt, int threads, int gx, int gy, int gz, int smem,
                                         void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || R < 1 || C < 1 || f < 1 ||
      thresh_mode < kNone || thresh_mode > kGarrote || (thresh_mode != kNone && !beta))
    return cudaErrorInvalidValue;
  if (nt < hlen || nt > PDWT_MXU_MAX_HLEN || nt % kInvCh || !(gc == 1 || gc == f) ||
      !(nph == 1 || nph == 2) || lr < 1 || lc < 1 || threads < 32 || threads > 256 ||
      threads % 32 || lc % (kColStrip * (f / gc)) ||
      !grid_fits(B, R, C, f, lr, lc, gc, gx, gy, gz))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    if (lr % kRowStrip<S> || (size_t)smem != inv_smem<S>(lr, lc, f / gc, nt, nph))
      return cudaErrorInvalidValue;
    auto kernel = swt_inv_mxu_kernel<S>;
    cudaError_t e2 = prepare(kernel, smem);
    if (e2 != cudaSuccess) return e2;
    kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
        a, h, v, d, out, det_bf16, out_bf16, B, R, C, hlen, f, cen, thresh_mode, beta, lr, lc, gc,
        nph, nt, taps, R, C);
    return cudaGetLastError();
  });
}

// The padded entry points of kernels 13 and 14 (the sharded SWT under the
// bf16 tiers, parallel/sharded.py), on the a-trous bodies above with index
// tables that do not wrap, in compute scheme `scheme`.  Kernel 13's: a (B,
// R, C) input (bf16 where in_bf16) that holds its halo -> four (B, Ro, Co)
// planes, A float32 and H, V, D bf16 where det_bf16, out[n] = sum_j t[j]
// x[n + j f] per axis; taps as kernel 13's, the plan kernels/swt_matmul.py:
// swt_fwd_padded_launch_plan's.  Refused where Ro + (hlen - 1) f > R (or
// the columns'): a stored output would read outside the input.
extern "C" int pdwt_swt_fwd_level_2d_mxu_padded(const void* x, float* a, void* h, void* v,
                                                void* d, int B, int R, int C, int Ro, int Co,
                                                const float* taps, int hlen, int f, int scheme,
                                                int in_bf16, int det_bf16, int lr, int lc,
                                                int gc, int nph, int nt, int threads, int gx,
                                                int gy, int gz, int smem, void* stream) {
  return pdwt_swtmm::launch_fwd_padded(x, a, h, v, d, B, R, C, Ro, Co, taps, hlen, 1, f, scheme,
                                       in_bf16, det_bf16, lr, lc, gc, nph, nt, threads, gx, gy,
                                       gz, smem, stream);
}

// Kernel 14's: four (B, Ri, Ci) subbands that hold their halo (A float32,
// H, V, D bf16 where det_bf16) -> (B, R, C), bf16 where out_bf16, out[n] =
// sum_band sum_j t_band[j] x_band[n + j f] per axis, no threshold; the
// halved taps as kernel 14's, the plan kernels/swt_matmul.py:
// swt_inv_padded_launch_plan's.  Refused where R + (hlen - 1) f > Ri (or
// the columns').
extern "C" int pdwt_swt_inv_level_2d_mxu_padded(const float* a, const void* h, const void* v,
                                                const void* d, void* out, int B, int Ri, int Ci,
                                                int R, int C, const float* taps, int hlen, int f,
                                                int scheme, int det_bf16, int out_bf16, int lr,
                                                int lc, int gc, int nph, int nt, int threads,
                                                int gx, int gy, int gz, int smem, void* stream) {
  return pdwt_swtmm::launch_swt_inv_padded(a, h, v, d, out, B, Ri, Ci, R, C, taps, hlen, f,
                                           scheme, det_bf16, out_bf16, lr, lc, gc, nph, nt,
                                           threads, gx, gy, gz, smem, stream);
}
