// The rank-r non-separable level kernels of the precision tiers for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (pdwt_tpu_torch/kernels/_build.py links this file with the other sources).
//
// Two kernels, one per Pallas kernel of pdwt_tpu/kernels/ns_matmul_pallas.py:
//
//   ns_fwd_mxu_kernel  <- _ns_fwd_kernel  (ns_matmul_pallas.py:100), stride 2
//                         (decimated, :156) and stride 1 (a-trous, :384)
//   ns_inv_mxu_kernel  <- _ns_inv_kernel  (ns_matmul_pallas.py:206), polyphase
//                         (decimated, :264) and a-trous (:452)
//
// A genuinely 2D quad set of rank r runs as the separable sum
// Q_s = sum_k outer(a_k^(s), b_k) (core/nonseparable.py:_rank_decomp): r column
// filters b_k shared by the four subbands and 4 r row filters a_k^(s).  On the
// TPU each pass is a banded matrix product in a compute scheme (b1, fd, b2f,
// b2d, b3; mxu_common.cuh); here the band is evaluated directly on the CUDA
// cores, with the operands rounded per scheme as they are staged.  The order
// of the passes and of the sums is the TPU kernels':
//   forward  t_k = x filtered by b_k along the COLUMNS (x @ B, first), then
//            out_s = sum_k t_k filtered by a_k^(s) along the rows, one float32
//            sum per term over (k, tap) in that order (M @ vstack_k t_k);
//   inverse  t_k = sum_s band_s synthesised by a_k^(s) along the rows, one sum
//            over (s, tap), then out = sum_k t_k synthesised by b_k along the
//            columns, one sum over (k, tap).
// The float32 temps t_k are split per scheme before the second pass.  The
// a-trous inverse's 1/4 rides on the column filters (the wrapper scales them).
//
// Index spec (core/conv.py), per axis, with stride S (2 decimated, 1 a-trous)
// and dilation f (1 decimated): the forward's output n reads input
// S n + (j - fwd_center(hlen)) f; the inverse's output S n + q reads subband
// n + (off_q + b - org) f with taps p_q + S b, b < nb_q (the polyphase
// geometry of poly_geometry(hlen) when decimated: org = lo, off_q = lo + o_q;
// a-trous: org = swt_inv_center(hlen), one phase of all hlen taps).
//
// Layout.  Both kernels are redesigned for Hopper's CUDA cores on
// band_strip.cuh: a block owns a tile of rows of one residue class mod f by
// consecutive columns (or one residue class where a consecutive window
// would grow more than 1.4x), so the staged windows do not grow with the
// level; its tile, column layout, block size, grid and shared memory come
// from a launch plan made on the host (kernels/ns_matmul.py), which the
// entry point checks.  Each kernel's own comment below says how it runs.
// The taps (at most 4 x 5 filters of 40 taps, both terms) come from a small
// device buffer and are read once per block, around its first staging.
//
// Bound.  At 2048^2 a rank-3 level reads 8 MiB (bf16) and writes 4 MiB of
// float32 plus 6 MiB of bf16 (5.6 us at 3.35 TB/s); with 8 taps it does
// 1.5 r R C hlen = 150 M multiply-adds per term (decimated), 0.3 GFLOP, about
// 5 us on the float32 cores for b1: balanced, as the separable kernels.  Each
// input sample is staged once per window and split then; the temps never
// leave shared memory.

#include "band_strip.cuh"

namespace {

using namespace pdwt_mxu;
using namespace pdwt_strip;

constexpr int kMaxRank = 4;
constexpr int kMaxHlen = 40;

// ---------------------------------------------------------------------------
// Forward level, stride 2 or 1.  Replaces _ns_fwd_kernel
// (ns_matmul_pallas.py:100).  Redesigned for Hopper's CUDA cores
// (band_strip.cuh), as the inverse below.  A block owns lr output rows (one
// residue class mod f) by lc output columns (consecutive, gc = 1, or one
// residue class, gc = f; always consecutive at stride 2).  Per batch item:
// stage the input window (WR = S (lr - 1) + nt rows by WC = S (lc - 1) +
// (nt - 1) dc + 1 columns, wrapped through 32-bit index tables, 16 loads per
// thread in flight, split into the scheme's operands, an odd number of
// words per row); along the columns, each thread takes a strip of kRowStrip
// outputs (dc apart) of one window row, lanes along the rows, and sums the
// R column filters b_k at once from one read of each sample (OS = S samples
// between outputs), into R shared temps (WR rows by lc columns), split
// again; along the rows, each thread takes a strip of kRowStrip output rows
// of one temp column, lanes along the columns, and sums the four subbands'
// row filters over (k, tap) at once, k outer and tap inner, as the plain
// version; A, H, V and D go straight from the registers to device memory
// (a warp stores consecutive columns).  The taps (b_k, then the a_k^(s)) are
// padded with zeros to nt, a multiple of 4, and read around the first
// staging.  The plan (kernels/ns_matmul.py: ns_fwd_launch_plan) picks the
// tile so that the deep levels still get about two blocks per SM, and the
// entry point refuses a plan that does not add up.
// ---------------------------------------------------------------------------
constexpr int kCh = 4;           // taps per chunk of the strips
constexpr int kStageLoads = 16;  // loads in flight per thread while staging

// Shared-memory bytes of the forward: column and row taps, index tables, the
// window, the R temps.  kernels/ns_matmul.py:_fwd_smem mirrors it.
template <int S>
size_t ns_fwd_smem(int rank, int st, int lr, int lc, int dc, int nt) {
  using St = Stage<S>;
  const size_t nd = kDataLo<S> ? 2 : 1;
  const size_t WR = (size_t)st * (lr - 1) + nt;
  const size_t WC = (size_t)st * (lc - 1) + (size_t)(nt - 1) * dc + 1;
  return 40 * (size_t)rank * nt + align16((WR + WC) * sizeof(int)) +
         align16(nd * WR * temp_pitch<St>((int)WC) * sizeof(St)) +
         (size_t)rank * nd * WR * temp_pitch<St>(lc) * sizeof(St);
}

template <int S, int R, int OS>
__global__ void __launch_bounds__(256)
ns_fwd_mxu_kernel(const void* __restrict__ x, float* __restrict__ a, void* __restrict__ h,
                  void* __restrict__ v, void* __restrict__ d, int in_bf16, int det_bf16, int B,
                  int Rin, int Cin, int Ro, int Co, int hlen, int f, int cen,
                  const float* __restrict__ taps, int lr, int lc, int gc, int nt) {
  using St = Stage<S>;
  constexpr int nd = kDataLo<S> ? 2 : 1;
  constexpr int P = kRowStrip<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dc = f / gc;
  const int WR = OS * (lr - 1) + nt, WC = OS * (lc - 1) + (nt - 1) * dc + 1;
  const int WP = temp_pitch<St>(WC), TP = temp_pitch<St>(lc);
  float* ct1 = reinterpret_cast<float*>(smem_raw);  // [k][nt], b_k first values
  float* ct2 = ct1 + R * nt;                         // second values
  float* rt1 = ct2 + R * nt;                         // [s][k][nt], a_k^(s) first values
  float* rt2 = rt1 + 4 * R * nt;
  int* rows = reinterpret_cast<int*>(rt2 + 4 * R * nt);
  int* cols = rows + WR;
  unsigned char* p = reinterpret_cast<unsigned char*>(rows) +
                     align16((size_t)(WR + WC) * sizeof(int));
  St* win = reinterpret_cast<St*>(p);  // WR x WP, second operand WR * WP further on
  St* tmp = reinterpret_cast<St*>(p + align16((size_t)nd * WR * WP * sizeof(St)));
  const int TS = nd * WR * TP;  // temp stride

  const int frr = f < Ro ? f : Ro, frc = gc == 1 ? 1 : (f < Co ? f : Co);
  const int rho_r = blockIdx.y % frr, q0r = (blockIdx.y / frr) * lr;
  const int rho_c = blockIdx.x % frc, q0c = (blockIdx.x / frc) * lc;
  // window row i <-> input row S (rho_r + f q0r) + (i - cen) f; window
  // column w <-> S (rho_c + gc q0c) - cen f + gc w
  fill_index(rows, WR, OS * (rho_r + (long long)f * q0r) - (long long)cen * f, f, Rin);
  fill_index(cols, WC, OS * (rho_c + (long long)gc * q0c) - (long long)cen * f, gc, Cin);
  const Bands src = {{x}, in_bf16 ? 1u : 0u};
  __syncthreads();
  // ct1, ct2 [k][nt], rt1, rt2 [s][k][nt], one after the other, from
  // taps[k][flt][e2][j] at ((k * 5 + flt) * 2 + e2) * hlen + j (flt 0 = b_k,
  // flt 1 + s = a_k^(s)), zero past hlen
  auto tap = [&](int e) {
    const int nc = R * nt, j = e % nt;
    int k, flt, e2;
    if (e < 2 * nc) {
      e2 = e / nc, k = (e % nc) / nt, flt = 0;
    } else {
      const int o = e - 2 * nc, sk = (o % (4 * nc)) / nt;
      e2 = o / (4 * nc), flt = 1 + sk / R, k = sk % R;
    }
    return j < hlen ? ((k * 5 + flt) * 2 + e2) * hlen + j : -1;
  };

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    auto stage_win = [&] {
      stage_bands<S, 1, kStageLoads>(src, 0, (size_t)b * Rin * Cin, Cin, rows, cols, WR, WC, win,
                                     0, WR * WP, kNone, 0.f, WP);
    };
    if (b == (int)blockIdx.z)
      fill_around(ct1, 10 * R * nt, taps, tap, stage_win);
    else
      stage_win();
    __syncthreads();
    // along the columns: window row i, outputs t0 + dc q (q < P), all k at once
    for (int it = threadIdx.x; it < WR * (lc / P); it += blockDim.x) {
      const int i = it % WR, sp = it / WR, t0 = sp % dc + dc * (sp / dc) * P;
      Acc<S> acc[R][P];
      band_strip<S, P, R, kCh, OS>(acc, win + i * WP + OS * t0, WR * WP, 0, 1, dc, ct1, ct2, nt,
                                   nt);
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int q = 0; q < P; ++q)
          stage<S>(acc[k][q].total(), tmp + k * TS, tmp + k * TS + WR * TP,
                   i * TP + t0 + dc * q);
    }
    __syncthreads();
    // along the rows: temp column t, output rows r0 + q (q < P), all four
    // subbands at once, each a sum over (k, tap); the next item's staging
    // writes only the window, which no thread reads here
    const size_t oplane = (size_t)b * Ro * Co;
    for (int it = threadIdx.x; it < (lr / P) * lc; it += blockDim.x) {
      const int t = it % lc, r0 = (it / lc) * P;
      Acc<S> acc[4][P];
      band_strip<S, P, 4, kCh, OS>(acc, tmp + OS * r0 * TP + t, WR * TP, TS, R, TP, rt1, rt2,
                                   R * nt, nt);
      const long long c = rho_c + (long long)gc * (q0c + t);
      if (c >= Co) continue;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const long long r = rho_r + (long long)f * (q0r + r0 + q);
        if (r >= Ro) break;
        const size_t o = oplane + (size_t)r * Co + c;
        a[o] = acc[0][q].total();
        if (det_bf16) {
          static_cast<__nv_bfloat16*>(h)[o] = from_f<__nv_bfloat16>(acc[1][q].total());
          static_cast<__nv_bfloat16*>(v)[o] = from_f<__nv_bfloat16>(acc[2][q].total());
          static_cast<__nv_bfloat16*>(d)[o] = from_f<__nv_bfloat16>(acc[3][q].total());
        } else {
          static_cast<float*>(h)[o] = acc[1][q].total();
          static_cast<float*>(v)[o] = acc[2][q].total();
          static_cast<float*>(d)[o] = acc[3][q].total();
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Inverse level, polyphase or a-trous.  Replaces _ns_inv_kernel
// (ns_matmul_pallas.py:206).  Redesigned for Hopper's CUDA cores
// (band_strip.cuh).  A block owns lr subband rows (one residue class mod f)
// by lc subband columns (consecutive, gc = 1, or one residue class, gc = f;
// as kernel 14's).  Per batch item: stage the split windows of the four
// subbands; along the rows, each thread takes a strip of kRowStrip subband
// rows of one window column and, per output phase q, sums the four subbands
// (s outer, tap inner) for all R rank terms at once, so every staged sample
// is read once for all k, into R shared temps (rows S tt + q), split again;
// along the columns, each thread takes a strip of kColStrip positions of one
// temp row and sums the R temps (k outer, tap inner) for each phase, into a
// float tile of S lr x S lc outputs, written out with lanes along the
// columns.  The taps of a phase (p_q + S b, b < nb_q) are padded with zeros
// to nt, a multiple of 4.  The plan (kernels/ns_matmul.py:
// ns_inv_launch_plan) picks the tile so that the deep levels still get about
// two blocks per SM, and the entry point refuses a plan that does not add up.
// ---------------------------------------------------------------------------

// The inverse's phases (see the file's index spec), from the int array
// kernels/ns_matmul.py passes: stride, org, p[0], p[1], nb[0], nb[1],
// off[0], off[1].
struct Phase {
  int stride, org;
  int p[2], nb[2], off[2];
};

// Shared-memory bytes of the inverse: row and column taps, index tables, the
// band windows (which hold the output tile once the row pass is done), the
// R temps.  kernels/ns_matmul.py:_inv_smem mirrors it.
template <int S>
size_t ns_inv_smem(int rank, int st, int offmax, int lr, int lc, int dc, int nt) {
  using St = Stage<S>;
  const size_t nd = kDataLo<S> ? 2 : 1;
  const size_t WR = lr + offmax + nt - 1, WC = lc + (size_t)(offmax + nt - 1) * dc;
  const size_t win = 4 * nd * WR * WC * sizeof(St);
  const size_t tile = (size_t)st * lr * (st * lc + 1) * sizeof(float);
  return 40 * (size_t)st * rank * nt + align16((WR + WC) * sizeof(int)) +
         align16(win > tile ? win : tile) +
         (size_t)rank * nd * st * lr * temp_pitch<St>((int)WC) * sizeof(St);
}

template <int S, int R>
__global__ void __launch_bounds__(256)
ns_inv_mxu_kernel(const float* __restrict__ a, const void* __restrict__ h,
                  const void* __restrict__ v, const void* __restrict__ d, void* __restrict__ out,
                  int det_bf16, int out_bf16, int B, int Mr, int Mc, int hlen, int f,
                  const Phase g, const float* __restrict__ taps, int lr, int lc, int gc,
                  int nt) {
  using St = Stage<S>;
  constexpr int nd = kDataLo<S> ? 2 : 1;
  constexpr int PR = kRowStrip<S>, PC = kColStrip;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int st = g.stride, dc = f / gc;
  const int offmax = g.off[0] > g.off[st - 1] ? g.off[0] : g.off[st - 1];
  const int WR = lr + offmax + nt - 1, WC = lc + (offmax + nt - 1) * dc;
  const int TP = temp_pitch<St>(WC), TR = st * lr, OC = st * lc + 1;
  float* rt1 = reinterpret_cast<float*>(smem_raw);  // [q][k][s][nt], first values
  float* rt2 = rt1 + st * R * 4 * nt;
  float* ct1 = rt2 + st * R * 4 * nt;                // [q][k][nt]
  float* ct2 = ct1 + st * R * nt;
  int* rows = reinterpret_cast<int*>(ct2 + st * R * nt);
  int* cols = rows + WR;
  unsigned char* p = reinterpret_cast<unsigned char*>(rows) +
                     align16((size_t)(WR + WC) * sizeof(int));
  St* win = reinterpret_cast<St*>(p);  // band s, operand e at win + (s * nd + e) * WR * WC
  float* tile = reinterpret_cast<float*>(p);  // S lr x (S lc + 1), after the row pass
  const size_t wbytes = (size_t)4 * nd * WR * WC * sizeof(St);
  const size_t tbytes = (size_t)TR * OC * sizeof(float);
  St* tmp = reinterpret_cast<St*>(p + align16(wbytes > tbytes ? wbytes : tbytes));
  const int BS = nd * WR * WC, TS = nd * TR * TP;  // band and temp strides

  const int frr = f < Mr ? f : Mr, frc = gc == 1 ? 1 : (f < Mc ? f : Mc);
  const int rho_r = blockIdx.y % frr, q0r = (blockIdx.y / frr) * lr;
  const int rho_c = blockIdx.x % frc, q0c = (blockIdx.x / frc) * lc;
  fill_index(rows, WR, rho_r + (long long)f * (q0r - g.org), f, Mr);
  fill_index(cols, WC, rho_c + (long long)gc * q0c - (long long)g.org * f, gc, Mc);
  const Bands src = {{a, h, v, d}, det_bf16 ? 0xeu : 0u};
  const int Ro = st * Mr, Co = st * Mc;
  __syncthreads();
  // rt1, rt2 [q][k][s][nt], ct1, ct2 [q][k][nt], one after the other, from
  // taps[k][flt][e2][j] at ((k * 5 + flt) * 2 + e2) * hlen + j (flt 0 = b_k,
  // flt 1 + s = a_k^(s)), j = p_q + S bb, zero past nb_q
  auto tap = [&](int e) {
    const int nr = st * R * 4 * nt, e2 = e >= nr && e < 2 * nr ? 1 : (e >= 2 * nr + st * R * nt);
    const bool row = e < 2 * nr;
    const int o = row ? e - e2 * nr : e - 2 * nr - e2 * st * R * nt;
    const int bb = o % nt, flt = row ? 1 + (o / nt) % 4 : 0;
    const int qk = row ? o / (4 * nt) : o / nt, q = qk / R, k = qk % R;
    return bb < g.nb[q] ? ((k * 5 + flt) * 2 + e2) * hlen + g.p[q] + st * bb : -1;
  };

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const size_t plane = (size_t)b * Mr * Mc;
    auto stage_all = [&] {
      stage_bands<S, 4, kStageLoads>(src, 0, plane, Mc, rows, cols, WR, WC, win, BS, WR * WC,
                                     kNone, 0.f);
    };
    if (b == (int)blockIdx.z)
      fill_around(rt1, 10 * st * R * nt, taps, tap, stage_all);
    else
      stage_all();
    __syncthreads();
    // along the rows: temp rows S (r0 + i) + q of window column w, all k at once
    for (int it = threadIdx.x; it < (lr / PR) * WC; it += blockDim.x) {
      const int r0 = (it / WC) * PR, w = it % WC;
      for (int q = 0; q < st; ++q) {
        Acc<S> acc[R][PR];
        band_strip<S, PR, R, kCh>(acc, win + (r0 + g.off[q]) * WC + w, WR * WC, BS, 4, WC,
                                     rt1 + q * R * 4 * nt, rt2 + q * R * 4 * nt, 4 * nt, nt);
#pragma unroll
        for (int k = 0; k < R; ++k)
#pragma unroll
          for (int i = 0; i < PR; ++i)
            stage<S>(acc[k][i].total(), tmp + k * TS, tmp + k * TS + TR * TP,
                     (st * (r0 + i) + q) * TP + w);
      }
    }
    __syncthreads();
    // along the columns: temp row r2, positions t0 + dc i, both phases
    for (int it = threadIdx.x; it < TR * (lc / PC); it += blockDim.x) {
      const int r2 = it % TR, sp = it / TR, t0 = sp % dc + dc * (sp / dc) * PC;
      for (int q = 0; q < st; ++q) {
        Acc<S> acc[1][PC];
        band_strip<S, PC, 1, kCh>(acc, tmp + r2 * TP + t0 + g.off[q] * dc, TR * TP, TS, R, dc,
                                     ct1 + q * R * nt, ct2 + q * R * nt, 0, nt);
#pragma unroll
        for (int i = 0; i < PC; ++i) tile[r2 * OC + st * (t0 + dc * i) + q] = acc[0][i].total();
      }
    }
    __syncthreads();
    const int sh = st - 1;  // S is 1 or 2: u / S = u >> sh, u % S = u & sh
    auto orow = [&](int r2) {
      return st * (rho_r + (long long)f * (q0r + (r2 >> sh))) + (r2 & sh);
    };
    auto ocol = [&](int u) {
      return st * (rho_c + (long long)gc * (q0c + (u >> sh))) + (u & sh);
    };
    const size_t oplane = (size_t)b * Ro * Co;
    if (out_bf16)
      store_tile(static_cast<__nv_bfloat16*>(out), oplane, Ro, Co, tile, OC, TR, st * lc, orow,
                 ocol);
    else
      store_tile(static_cast<float*>(out), oplane, Ro, Co, tile, OC, TR, st * lc, orow, ocol);
    __syncthreads();
  }
}

cudaError_t check(int B, int hlen, int rank) {
  if (hlen < 2 || hlen > kMaxHlen || rank < 1 || rank > kMaxRank || B < 1)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Call f(std::integral_constant<int, R>) for a runtime rank R in 1..kMaxRank.
template <typename F>
cudaError_t with_rank(int rank, F&& f) {
  switch (rank) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

// Does a plan's tile take whole strips (rows, and columns dc apart)?
bool tile_fits(int lr, int lc, int f, int gc, int strip, int threads) {
  return (gc == 1 || gc == f) && lr >= 1 && lc >= 1 && threads >= 32 && threads <= 256 &&
         threads % 32 == 0 && lr % strip == 0 && lc % (strip * (f / gc)) == 0;
}

}  // namespace

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).
// `taps` is the (rank, 5, 2, hlen) float32 device buffer described above;
// `scheme` the index in kernels/matmul.py:SCHEMES; the *_bf16 flags pick bf16
// (1) or float32 (0) storage.

// stride 2 (f = 1, even R and C, outputs R/2 x C/2) or 1 (dilation f,
// outputs R x C); cen = fwd_center(hlen).  The launch plan
// (kernels/ns_matmul.py:ns_fwd_launch_plan): tile lr x lc outputs, column
// stride gc (1 or f), nt padded taps, threads, grid (gx, gy, gz) and dynamic
// shared-memory bytes; a plan that does not add up is refused
// (cudaErrorInvalidValue).
extern "C" int pdwt_ns_fwd_level_2d_mxu(const void* x, float* a, void* h, void* v, void* d,
                                        int B, int R, int C, const float* taps, int hlen,
                                        int rank, int stride, int f, int cen, int scheme,
                                        int in_bf16, int det_bf16, int lr, int lc, int gc,
                                        int nt, int threads, int gx, int gy, int gz, int smem,
                                        void* stream) {
  cudaError_t e = check(B, hlen, rank);
  if (e != cudaSuccess) return e;
  if (R < 1 || C < 1 || f < 1 || !(stride == 1 || (stride == 2 && f == 1 && !((R | C) & 1))))
    return cudaErrorInvalidValue;
  const int Ro = R / stride, Co = C / stride;
  if (nt < hlen || nt > kMaxHlen || nt % kCh || (stride == 2 && gc != 1) ||
      !grid_fits(B, Ro, Co, f, lr, lc, gc, gx, gy, gz))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    if (!tile_fits(lr, lc, f, gc, kRowStrip<S>, threads) ||
        (size_t)smem != ns_fwd_smem<S>(rank, stride, lr, lc, f / gc, nt))
      return cudaErrorInvalidValue;
    return with_rank(rank, [&](auto rk) -> cudaError_t {
      constexpr int Rk = decltype(rk)::value;
      auto launch = [&](auto kernel) -> cudaError_t {
        cudaError_t e2 = prepare(kernel, smem);
        if (e2 != cudaSuccess) return e2;
        kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
            x, a, h, v, d, in_bf16, det_bf16, B, R, C, Ro, Co, hlen, f, cen, taps, lr, lc, gc,
            nt);
        return cudaGetLastError();
      };
      return stride == 2 ? launch(ns_fwd_mxu_kernel<S, Rk, 2>)
                         : launch(ns_fwd_mxu_kernel<S, Rk, 1>);
    });
  });
}

// geo: stride, org, p[0], p[1], nb[0], nb[1], off[0], off[1] (Phase); the
// output is (B, stride Mr, stride Mc).  The launch plan
// (kernels/ns_matmul.py:ns_inv_launch_plan): tile lr x lc, column stride gc
// (1 or f), nt padded taps per phase, threads, grid (gx, gy, gz) and dynamic
// shared-memory bytes; a plan that does not add up is refused
// (cudaErrorInvalidValue).
extern "C" int pdwt_ns_inv_level_2d_mxu(const float* a, const void* h, const void* v,
                                        const void* d, void* out, int B, int Mr, int Mc,
                                        const float* taps, int hlen, int rank, int f,
                                        const int* geo, int scheme, int det_bf16, int out_bf16,
                                        int lr, int lc, int gc, int nt, int threads, int gx,
                                        int gy, int gz, int smem, void* stream) {
  cudaError_t e = check(B, hlen, rank);
  if (e != cudaSuccess) return e;
  const Phase g = {geo[0], geo[1], {geo[2], geo[3]}, {geo[4], geo[5]}, {geo[6], geo[7]}};
  if (Mr < 1 || Mc < 1 || f < 1 || !(g.stride == 1 || (g.stride == 2 && f == 1)))
    return cudaErrorInvalidValue;
  int offmax = 0;
  for (int q = 0; q < g.stride; ++q) {
    if (g.off[q] < 0 || g.p[q] < 0 || g.nb[q] < 1 || g.nb[q] > nt ||
        g.p[q] + g.stride * (g.nb[q] - 1) >= hlen)
      return cudaErrorInvalidValue;
    offmax = offmax > g.off[q] ? offmax : g.off[q];
  }
  if (nt % kCh || nt > kMaxHlen || !tile_fits(lr, lc, f, gc, 1, threads) ||
      lc % (kColStrip * (f / gc)) || !grid_fits(B, Mr, Mc, f, lr, lc, gc, gx, gy, gz))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    if (lr % kRowStrip<S> ||
        (size_t)smem != ns_inv_smem<S>(rank, g.stride, offmax, lr, lc, f / gc, nt))
      return cudaErrorInvalidValue;
    return with_rank(rank, [&](auto rk) -> cudaError_t {
      constexpr int R = decltype(rk)::value;
      auto kernel = ns_inv_mxu_kernel<S, R>;
      cudaError_t e2 = prepare(kernel, smem);
      if (e2 != cudaSuccess) return e2;
      kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
          a, h, v, d, out, det_bf16, out_bf16, B, Mr, Mc, hlen, f, g, taps, lr, lc, gc, nt);
      return cudaGetLastError();
    });
  });
}

// The a-trous wrappers' entry points: the same kernels, counted apart by the
// wrappers (kernels/ns_matmul.py).
extern "C" int pdwt_ns_swt_fwd_level_2d_mxu(const void* x, float* a, void* h, void* v, void* d,
                                            int B, int R, int C, const float* taps, int hlen,
                                            int rank, int stride, int f, int cen, int scheme,
                                            int in_bf16, int det_bf16, int lr, int lc, int gc,
                                            int nt, int threads, int gx, int gy, int gz,
                                            int smem, void* stream) {
  return pdwt_ns_fwd_level_2d_mxu(x, a, h, v, d, B, R, C, taps, hlen, rank, stride, f, cen,
                                  scheme, in_bf16, det_bf16, lr, lc, gc, nt, threads, gx, gy,
                                  gz, smem, stream);
}

extern "C" int pdwt_ns_swt_inv_level_2d_mxu(const float* a, const void* h, const void* v,
                                            const void* d, void* out, int B, int Mr, int Mc,
                                            const float* taps, int hlen, int rank, int f,
                                            const int* geo, int scheme, int det_bf16,
                                            int out_bf16, int lr, int lc, int gc, int nt,
                                            int threads, int gx, int gy, int gz, int smem,
                                            void* stream) {
  return pdwt_ns_inv_level_2d_mxu(a, h, v, d, out, B, Mr, Mc, taps, hlen, rank, f, geo, scheme,
                                  det_bf16, out_bf16, lr, lc, gc, nt, threads, gx, gy, gz, smem,
                                  stream);
}
