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
// Layout.  The forward's block owns a 32 x 32 tile of outputs; at f > 1 the
// tile's positions along each axis are one residue class mod f
// (mxu_common.cuh: Axis), so the staged windows do not grow with the level.
// The inverse (redesigned for Hopper's CUDA cores, band_strip.cuh) takes its
// tile, its column layout and its block size from a launch plan made on the
// host; its own comment below says how.  The taps (at most 4 x 5 filters of
// 40 taps, both terms) come from a small device buffer and are staged once
// per block.
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

constexpr int LT = 32;
constexpr int BX = 32;
constexpr int BY = 8;
constexpr int kMaxRank = 4;
constexpr int kMaxHlen = 40;
constexpr size_t kNsTapsSmem = kMaxRank * kMaxHlen * (sizeof(float2) + 2 * sizeof(float4));

// The block's copy of the taps buffer (rank, 5, 2, hlen) float32, filter 0 of
// term k the column filter b_k, filters 1-4 the row filters a_k^(s), each as
// (first, second) value of the scheme: ct[k*hlen + j] = (b_k first, second);
// rt1/rt2[k*hlen + j] = the four a_k^(s) first / second values.
__device__ __forceinline__ void stage_ns_taps(float2* ct, float4* rt1, float4* rt2,
                                              const float* __restrict__ taps, int rank,
                                              int hlen) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = t; e < rank * hlen; e += blockDim.x * blockDim.y) {
    const int k = e / hlen, j = e % hlen;
    const float* base = taps + (size_t)k * 10 * hlen + j;  // filter g, value e2 at (2g + e2)*hlen
    ct[e] = make_float2(__ldg(base), __ldg(base + hlen));
    rt1[e] = make_float4(__ldg(base + 2 * hlen), __ldg(base + 4 * hlen), __ldg(base + 6 * hlen),
                         __ldg(base + 8 * hlen));
    rt2[e] = make_float4(__ldg(base + 3 * hlen), __ldg(base + 5 * hlen), __ldg(base + 7 * hlen),
                         __ldg(base + 9 * hlen));
  }
}

// ---------------------------------------------------------------------------
// Forward level, stride 2 or 1.  Replaces _ns_fwd_kernel
// (ns_matmul_pallas.py:100).  Stages the W x W window (W = S LT + hlen - S)
// split into the scheme's operands; filters every window row along the
// columns with each b_k into a shared temp (r x W x LT), split again; then
// sums each subband's row filters over (k, tap) and writes A, H, V, D once.
// ---------------------------------------------------------------------------
template <int S, typename TI, typename TD>
__global__ void __launch_bounds__(BX * BY)
ns_fwd_mxu_kernel(const TI* __restrict__ x, float* __restrict__ a, TD* __restrict__ h,
                  TD* __restrict__ v, TD* __restrict__ d, int B, int R, int C, int Ro, int Co,
                  int hlen, int rank, int stride, int f, int cen, int frr, int frc,
                  const float* __restrict__ taps) {
  using St = Stage<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nd = kDataLo<S> ? 2 : 1;
  const int W = stride * LT + hlen - stride;
  St* in1 = reinterpret_cast<St*>(smem_raw);  // W x W window
  St* in2 = in1 + W * W;
  St* tk1 = in1 + nd * W * W;                  // r x W x LT, column-filtered rows
  St* tk2 = tk1 + rank * W * LT;
  __shared__ float2 ct[kMaxRank * kMaxHlen];
  __shared__ float4 rt1[kMaxRank * kMaxHlen], rt2[kMaxRank * kMaxHlen];
  stage_ns_taps(ct, rt1, rt2, taps, rank, hlen);
  const Axis ar = axis_of<LT>(blockIdx.y, frr, f), ac = axis_of<LT>(blockIdx.x, frc, f);
  const int tx = threadIdx.x, ty = threadIdx.y;
  // input position of window entry i: S rho + (S q0 + i - cen) f
  auto in_pos = [&](const Axis& ax, int i) {
    return stride * ax.rho + (static_cast<long long>(stride) * ax.q0 + i - cen) * ax.f;
  };

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const TI* xb = x + (size_t)b * R * C;
    for (int i = ty; i < W; i += BY) {
      const TI* row = xb + (size_t)wrapl(in_pos(ar, i), R) * C;
      for (int j = tx; j < W; j += BX) stage<S>(load_f(row + wrapl(in_pos(ac, j), C)), in1, in2, i * W + j);
    }
    __syncthreads();

    // along the columns: t_k of every window row at output column tx
    for (int i = ty; i < W; i += BY) {
      const int base = i * W + stride * tx;
      for (int k = 0; k < rank; ++k) {
        Acc<S> acc;
        for (int j = 0; j < hlen; ++j) {
          const float d2 = kDataLo<S> ? to_f(in2[base + j]) : 0.f;
          const float2 t = ct[k * hlen + j];
          acc.add(t.x, t.y, to_f(in1[base + j]), d2);
        }
        stage<S>(acc.total(), tk1, tk2, (k * W + i) * LT + tx);
      }
    }
    __syncthreads();

    // along the rows: each subband sums its row filters over (k, tap)
    const long long c = ac.at(tx);
    for (int tt = ty; tt < LT; tt += BY) {
      Acc<S> o[4];
      for (int k = 0; k < rank; ++k) {
        for (int j = 0; j < hlen; ++j) {
          const int i = (k * W + stride * tt + j) * LT + tx;
          const float d1 = to_f(tk1[i]);
          const float d2 = kDataLo<S> ? to_f(tk2[i]) : 0.f;
          const float4 t1 = rt1[k * hlen + j], t2 = rt2[k * hlen + j];
          o[0].add(t1.x, t2.x, d1, d2);
          o[1].add(t1.y, t2.y, d1, d2);
          o[2].add(t1.z, t2.z, d1, d2);
          o[3].add(t1.w, t2.w, d1, d2);
        }
      }
      const long long r = ar.at(tt);
      if (r < Ro && c < Co) {
        const size_t oi = ((size_t)b * Ro + r) * Co + c;
        a[oi] = o[0].total();
        h[oi] = from_f<TD>(o[1].total());
        v[oi] = from_f<TD>(o[2].total());
        d[oi] = from_f<TD>(o[3].total());
      }
    }
    __syncthreads();
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
constexpr int kInvCh = 4;       // taps per chunk of the inverse's strips
constexpr int kStageLoads = 16;  // loads in flight per thread while staging

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
        band_strip<S, PR, R, kInvCh>(acc, win + (r0 + g.off[q]) * WC + w, WR * WC, BS, 4, WC,
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
        band_strip<S, PC, 1, kInvCh>(acc, tmp + r2 * TP + t0 + g.off[q] * dc, TR * TP, TS, R, dc,
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

// Grid over (Mr, Mc) tile positions at dilation f, batch in z.
cudaError_t ns_grid(int B, int Mr, int Mc, int f, dim3* grid, int* frr, int* frc) {
  const long long gx = axis_blocks(Mc, f, LT), gy = axis_blocks(Mr, f, LT);
  if (gy > 65535 || gx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)gx, (unsigned)gy, B < 65535 ? B : 65535);
  *frr = f < Mr ? f : Mr;
  *frc = f < Mc ? f : Mc;
  return cudaSuccess;
}

}  // namespace

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).
// `taps` is the (rank, 5, 2, hlen) float32 device buffer described above;
// `scheme` the index in kernels/matmul.py:SCHEMES; the *_bf16 flags pick bf16
// (1) or float32 (0) storage.

// stride 2 (f = 1, even R and C, outputs R/2 x C/2) or 1 (dilation f,
// outputs R x C); cen = fwd_center(hlen).
extern "C" int pdwt_ns_fwd_level_2d_mxu(const void* x, float* a, void* h, void* v, void* d,
                                        int B, int R, int C, const float* taps, int hlen,
                                        int rank, int stride, int f, int cen, int scheme,
                                        int in_bf16, int det_bf16, void* stream) {
  cudaError_t e = check(B, hlen, rank);
  if (e != cudaSuccess) return e;
  if (R < 1 || C < 1 || f < 1 || !(stride == 1 || (stride == 2 && f == 1 && !((R | C) & 1))))
    return cudaErrorInvalidValue;
  const int Ro = R / stride, Co = C / stride;
  dim3 grid;
  int frr, frc;
  e = ns_grid(B, Ro, Co, f, &grid, &frr, &frc);
  if (e != cudaSuccess) return e;
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    return with_type(in_bf16, [&](auto ti) {
      using TI = typename decltype(ti)::type;
      return with_type(det_bf16, [&](auto td) -> cudaError_t {
        using TD = typename decltype(td)::type;
        constexpr int nd = kDataLo<S> ? 2 : 1;
        const size_t W = stride * LT + hlen - stride;
        const size_t smem = sizeof(Stage<S>) * nd * (W * W + (size_t)rank * W * LT);
        auto kernel = ns_fwd_mxu_kernel<S, TI, TD>;
        cudaError_t e2 = prepare(kernel, smem, kNsTapsSmem);
        if (e2 != cudaSuccess) return e2;
        kernel<<<grid, dim3(BX, BY), smem, (cudaStream_t)stream>>>(
            static_cast<const TI*>(x), a, static_cast<TD*>(h), static_cast<TD*>(v),
            static_cast<TD*>(d), B, R, C, Ro, Co, hlen, rank, stride, f, cen, frr, frc, taps);
        return cudaGetLastError();
      });
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
  if (nt % kInvCh || nt > kMaxHlen || !(gc == 1 || gc == f) || lr < 1 || lc < 1 ||
      threads < 32 || threads > 256 || threads % 32 || lc % (kColStrip * (f / gc)))
    return cudaErrorInvalidValue;
  const long long want_x = gc == 1 ? (Mc + (long long)lc - 1) / lc : axis_blocks(Mc, f, lc);
  if (gx != want_x || gy != axis_blocks(Mr, f, lr) || gy > 65535 || gz != (B < 65535 ? B : 65535))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    if (lr % kRowStrip<S> ||
        (size_t)smem != ns_inv_smem<S>(rank, g.stride, offmax, lr, lc, f / gc, nt))
      return cudaErrorInvalidValue;
    return with_rank(rank, [&](auto rk) -> cudaError_t {
      constexpr int R = decltype(rk)::value;
      auto kernel = ns_inv_mxu_kernel<S, R>;
      cudaError_t e2 = prepare(kernel, smem, 0);
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
                                            int in_bf16, int det_bf16, void* stream) {
  return pdwt_ns_fwd_level_2d_mxu(x, a, h, v, d, B, R, C, taps, hlen, rank, stride, f, cen,
                                  scheme, in_bf16, det_bf16, stream);
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
