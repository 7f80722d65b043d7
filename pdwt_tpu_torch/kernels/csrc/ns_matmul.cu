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
// Layout.  A block owns a 32 x 32 tile of outputs (forward) or of subband
// positions (inverse); at f > 1 the tile's positions along each axis are one
// residue class mod f (mxu_common.cuh: Axis), so the staged windows do not
// grow with the level.  The taps (at most 4 x 5 filters of 40 taps, both
// terms) come from a small device buffer and are staged once per block.
//
// Bound.  At 2048^2 a rank-3 level reads 8 MiB (bf16) and writes 4 MiB of
// float32 plus 6 MiB of bf16 (5.6 us at 3.35 TB/s); with 8 taps it does
// 1.5 r R C hlen = 150 M multiply-adds per term (decimated), 0.3 GFLOP, about
// 5 us on the float32 cores for b1: balanced, as the separable kernels.  Each
// input sample is staged once per window and split then; the temps never
// leave shared memory.  Tensor cores over band tiles are later work.

#include "mxu_common.cuh"

namespace {

using namespace pdwt_mxu;

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

__device__ __forceinline__ float lane(const float4& t, int s) {
  return s == 0 ? t.x : (s == 1 ? t.y : (s == 2 ? t.z : t.w));
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

// The inverse's phases (see the file's index spec), from the int array
// kernels/ns_matmul.py passes: stride, org, p[0], p[1], nb[0], nb[1],
// off[0], off[1].
struct Phase {
  int stride, org;
  int p[2], nb[2], off[2];
};

// ---------------------------------------------------------------------------
// Inverse level, polyphase or a-trous.  Replaces _ns_inv_kernel
// (ns_matmul_pallas.py:206).  Stages the W x W windows of the four subbands
// split; for each k synthesises along the rows, summing the four subbands
// (s outer, tap inner), into a shared temp (r x S LT x W), split again; then
// along the columns, summing the r temps (k outer, tap inner), and writes each
// output (pair, when decimated) once.
// ---------------------------------------------------------------------------
template <int S, typename TD, typename TO>
__global__ void __launch_bounds__(BX * BY)
ns_inv_mxu_kernel(const float* __restrict__ a, const TD* __restrict__ h,
                  const TD* __restrict__ v, const TD* __restrict__ d, TO* __restrict__ out,
                  int B, int Mr, int Mc, int hlen, int rank, int f, int frr, int frc, int W,
                  const Phase g, const float* __restrict__ taps) {
  using St = Stage<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nd = kDataLo<S> ? 2 : 1;
  const int WW = W * W;
  const int st = g.stride, SL = g.stride * LT;
  St* sb = reinterpret_cast<St*>(smem_raw);  // band s, operand e at sb + (s*nd + e)*WW
  St* tk1 = sb + 4 * nd * WW;                 // r x SL x W, rows synthesised per k
  St* tk2 = tk1 + rank * SL * W;
  __shared__ float2 ct[kMaxRank * kMaxHlen];
  __shared__ float4 rt1[kMaxRank * kMaxHlen], rt2[kMaxRank * kMaxHlen];
  stage_ns_taps(ct, rt1, rt2, taps, rank, hlen);
  const Axis ar = axis_of<LT>(blockIdx.y, frr, f), ac = axis_of<LT>(blockIdx.x, frc, f);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int Ro = st * Mr, Co = st * Mc;

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    for (int i = ty; i < W; i += BY) {
      const size_t roff = ((size_t)b * Mr + wrapl(ar.at(i - g.org), Mr)) * Mc;
      for (int j = tx; j < W; j += BX) {
        const size_t o = roff + wrapl(ac.at(j - g.org), Mc);
        const int k = i * W + j;
        stage<S>(__ldg(a + o), sb, sb + WW, k);
        stage<S>(load_f(h + o), sb + nd * WW, sb + (nd + 1) * WW, k);
        stage<S>(load_f(v + o), sb + 2 * nd * WW, sb + (2 * nd + 1) * WW, k);
        stage<S>(load_f(d + o), sb + 3 * nd * WW, sb + (3 * nd + 1) * WW, k);
      }
    }
    __syncthreads();

    // along the rows: temp row r2 = S tt + q of every window column, per k
    for (int r2 = ty; r2 < SL; r2 += BY) {
      const int tt = r2 / st, q = r2 % st;
      const int p = g.p[q], nb = g.nb[q], base = (tt + g.off[q]) * W;
      for (int col = tx; col < W; col += BX) {
        for (int k = 0; k < rank; ++k) {
          Acc<S> acc;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const St* b1 = sb + s * nd * WW;
            for (int bb = 0; bb < nb; ++bb) {
              const int i = base + bb * W + col;
              const float d2 = kDataLo<S> ? to_f(b1[i + WW]) : 0.f;
              const int e = k * hlen + p + st * bb;
              acc.add(lane(rt1[e], s), lane(rt2[e], s), to_f(b1[i]), d2);
            }
          }
          stage<S>(acc.total(), tk1, tk2, (k * SL + r2) * W + col);
        }
      }
    }
    __syncthreads();

    // along the columns: output column S (position of tx) + q, summing over k
    for (int r2 = ty; r2 < SL; r2 += BY) {
      float res[2] = {0.f, 0.f};
      for (int q = 0; q < st; ++q) {
        const int p = g.p[q], nb = g.nb[q];
        Acc<S> acc;
        for (int k = 0; k < rank; ++k) {
          const int base = (k * SL + r2) * W + tx + g.off[q];
          for (int bb = 0; bb < nb; ++bb) {
            const float d2 = kDataLo<S> ? to_f(tk2[base + bb]) : 0.f;
            const float2 t = ct[k * hlen + p + st * bb];
            acc.add(t.x, t.y, to_f(tk1[base + bb]), d2);
          }
        }
        res[q] = acc.total();
      }
      const long long orow = st * ar.at(r2 / st) + r2 % st, ocol = st * ac.at(tx);
      if (orow < Ro && ocol < Co) {
        TO* po = out + ((size_t)b * Ro + orow) * Co + ocol;
        if (st == 2)
          store_pair(po, res[0], res[1]);
        else
          *po = from_f<TO>(res[0]);
      }
    }
    __syncthreads();
  }
}

cudaError_t check(int B, int hlen, int rank) {
  if (hlen < 2 || hlen > kMaxHlen || rank < 1 || rank > kMaxRank || B < 1)
    return cudaErrorInvalidValue;
  return cudaSuccess;
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
// output is (B, stride Mr, stride Mc).
extern "C" int pdwt_ns_inv_level_2d_mxu(const float* a, const void* h, const void* v,
                                        const void* d, void* out, int B, int Mr, int Mc,
                                        const float* taps, int hlen, int rank, int f,
                                        const int* geo, int scheme, int det_bf16, int out_bf16,
                                        void* stream) {
  cudaError_t e = check(B, hlen, rank);
  if (e != cudaSuccess) return e;
  const Phase g = {geo[0], geo[1], {geo[2], geo[3]}, {geo[4], geo[5]}, {geo[6], geo[7]}};
  if (Mr < 1 || Mc < 1 || f < 1 || !(g.stride == 1 || (g.stride == 2 && f == 1)))
    return cudaErrorInvalidValue;
  int span = 0;
  for (int q = 0; q < g.stride; ++q) {
    if (g.off[q] < 0 || g.p[q] < 0 || g.p[q] + g.stride * (g.nb[q] - 1) >= hlen)
      return cudaErrorInvalidValue;
    span = span > g.off[q] + g.nb[q] - 1 ? span : g.off[q] + g.nb[q] - 1;
  }
  const int W = LT + span;
  dim3 grid;
  int frr, frc;
  e = ns_grid(B, Mr, Mc, f, &grid, &frr, &frc);
  if (e != cudaSuccess) return e;
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    return with_type(det_bf16, [&](auto td) {
      using TD = typename decltype(td)::type;
      return with_type(out_bf16, [&](auto to) -> cudaError_t {
        using TO = typename decltype(to)::type;
        constexpr int nd = kDataLo<S> ? 2 : 1;
        const size_t smem =
            sizeof(Stage<S>) * nd * (4 * (size_t)W * W + (size_t)rank * g.stride * LT * W);
        auto kernel = ns_inv_mxu_kernel<S, TD, TO>;
        cudaError_t e2 = prepare(kernel, smem, kNsTapsSmem);
        if (e2 != cudaSuccess) return e2;
        kernel<<<grid, dim3(BX, BY), smem, (cudaStream_t)stream>>>(
            a, static_cast<const TD*>(h), static_cast<const TD*>(v), static_cast<const TD*>(d),
            static_cast<TO*>(out), B, Mr, Mc, hlen, rank, f, frr, frc, W, g, taps);
        return cudaGetLastError();
      });
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
                                            int out_bf16, void* stream) {
  return pdwt_ns_inv_level_2d_mxu(a, h, v, d, out, B, Mr, Mc, taps, hlen, rank, f, geo, scheme,
                                  det_bf16, out_bf16, stream);
}
