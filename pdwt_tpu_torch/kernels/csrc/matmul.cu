// The 2D level kernels of the precision tiers for Hopper (sm_90a), with a plain
// C interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py links
// this file with the other sources into one library).
//
// Two kernels, one per Pallas kernel of pdwt_tpu/kernels/matmul_pallas.py:
//
//   fwd_mxu_kernel  <- _fwd_mxu_kernel  (matmul_pallas.py:242)
//   inv_mxu_kernel  <- _inv_mxu_kernel  (matmul_pallas.py:360)
//
// On the TPU each pass of a level is a banded matrix product on the MXU in a
// compute scheme (b1, fd, b2f, b2d, b3; mxu_common.cuh states each).  Here the
// band is evaluated directly on the CUDA cores: every output sums only its
// hlen non-zero band entries, with the operands rounded per scheme as they are
// staged in shared memory.  The index spec is core/conv.py's, as in
// separable.cu:
//   analysis   out[n]      = sum_j t[j] * x[(2n - cen + j) mod N]
//   synthesis  out[2m + q] = sum_band sum_b t_band[p_q + 2b] * x_band[(m + o_q + b) mod M]
// Unlike separable.cu, a level runs its rows (axis -2) first, then its
// columns, as the TPU kernel does (A @ x, then t @ B), and the float32 result
// of the row pass is split per scheme before the column pass: for b1 and b2f
// it is rounded to bf16, so the order shows at bf16 level.
//
// Types.  The forward reads float32 or bf16 and writes a float32
// approximation and float32 or bf16 details; the inverse reads a float32
// approximation with float32 or bf16 details and writes float32 or bf16.  Each
// pair is a template instance; bf16 is loaded and stored 2 bytes at a time, so
// a window that starts on an odd column needs no alignment.
//
// Bound.  At 2048^2 the bf16 level 1 forward moves 8 MiB in and 10 MiB out
// (5.6 us at 3.35 TB/s), while b3 does three products per tap and pass, about
// 0.7 GFLOP per level on the float32 cores (10 us at 67 TFLOP/s): the higher
// schemes are bound by operations, b1 and fd come close to the bytes.  Design
// against that: each input is split once, when it is staged, never per tap;
// the staged operands are bf16 (half the shared memory, conflict-free reads at
// the column pass's stride 2), float32 only for fd; the row-pass result never
// leaves shared memory.  Tensor cores (mma/wgmma over band tiles) are later
// work.

#include "mxu_common.cuh"

namespace {

using namespace pdwt_mxu;

// A block owns an LT x LT tile of coefficients (forward: of each output
// subband; inverse: of each input subband) and runs BX x BY threads.
constexpr int LT = 32;
constexpr int BX = 32;
constexpr int BY = 8;

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// ---------------------------------------------------------------------------
// Forward level.  Replaces _fwd_mxu_kernel (matmul_pallas.py:242).
// The block stages its W x W input window (W = 2*LT + hlen - 2) split into
// the scheme's operands, with the periodic index; runs the dual pass along
// the rows for all W window columns into a shared temp, split again; then the
// dual pass along the columns, and writes A, H, V, D once.
// ---------------------------------------------------------------------------
template <int S, typename TI, typename TD>
__global__ void __launch_bounds__(BX * BY)
fwd_mxu_kernel(const TI* __restrict__ x, float* __restrict__ a, TD* __restrict__ h,
               TD* __restrict__ v, TD* __restrict__ d, int B, int R, int C, int hlen,
               int cen, const __grid_constant__ Taps4 tp) {
  using St = Stage<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nd = kDataLo<S> ? 2 : 1;
  const int W = 2 * LT + hlen - 2;
  St* in1 = reinterpret_cast<St*>(smem_raw);  // W x W window, first operand
  St* in2 = in1 + W * W;                       // second operand (b2d, b3)
  St* tl1 = in1 + nd * W * W;                  // LT x W, low-pass along the rows
  St* tl2 = tl1 + LT * W;
  St* th1 = tl1 + nd * LT * W;                 // LT x W, high-pass along the rows
  St* th2 = th1 + LT * W;
  __shared__ float4 tq[PDWT_MXU_MAX_HLEN];
  stage_taps(tq, tp, hlen);
  const int Mr = R / 2, Mc = C / 2;
  const int m0 = blockIdx.y * LT, n0 = blockIdx.x * LT;
  const int r0 = 2 * m0 - cen, c0 = 2 * n0 - cen;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const TI* xb = x + (size_t)b * R * C;
    for (int i = ty; i < W; i += BY) {
      const TI* row = xb + (size_t)wrap(r0 + i, R) * C;
      for (int j = tx; j < W; j += BX) stage<S>(load_f(row + wrap(c0 + j, C)), in1, in2, i * W + j);
    }
    __syncthreads();

    // along the rows: output row mm of every window column
    for (int mm = ty; mm < LT; mm += BY) {
      for (int col = tx; col < W; col += BX) {
        Acc<S> lo, hi;
        const int base = 2 * mm * W + col;
        for (int j = 0; j < hlen; ++j) {
          const float d1 = to_f(in1[base + j * W]);
          const float d2 = kDataLo<S> ? to_f(in2[base + j * W]) : 0.f;
          const float4 t = tq[j];
          lo.add(t.x, t.y, d1, d2);
          hi.add(t.z, t.w, d1, d2);
        }
        stage<S>(lo.total(), tl1, tl2, mm * W + col);
        stage<S>(hi.total(), th1, th2, mm * W + col);
      }
    }
    __syncthreads();

    // along the columns: A = lo(lo rows), V = hi cols of lo rows, H = lo cols
    // of hi rows, D = hi(hi rows)
    const int n = n0 + tx;
    for (int mm = ty; mm < LT; mm += BY) {
      Acc<S> aa, vv, hh, dd;
      const int base = mm * W + 2 * tx;
      for (int j = 0; j < hlen; ++j) {
        const float l1 = to_f(tl1[base + j]), g1 = to_f(th1[base + j]);
        const float l2 = kDataLo<S> ? to_f(tl2[base + j]) : 0.f;
        const float g2 = kDataLo<S> ? to_f(th2[base + j]) : 0.f;
        const float4 t = tq[j];
        aa.add(t.x, t.y, l1, l2);
        vv.add(t.z, t.w, l1, l2);
        hh.add(t.x, t.y, g1, g2);
        dd.add(t.z, t.w, g1, g2);
      }
      const int m = m0 + mm;
      if (m < Mr && n < Mc) {
        const size_t o = ((size_t)b * Mr + m) * Mc + n;
        a[o] = aa.total();
        h[o] = from_f<TD>(hh.total());
        v[o] = from_f<TD>(vv.total());
        d[o] = from_f<TD>(dd.total());
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Inverse level.  Replaces _inv_mxu_kernel (matmul_pallas.py:360).
// The block stages the W x W windows of the four subbands (W = LT + lo + hi
// of poly_geometry) split into the scheme's operands; synthesises along the
// rows into two shared temps, (A, H) and (V, D), each with both output
// parities, split again; then along the columns, and writes each output pair
// (2u, 2u + 1) as one 8- or 4-byte store.
// ---------------------------------------------------------------------------
template <int S, typename TD, typename TO>
__global__ void __launch_bounds__(BX * BY)
inv_mxu_kernel(const float* __restrict__ a, const TD* __restrict__ h,
               const TD* __restrict__ v, const TD* __restrict__ d, TO* __restrict__ out,
               int B, int Mr, int Mc, int hlen, const Poly g,
               const __grid_constant__ Taps4 tp) {
  using St = Stage<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nd = kDataLo<S> ? 2 : 1;
  const int W = LT + g.lo + g.hi;
  const int WW = W * W;
  St* s = reinterpret_cast<St*>(smem_raw);  // band k, operand e at s + (k*nd + e)*WW
  St* sa = s;
  St* sh = s + nd * WW;
  St* sv = s + 2 * nd * WW;
  St* sd = s + 3 * nd * WW;
  St* t1 = s + 4 * nd * WW;            // 2LT x W, rows synthesised from (A, H)
  St* t2 = t1 + nd * 2 * LT * W;       // 2LT x W, rows synthesised from (V, D)
  const int TW = 2 * LT * W;           // offset of a temp's second operand
  __shared__ float4 tq[PDWT_MXU_MAX_HLEN];
  stage_taps(tq, tp, hlen);
  const int R = 2 * Mr, C = 2 * Mc;
  const int t0 = blockIdx.y * LT, u0 = blockIdx.x * LT;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const size_t boff = (size_t)b * Mr * Mc;
    for (int i = ty; i < W; i += BY) {
      const size_t roff = boff + (size_t)wrap(t0 - g.lo + i, Mr) * Mc;
      for (int j = tx; j < W; j += BX) {
        const size_t o = roff + wrap(u0 - g.lo + j, Mc);
        const int k = i * W + j;
        stage<S>(__ldg(a + o), sa, sa + WW, k);
        stage<S>(load_f(h + o), sh, sh + WW, k);
        stage<S>(load_f(v + o), sv, sv + WW, k);
        stage<S>(load_f(d + o), sd, sd + WW, k);
      }
    }
    __syncthreads();

    // along the rows: output rows 2t and 2t+1 of every window column
    for (int t = ty; t < LT; t += BY) {
      for (int col = tx; col < W; col += BX) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int p = g.p[q], nb = g.nb[q];
          const int base = (t + g.o[q] + g.lo) * W + col;
          Acc<S> acc1, acc2;
          for (int k = 0; k < nb; ++k) {
            const int i = base + k * W;
            const float x1 = kDataLo<S> ? to_f(sa[i + WW]) : 0.f;
            const float y1 = kDataLo<S> ? to_f(sv[i + WW]) : 0.f;
            const float4 t = tq[p + 2 * k];
            acc1.add(t.x, t.y, to_f(sa[i]), x1);
            acc2.add(t.x, t.y, to_f(sv[i]), y1);
          }
          for (int k = 0; k < nb; ++k) {
            const int i = base + k * W;
            const float x1 = kDataLo<S> ? to_f(sh[i + WW]) : 0.f;
            const float y1 = kDataLo<S> ? to_f(sd[i + WW]) : 0.f;
            const float4 t = tq[p + 2 * k];
            acc1.add(t.z, t.w, to_f(sh[i]), x1);
            acc2.add(t.z, t.w, to_f(sd[i]), y1);
          }
          stage<S>(acc1.total(), t1, t1 + TW, (2 * t + q) * W + col);
          stage<S>(acc2.total(), t2, t2 + TW, (2 * t + q) * W + col);
        }
      }
    }
    __syncthreads();

    // along the columns: output columns 2u and 2u+1, u = u0 + tx
    for (int r2 = ty; r2 < 2 * LT; r2 += BY) {
      float res[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = g.p[q], nb = g.nb[q];
        const int base = r2 * W + tx + g.o[q] + g.lo;
        Acc<S> acc;
        for (int k = 0; k < nb; ++k) {
          const float x1 = kDataLo<S> ? to_f(t1[base + k + TW]) : 0.f;
          const float4 t = tq[p + 2 * k];
          acc.add(t.x, t.y, to_f(t1[base + k]), x1);
        }
        for (int k = 0; k < nb; ++k) {
          const float x1 = kDataLo<S> ? to_f(t2[base + k + TW]) : 0.f;
          const float4 t = tq[p + 2 * k];
          acc.add(t.z, t.w, to_f(t2[base + k]), x1);
        }
        res[q] = acc.total();
      }
      const int orow = 2 * t0 + r2, ocol = 2 * (u0 + tx);
      if (orow < R && ocol < C) store_pair(out + ((size_t)b * R + orow) * C + ocol, res[0], res[1]);
    }
    __syncthreads();
  }
}

dim3 level_grid(int Mr, int Mc, int B) {
  return dim3((Mc + LT - 1) / LT, (Mr + LT - 1) / LT, B < 65535 ? B : 65535);
}

}  // namespace

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).
// `scheme` is the index in kernels/matmul.py:SCHEMES; the *_bf16 flags pick
// bf16 (1) or float32 (0) storage.

extern "C" int pdwt_fwd_level_2d_mxu(const void* x, float* a, void* h, void* v, void* d, int B,
                                     int R, int C, const float* lo1, const float* lo2,
                                     const float* hi1, const float* hi2, int hlen, int cen,
                                     int scheme, int in_bf16, int det_bf16, void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || R < 2 || C < 2 || ((R | C) & 1))
    return cudaErrorInvalidValue;
  const dim3 grid = level_grid(R / 2, C / 2, B);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  const Taps4 tp = make_taps4(lo1, lo2, hi1, hi2, hlen);
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    return with_type(in_bf16, [&](auto ti) {
      using TI = typename decltype(ti)::type;
      return with_type(det_bf16, [&](auto td) -> cudaError_t {
        using TD = typename decltype(td)::type;
        constexpr int nd = kDataLo<S> ? 2 : 1;
        const size_t W = 2 * LT + hlen - 2;
        const size_t smem = sizeof(Stage<S>) * nd * (W * W + 2 * LT * W);
        auto kernel = fwd_mxu_kernel<S, TI, TD>;
        cudaError_t e = prepare(kernel, smem);
        if (e != cudaSuccess) return e;
        kernel<<<grid, dim3(BX, BY), smem, (cudaStream_t)stream>>>(
            static_cast<const TI*>(x), a, static_cast<TD*>(h), static_cast<TD*>(v),
            static_cast<TD*>(d), B, R, C, hlen, cen, tp);
        return cudaGetLastError();
      });
    });
  });
}

// geo: p[0], p[1], o[0], o[1], nb[0], nb[1], lo, hi of poly_geometry(hlen).
extern "C" int pdwt_inv_level_2d_mxu(const float* a, const void* h, const void* v, const void* d,
                                     void* out, int B, int Mr, int Mc, const float* lo1,
                                     const float* lo2, const float* hi1, const float* hi2,
                                     int hlen, const int* geo, int scheme, int det_bf16,
                                     int out_bf16, void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || Mr < 1 || Mc < 1)
    return cudaErrorInvalidValue;
  const Poly g = make_poly(geo);
  const dim3 grid = level_grid(Mr, Mc, B);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  const Taps4 tp = make_taps4(lo1, lo2, hi1, hi2, hlen);
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    return with_type(det_bf16, [&](auto td) {
      using TD = typename decltype(td)::type;
      return with_type(out_bf16, [&](auto to) -> cudaError_t {
        using TO = typename decltype(to)::type;
        constexpr int nd = kDataLo<S> ? 2 : 1;
        const size_t W = LT + g.lo + g.hi;
        const size_t smem = sizeof(Stage<S>) * nd * (4 * W * W + 4 * LT * W);
        auto kernel = inv_mxu_kernel<S, TD, TO>;
        cudaError_t e = prepare(kernel, smem);
        if (e != cudaSuccess) return e;
        kernel<<<grid, dim3(BX, BY), smem, (cudaStream_t)stream>>>(
            a, static_cast<const TD*>(h), static_cast<const TD*>(v), static_cast<const TD*>(d),
            static_cast<TO*>(out), B, Mr, Mc, hlen, g, tp);
        return cudaGetLastError();
      });
    });
  });
}
