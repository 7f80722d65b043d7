// The batched 1D level kernels of the precision tiers for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py).
//
// Two kernels per Pallas kernel of pdwt_tpu/kernels/mxu1d_pallas.py, each
// with a decimated and an a-trous instance (the TPU kernels' stride 2 and
// dilated band matrices):
//
//   fwd1d_staged_kernel, fwd1d_mxu_kernel  <- _fwd1d_kernel  (mxu1d_pallas.py:102)
//   inv1d_staged_kernel, inv1d_mxu_kernel  <- _inv1d_kernel  (mxu1d_pallas.py:153)
//
// (the staged kernels where a block's windows fit shared memory, the direct
// ones where they do not, see Layout)
//
// Every kernel filters along the last axis of a (B, N) batch under a compute
// scheme (mxu_common.cuh), with the index spec of core/conv.py, t the
// reversed filter (correlation order):
//   decimated analysis   out[n]      = sum_j t[j] * x[(2n - cen + j) mod N]
//   polyphase synthesis  out[2m + q] = sum_band sum_b t_band[p_q + 2b] *
//                                      x_band[(m + o_q + b) mod M]
//   a-trous analysis     out[n] = sum_j t[j] * x[(n - cen + j*f) mod N]
//   a-trous synthesis    out[n] = sum_band sum_j t_band[j] * x_band[(n - cen + j*f) mod N]
// The wrappers (kernels/mxu1d.py) pass the offsets and fold the a-trous
// synthesis's 1/2 into the taps before they are split.
//
// Layout as batched1d.cu: the signal axis runs along the lanes; a block of NT
// threads is TW x RB, TW output positions of RB = NT / TW signals; the grid is
// one-dimensional.  Each row of the block stages the window of samples its TW
// outputs read (each band's, for a synthesis), split once into the scheme's
// operands (bf16, float32 for fd), in shared memory; the taps then read the
// window at stride 1 (2 for the decimated analysis), with no index wrap.
// Where a window outgrows shared memory (an a-trous dilation of thousands),
// the level runs the direct kernels instead, which read and split every
// sample per tap straight from memory through L1.  Both sum in the plain
// version's order, so they give the same bits.
//
// Bound: device memory.  A level reads its input once and writes its output
// once; at 1024 x 4096, sym8, b3 does 3 * 16 FMAs per output and filter on
// operands split once per sample, about 0.4 GFLOP at level 1, 6 us on the
// float32 cores against 7.5 us for the bytes.  Splitting each sample once per
// tap instead (the direct kernels) costs up to 2 * 16 conversions per output
// and filter; at the paths' shapes that ran 4-8x slower than the exact
// kernels of batched1d.cu on an H100.

#include "mxu_common.cuh"

namespace {

using namespace pdwt_mxu;

constexpr int NT = 256;  // threads per block
// dynamic shared memory a staged block may use beside its static copy of the taps
constexpr long long kStagedLimit = (long long)(kSmemLimit - kTapsSmem);

__device__ __forceinline__ long long wrapl(long long i, int n) {
  const long long r = i % n;
  return r < 0 ? r + n : r;
}

// The block's signal row and first output position (batched1d.cu's layout).
__device__ __forceinline__ void place(int ntile, long long& row, int& pos0) {
  const unsigned grp = blockIdx.x / ntile, t = blockIdx.x % ntile;
  row = (long long)grp * blockDim.y + threadIdx.y;
  pos0 = static_cast<int>(t) * (int)blockDim.x;
}

// acc += sum_b t[p + b*ts] * s[(k0 + b*step) mod N], b < cnt, the samples
// split per scheme as they are read.
template <int S, typename T>
__device__ __forceinline__ void fir(Acc<S>& acc, const T* __restrict__ s, int N, long long k0,
                                    int step, int cnt, const float* t1, const float* t2,
                                    int p, int ts) {
  const int st = step % N;
  long long k = wrapl(k0, N);
  for (int b = 0; b < cnt; ++b) {
    float d1, d2;
    split<S>(load_f(s + k), d1, d2);
    acc.add(t1[p + b * ts], t2[p + b * ts], d1, d2);
    k += st;
    if (k >= N) k -= N;
  }
}

// ---------------------------------------------------------------------------
// Analysis level, direct.  Replaces _fwd1d_kernel (mxu1d_pallas.py:102).  Output n
// of a signal: the two filters' sums from one walk over its taps (stride 2
// for the decimated level, dilation f for the a-trous one).
// ---------------------------------------------------------------------------
template <int S, typename TI, typename TD, bool DECIM>
__global__ void __launch_bounds__(NT)
fwd1d_mxu_kernel(const TI* __restrict__ x, float* __restrict__ lo, TD* __restrict__ hi,
                 int B, int N, int n_out, int hlen, int f, int cen, int ntile,
                 const __grid_constant__ Taps4 tp) {
  long long row;
  int pos0;
  place(ntile, row, pos0);
  const int n = pos0 + threadIdx.x;
  if (row >= B || n >= n_out) return;
  const TI* xr = x + (size_t)row * N;
  const int step = DECIM ? 1 : f;
  const int st = step % N;
  long long k = wrapl((DECIM ? 2LL * n : (long long)n) - cen, N);
  Acc<S> l, h;
  for (int j = 0; j < hlen; ++j) {
    float d1, d2;
    split<S>(load_f(xr + k), d1, d2);
    l.add(tp.lo1[j], tp.lo2[j], d1, d2);
    h.add(tp.hi1[j], tp.hi2[j], d1, d2);
    k += st;
    if (k >= N) k -= N;
  }
  const size_t o = (size_t)row * n_out + n;
  lo[o] = l.total();
  hi[o] = from_f<TD>(h.total());
}

// ---------------------------------------------------------------------------
// Synthesis level, direct.  Replaces _inv1d_kernel (mxu1d_pallas.py:153).  Decimated:
// thread m writes the output pair (2m, 2m + 1), each parity a half-length FIR
// over the lo band, then the hi band (no stuffed zeros are read).  A-trous:
// thread n sums the lo band's dilated FIR, then the hi band's.
// ---------------------------------------------------------------------------
template <int S, typename TD, typename TO, bool DECIM>
__global__ void __launch_bounds__(NT)
inv1d_mxu_kernel(const float* __restrict__ lo, const TD* __restrict__ hi, TO* __restrict__ out,
                 int B, int M, int hlen, int f, int cen, const Poly g, int ntile,
                 const __grid_constant__ Taps4 tp) {
  long long row;
  int pos0;
  place(ntile, row, pos0);
  const int m = pos0 + threadIdx.x;
  if (row >= B || m >= M) return;
  const float* lr = lo + (size_t)row * M;
  const TD* hr = hi + (size_t)row * M;
  if constexpr (DECIM) {
    float res[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      Acc<S> acc;
      const long long k0 = (long long)m + g.o[q];
      fir(acc, lr, M, k0, 1, g.nb[q], tp.lo1, tp.lo2, g.p[q], 2);
      fir(acc, hr, M, k0, 1, g.nb[q], tp.hi1, tp.hi2, g.p[q], 2);
      res[q] = acc.total();
    }
    store_pair(out + (size_t)row * 2 * M + 2 * m, res[0], res[1]);
  } else {
    Acc<S> acc;
    const long long k0 = (long long)m - cen;
    fir(acc, lr, M, k0, f, hlen, tp.lo1, tp.lo2, 0, 1);
    fir(acc, hr, M, k0, f, hlen, tp.hi1, tp.hi2, 0, 1);
    out[(size_t)row * M + m] = from_f<TO>(acc.total());
  }
}

// Stage the window s[(w0 + i) mod N], i < W, of one row, split into the
// scheme's operands s1[i] (and s2[i]); the row's TW threads share the work.
template <int S, typename T>
__device__ __forceinline__ void stage_row(const T* __restrict__ s, int N, long long w0, int W,
                                          Stage<S>* s1, Stage<S>* s2) {
  const bool inside = w0 >= 0 && w0 + W <= N;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    stage<S>(load_f(s + (inside ? w0 + i : wrapl(w0 + i, N))), s1, s2, i);
}

// ---------------------------------------------------------------------------
// Analysis level, staged.  Output n of a row reads window sample
// (DECIM ? 2 * tx : tx) + j * step, the window starting at (2n or n) - cen of
// the row's first output.  W = 2 * TW + hlen - 2 (decimated) or
// TW + (hlen - 1) * f (a-trous) per row.
// ---------------------------------------------------------------------------
template <int S, typename TI, typename TD, bool DECIM>
__global__ void __launch_bounds__(NT)
fwd1d_staged_kernel(const TI* __restrict__ x, float* __restrict__ lo, TD* __restrict__ hi,
                    int B, int N, int n_out, int hlen, int f, int cen, int ntile, int W,
                    const __grid_constant__ Taps4 tp) {
  using St = Stage<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float4 tq[PDWT_MXU_MAX_HLEN];
  constexpr int nd = kDataLo<S> ? 2 : 1;
  St* s1 = reinterpret_cast<St*>(smem_raw) + (size_t)threadIdx.y * nd * W;
  St* s2 = s1 + W;
  long long row;
  int pos0;
  place(ntile, row, pos0);
  stage_taps(tq, tp, hlen);
  if (row < B)
    stage_row<S>(x + (size_t)row * N, N, (DECIM ? 2LL * pos0 : (long long)pos0) - cen, W, s1,
                 s2);
  __syncthreads();
  const int n = pos0 + threadIdx.x;
  if (row >= B || n >= n_out) return;
  const int step = DECIM ? 1 : f;
  const int base = DECIM ? 2 * threadIdx.x : threadIdx.x;
  Acc<S> l, h;
  for (int j = 0; j < hlen; ++j) {
    const int i = base + j * step;
    const float d1 = to_f(s1[i]);
    const float d2 = kDataLo<S> ? to_f(s2[i]) : 0.f;
    const float4 t = tq[j];
    l.add(t.x, t.y, d1, d2);
    h.add(t.z, t.w, d1, d2);
  }
  const size_t o = (size_t)row * n_out + n;
  lo[o] = l.total();
  hi[o] = from_f<TD>(h.total());
}

// ---------------------------------------------------------------------------
// Synthesis level, staged: both bands' windows, W = TW + lo + hi of
// poly_geometry (decimated) or TW + (hlen - 1) * f (a-trous) per band.
// ---------------------------------------------------------------------------
template <int S, typename TD, typename TO, bool DECIM>
__global__ void __launch_bounds__(NT)
inv1d_staged_kernel(const float* __restrict__ lo, const TD* __restrict__ hi,
                    TO* __restrict__ out, int B, int M, int hlen, int f, int cen, const Poly g,
                    int ntile, int W, const __grid_constant__ Taps4 tp) {
  using St = Stage<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nd = kDataLo<S> ? 2 : 1;
  St* l1 = reinterpret_cast<St*>(smem_raw) + (size_t)threadIdx.y * 2 * nd * W;
  St* l2 = l1 + W;
  St* h1 = l1 + nd * W;
  St* h2 = h1 + W;
  __shared__ float4 tq[PDWT_MXU_MAX_HLEN];
  long long row;
  int pos0;
  place(ntile, row, pos0);
  stage_taps(tq, tp, hlen);
  const long long w0 = DECIM ? (long long)pos0 - g.lo : (long long)pos0 - cen;
  if (row < B) {
    stage_row<S>(lo + (size_t)row * M, M, w0, W, l1, l2);
    stage_row<S>(hi + (size_t)row * M, M, w0, W, h1, h2);
  }
  __syncthreads();
  const int m = pos0 + threadIdx.x;
  if (row >= B || m >= M) return;
  // one band's sum: its window (b1, b2), its taps (the lo or hi filter's)
  auto band = [&](Acc<S>& acc, const St* b1, const St* b2, bool hi_band, int i0, int step,
                  int cnt, int p, int ts) {
    for (int b = 0; b < cnt; ++b) {
      const int i = i0 + b * step;
      const float4 t = tq[p + b * ts];
      acc.add(hi_band ? t.z : t.x, hi_band ? t.w : t.y, to_f(b1[i]),
              kDataLo<S> ? to_f(b2[i]) : 0.f);
    }
  };
  if constexpr (DECIM) {
    float res[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      Acc<S> acc;
      const int i0 = threadIdx.x + g.lo + g.o[q];
      band(acc, l1, l2, false, i0, 1, g.nb[q], g.p[q], 2);
      band(acc, h1, h2, true, i0, 1, g.nb[q], g.p[q], 2);
      res[q] = acc.total();
    }
    store_pair(out + (size_t)row * 2 * M + 2 * m, res[0], res[1]);
  } else {
    Acc<S> acc;
    band(acc, l1, l2, false, threadIdx.x, f, hlen, 0, 1);
    band(acc, h1, h2, true, threadIdx.x, f, hlen, 0, 1);
    out[(size_t)row * M + m] = from_f<TO>(acc.total());
  }
}

// Block shape and grid for `npos` output positions per signal (batched1d.cu's
// geometry): TW a power of two in [32, NT], RB = NT / TW signals per block.
struct Geometry {
  dim3 grid, block;
  int ntile;
};

cudaError_t geometry(int B, int npos, int hlen, Geometry* g) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || npos < 1) return cudaErrorInvalidValue;
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

template <bool DECIM>
cudaError_t launch_fwd(const void* x, float* lo, void* hi, int B, int N, const Taps4& tp,
                       int hlen, int f, int cen, int scheme, int in_bf16, int hi_bf16,
                       void* stream) {
  if (N < 1 || f < 1 || (DECIM && N % 2)) return cudaErrorInvalidValue;
  const int n_out = DECIM ? N / 2 : N;
  Geometry geo;
  cudaError_t e = geometry(B, n_out, hlen, &geo);
  if (e != cudaSuccess) return e;
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    return with_type(in_bf16, [&](auto ti) {
      using TI = typename decltype(ti)::type;
      return with_type(hi_bf16, [&](auto td) -> cudaError_t {
        using TD = typename decltype(td)::type;
        const int tw = geo.block.x, rb = geo.block.y;
        const long long W = DECIM ? 2LL * tw + hlen - 2 : tw + (long long)(hlen - 1) * f;
        const long long smem = (long long)rb * (kDataLo<S> ? 2 : 1) * W * sizeof(Stage<S>);
        if (smem <= kStagedLimit) {
          auto kernel = fwd1d_staged_kernel<S, TI, TD, DECIM>;
          cudaError_t e = prepare(kernel, (size_t)smem);
          if (e != cudaSuccess) return e;
          kernel<<<geo.grid, geo.block, (size_t)smem, (cudaStream_t)stream>>>(
              static_cast<const TI*>(x), lo, static_cast<TD*>(hi), B, N, n_out, hlen, f, cen,
              geo.ntile, (int)W, tp);
        } else {
          fwd1d_mxu_kernel<S, TI, TD, DECIM><<<geo.grid, geo.block, 0, (cudaStream_t)stream>>>(
              static_cast<const TI*>(x), lo, static_cast<TD*>(hi), B, N, n_out, hlen, f, cen,
              geo.ntile, tp);
        }
        return cudaGetLastError();
      });
    });
  });
}

template <bool DECIM>
cudaError_t launch_inv(const float* lo, const void* hi, void* out, int B, int M,
                       const Taps4& tp, int hlen, int f, int cen, const int* geo, int scheme,
                       int hi_bf16, int out_bf16, void* stream) {
  if (f < 1) return cudaErrorInvalidValue;
  const Poly g = make_poly(geo);
  Geometry gm;
  cudaError_t e = geometry(B, M, hlen, &gm);
  if (e != cudaSuccess) return e;
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    return with_type(hi_bf16, [&](auto td) {
      using TD = typename decltype(td)::type;
      return with_type(out_bf16, [&](auto to) -> cudaError_t {
        using TO = typename decltype(to)::type;
        const int tw = gm.block.x, rb = gm.block.y;
        const long long W = DECIM ? (long long)tw + g.lo + g.hi
                                  : tw + (long long)(hlen - 1) * f;
        const long long smem = (long long)rb * 2 * (kDataLo<S> ? 2 : 1) * W * sizeof(Stage<S>);
        if (smem <= kStagedLimit) {
          auto kernel = inv1d_staged_kernel<S, TD, TO, DECIM>;
          cudaError_t e = prepare(kernel, (size_t)smem);
          if (e != cudaSuccess) return e;
          kernel<<<gm.grid, gm.block, (size_t)smem, (cudaStream_t)stream>>>(
              lo, static_cast<const TD*>(hi), static_cast<TO*>(out), B, M, hlen, f, cen, g,
              gm.ntile, (int)W, tp);
        } else {
          inv1d_mxu_kernel<S, TD, TO, DECIM><<<gm.grid, gm.block, 0, (cudaStream_t)stream>>>(
              lo, static_cast<const TD*>(hi), static_cast<TO*>(out), B, M, hlen, f, cen, g,
              gm.ntile, tp);
        }
        return cudaGetLastError();
      });
    });
  });
}

}  // namespace

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).
// `scheme` is the index in kernels/matmul.py:SCHEMES; the *_bf16 flags pick
// bf16 (1) or float32 (0) storage.  The analysis entry points share one
// signature (the decimated one reads no `f`), and so do the synthesis ones
// (`geo`, poly_geometry(hlen), is read by the polyphase one only, `f` and
// `cen`, the dilated center, by the a-trous one only).

extern "C" int pdwt_fwd_level_1d_mxu(const void* x, float* lo, void* hi, int B, int N,
                                     const float* lo1, const float* lo2, const float* hi1,
                                     const float* hi2, int hlen, int f, int cen, int scheme,
                                     int in_bf16, int hi_bf16, void* stream) {
  return launch_fwd<true>(x, lo, hi, B, N, make_taps4(lo1, lo2, hi1, hi2, hlen), hlen, 1, cen,
                          scheme, in_bf16, hi_bf16, stream);
}

extern "C" int pdwt_swt_fwd_level_1d_mxu(const void* x, float* lo, void* hi, int B, int N,
                                         const float* lo1, const float* lo2, const float* hi1,
                                         const float* hi2, int hlen, int f, int cen, int scheme,
                                         int in_bf16, int hi_bf16, void* stream) {
  return launch_fwd<false>(x, lo, hi, B, N, make_taps4(lo1, lo2, hi1, hi2, hlen), hlen, f, cen,
                           scheme, in_bf16, hi_bf16, stream);
}

extern "C" int pdwt_inv_level_1d_mxu(const float* lo, const void* hi, void* out, int B, int M,
                                     const float* lo1, const float* lo2, const float* hi1,
                                     const float* hi2, int hlen, int f, int cen, const int* geo,
                                     int scheme, int hi_bf16, int out_bf16, void* stream) {
  return launch_inv<true>(lo, hi, out, B, M, make_taps4(lo1, lo2, hi1, hi2, hlen), hlen, 1, 0,
                          geo, scheme, hi_bf16, out_bf16, stream);
}

extern "C" int pdwt_swt_inv_level_1d_mxu(const float* lo, const void* hi, void* out, int B,
                                         int M, const float* lo1, const float* lo2,
                                         const float* hi1, const float* hi2, int hlen, int f,
                                         int cen, const int* geo, int scheme, int hi_bf16,
                                         int out_bf16, void* stream) {
  return launch_inv<false>(lo, hi, out, B, M, make_taps4(lo1, lo2, hi1, hi2, hlen), hlen, f,
                           cen, geo, scheme, hi_bf16, out_bf16, stream);
}
