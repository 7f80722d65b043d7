// The batched 1D level kernels of the precision tiers for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py).
//
// The kernels of the two Pallas kernels of pdwt_tpu/kernels/mxu1d_pallas.py,
// each with a decimated and an a-trous instance (the TPU kernels' stride 2
// and dilated band matrices):
//
//   fwd1d_staged_kernel, fwd1d_mxu_kernel  <- _fwd1d_kernel  (mxu1d_pallas.py:102)
//   inv1d_strip_kernel                     <- _inv1d_kernel  (mxu1d_pallas.py:153)
//
// (the analysis: the staged kernel where a block's windows fit shared
// memory, the direct one where they do not, see Layout)
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
// Layout of the analysis as batched1d.cu: the signal axis runs along the
// lanes; a block of NT threads is TW x RB, TW output positions of RB = NT /
// TW signals; the grid is one-dimensional.  Each row of the block stages the
// window of samples its TW outputs read, split once into the scheme's
// operands (bf16, float32 for fd), in shared memory; the taps then read the
// window at stride 1 (2 for the decimated analysis), with no index wrap.
// Where a window outgrows shared memory (an a-trous dilation of thousands),
// the level runs the direct kernel instead, which reads and splits every
// sample per tap straight from memory through L1.  Both sum in the plain
// version's order, so they give the same bits.  The synthesis was
// redesigned for Hopper's CUDA cores on band_strip.cuh (its own comment
// below says how): 32 signals per block, one per lane, register-blocked
// strips, a launch plan from the host, and a window that does not grow with
// the dilation, so it needs no direct kernel.
//
// Bound: device memory.  A level reads its input once and writes its output
// once; at 1024 x 4096, sym8, b3 does 3 * 16 FMAs per output and filter on
// operands split once per sample, about 0.4 GFLOP at level 1, 6 us on the
// float32 cores against 7.5 us for the bytes.  Splitting each sample once per
// tap instead (the direct kernel) costs up to 2 * 16 conversions per output
// and filter; at the paths' shapes that ran 4-8x slower than the exact
// kernels of batched1d.cu on an H100.

#include "band_strip.cuh"

namespace {

using namespace pdwt_mxu;
using namespace pdwt_strip;

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
// Synthesis level.  Replaces _inv1d_kernel (mxu1d_pallas.py:153).  Redesigned
// for Hopper's CUDA cores (band_strip.cuh).  A block owns kRows = 32 signals
// (one per lane) by lc positions of the subbands: consecutive (gc = 1, the
// polyphase synthesis, and the a-trous one while the window grows at most
// 1.4x) or one residue class mod f (gc = f).  Per group of 32 signals: stage
// both bands' windows (lc + (nt - 1) dc samples per signal, wrapped through
// a 32-bit index table, 16 loads per thread in flight, lanes along the
// positions and warps over the signals, split into the scheme's operands;
// each signal's line an odd number of words long); then each thread takes a strip of kRowStrip
// outputs of one signal, the 32 lanes of a warp the same strip of 32
// signals, so a warp's loads fall on 32 distinct banks at any dilation, and
// sums the low taps on the low band then the high taps on the high band, as
// the plain version.  Polyphase: both output parities from one read of each
// sample (R = 2), parity q's taps p_q + 2 b from poly_geometry, zero-padded
// on a common origin (parity 1 starts off_1 - off_0 samples later); a-trous:
// outputs dc apart, the taps dc samples apart.  The sums go to a float tile,
// written out with lanes along the positions.  The taps (the (4, hlen)
// device buffer: low first and second values, then the high filter's) are
// read around the first staging.  The plan (kernels/mxu1d.py:
// inv1d_launch_plan) picks lc and gc, and the entry point refuses a plan
// that does not add up.  The window never grows with f past 1.4x, so no
// level needs a kernel that reads past shared memory.
// ---------------------------------------------------------------------------
constexpr int kRows = 32;        // signals per block, one per lane
// taps per chunk of the strips: 8 for the a-trous synthesis (16 taps for
// sym8), 4 for the polyphase one (the parities' tables are 9 long for sym8)
template <int NPH>
constexpr int kCh = NPH == 1 ? 8 : 4;
// Shared-memory bytes of the synthesis: taps, the index table, both bands'
// windows, the output tile.  kernels/mxu1d.py:_inv1d_smem mirrors it.
template <int S>
size_t inv1d_smem(int nph, int lc, int dc, int nt) {
  using St = Stage<S>;
  const size_t nd = kDataLo<S> ? 2 : 1, W = lc + (size_t)(nt - 1) * dc;
  return 16 * (size_t)nph * nt + align16(W * sizeof(int)) +
         align16(2 * nd * kRows * temp_pitch<St>((int)W) * sizeof(St)) +
         (size_t)kRows * ((nph * lc) | 1) * sizeof(float);
}

template <int S, int NPH>
__global__ void __launch_bounds__(256)
inv1d_strip_kernel(const float* __restrict__ lo, const void* __restrict__ hi,
                   void* __restrict__ out, int hi_bf16, int out_bf16, int B, int M, int hlen,
                   int f, int cen, const Poly g, const float* __restrict__ taps, int lc, int gc,
                   int nt) {
  using St = Stage<S>;
  constexpr int nd = kDataLo<S> ? 2 : 1;
  constexpr int P = kRowStrip<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dc = f / gc, W = lc + (nt - 1) * dc, LP = temp_pitch<St>(W), OP = (NPH * lc) | 1;
  float* t1 = reinterpret_cast<float*>(smem_raw);  // [q][band][nt], first values
  float* t2 = t1 + NPH * 2 * nt;                    // second values
  int* cols = reinterpret_cast<int*>(t2 + NPH * 2 * nt);
  St* win = reinterpret_cast<St*>(reinterpret_cast<unsigned char*>(cols) +
                                  align16((size_t)W * sizeof(int)));
  float* tile = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(win) +
      align16((size_t)2 * nd * kRows * LP * sizeof(St)));  // kRows x OP
  const int BS = nd * kRows * LP;                            // band stride

  // polyphase: the window starts at the earlier parity's first sample
  const int o0 = g.lo + g.o[0], o1 = g.lo + g.o[1], omin = o0 < o1 ? o0 : o1;
  const int frc = gc == 1 ? 1 : (f < M ? f : M);
  const int rho = blockIdx.x % frc, q0 = (blockIdx.x / frc) * lc;
  // window entry i <-> position rho + gc (q0 + i) + shift
  const long long shift = NPH == 2 ? (long long)omin - g.lo : -(long long)cen;
  fill_index(cols, W, rho + (long long)gc * q0 + shift, gc, M);
  __syncthreads();
  // t1 [q][band][nt] then t2, from taps (4, hlen): band k's first values in
  // row 2k, second values in row 2k + 1; parity q's tap b = j - (o_q - omin)
  auto tap = [&](int e) {
    const int per = NPH * 2 * nt, e2 = e / per, o = e % per, q = o / (2 * nt);
    const int band = (o / nt) % 2, j = o % nt, row = (2 * band + e2) * hlen;
    if (NPH == 1) return j < hlen ? row + j : -1;
    const int bb = j - ((q ? o1 : o0) - omin);
    return bb >= 0 && bb < g.nb[q] ? row + g.p[q] + 2 * bb : -1;
  };
  const int ngroups = (B + kRows - 1) / kRows;
  const int Nout = NPH * M;
  for (int grp = blockIdx.y; grp < ngroups; grp += gridDim.y) {
    const long long row0 = (long long)grp * kRows;
    // lanes along the window, a warp's rows warp, warp + nw, ...: each
    // thread keeps 2 bands x 4 rows x 2 window entries (32 apart) in flight
    auto stage_win = [&] {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
      for (int w = lane; w < W; w += 64) {
        const int w2 = w + 32 < W ? w + 32 : w, c[2] = {cols[w], cols[w2]};
        for (int r0 = warp; r0 < kRows; r0 += 4 * nw) {
          float vl[4][2], vh[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const long long r = row0 + (r0 + u * nw < kRows ? r0 + u * nw : kRows - 1);
            const size_t base = (size_t)(r < B ? r : B - 1) * M;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              vl[u][k] = __ldg(lo + base + c[k]);
              vh[u][k] = hi_bf16 ? load_f(static_cast<const __nv_bfloat16*>(hi) + base + c[k])
                                 : load_f(static_cast<const float*>(hi) + base + c[k]);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = r0 + u * nw;
            if (r >= kRows) break;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              if (k && w2 == w) break;
              const int i = r * LP + w + 32 * k;
              stage<S>(vl[u][k], win, win + kRows * LP, i);
              stage<S>(vh[u][k], win + BS, win + BS + kRows * LP, i);
            }
          }
        }
      }
    };
    if (grp == (int)blockIdx.y)
      fill_around(t1, 2 * NPH * 2 * nt, taps, tap, stage_win);
    else
      stage_win();
    __syncthreads();
    // signal r (the lane), outputs t0 + dc q (q < P), every parity
    for (int it = threadIdx.x; it < kRows * (lc / P); it += blockDim.x) {
      const int r = it % kRows, sp = it / kRows, t0 = sp % dc + dc * (sp / dc) * P;
      Acc<S> acc[NPH][P];
      band_strip<S, P, NPH, kCh<NPH>>(acc, win + r * LP + t0, kRows * LP, BS, 2, dc, t1, t2,
                                      2 * nt, nt);
#pragma unroll
      for (int q = 0; q < P; ++q)
#pragma unroll
        for (int ph = 0; ph < NPH; ++ph)
          tile[r * OP + NPH * (t0 + dc * q) + ph] = acc[ph][q].total();
    }
    __syncthreads();
    auto orow = [&](int i) { return row0 + i; };
    auto ocol = [&](int u) {
      return NPH == 2 ? 2LL * q0 + u : rho + (long long)gc * (q0 + u);
    };
    if (out_bf16)
      store_tile(static_cast<__nv_bfloat16*>(out), 0, B, Nout, tile, OP, kRows, NPH * lc, orow,
                 ocol);
    else
      store_tile(static_cast<float*>(out), 0, B, Nout, tile, OP, kRows, NPH * lc, orow, ocol);
    __syncthreads();
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

// Launch the synthesis on its plan, after checking that the plan adds up.
template <bool DECIM>
cudaError_t launch_inv(const float* lo, const void* hi, void* out, int B, int M,
                       const float* taps, int hlen, int f, int cen, const int* geo, int scheme,
                       int hi_bf16, int out_bf16, int lc, int gc, int nt, int threads, int gx,
                       int gy, int gz, int smem, void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || M < 1 || f < 1 || (DECIM && f != 1))
    return cudaErrorInvalidValue;
  const Poly g = make_poly(geo);
  int need = hlen;  // taps the plan must hold on the common origin
  if (DECIM) {
    const int o0 = g.lo + g.o[0], o1 = g.lo + g.o[1], omin = o0 < o1 ? o0 : o1;
    for (int q = 0; q < 2; ++q)
      if ((q ? o1 : o0) < 0 || g.p[q] < 0 || g.nb[q] < 1 || g.p[q] + 2 * (g.nb[q] - 1) >= hlen)
        return cudaErrorInvalidValue;
    need = (o0 - omin + g.nb[0]) > (o1 - omin + g.nb[1]) ? o0 - omin + g.nb[0]
                                                           : o1 - omin + g.nb[1];
  }
  const long long groups = (B + (long long)kRows - 1) / kRows;
  const long long want_x = gc == 1 ? (M + (long long)lc - 1) / lc : axis_blocks(M, f, lc);
  constexpr int CH = kCh<DECIM ? 2 : 1>;
  if (nt < need || nt % CH || nt > PDWT_MXU_MAX_HLEN + CH || !(gc == 1 || gc == f) ||
      (DECIM && gc != 1) || lc < 1 || threads < 32 || threads > 256 || threads % 32 ||
      gx != want_x || gy != (groups < 65535 ? groups : 65535) || gz != 1)
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) -> cudaError_t {
    constexpr int S = decltype(sc)::value;
    constexpr int NPH = DECIM ? 2 : 1;
    if (lc % (kRowStrip<S> * (f / gc)) || (size_t)smem != inv1d_smem<S>(NPH, lc, f / gc, nt))
      return cudaErrorInvalidValue;
    auto kernel = inv1d_strip_kernel<S, NPH>;
    cudaError_t e = prepare(kernel, smem, 0);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
        lo, hi, out, hi_bf16, out_bf16, B, M, hlen, f, cen, g, taps, lc, gc, nt);
    return cudaGetLastError();
  });
}

}  // namespace

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).
// `scheme` is the index in kernels/matmul.py:SCHEMES; the *_bf16 flags pick
// bf16 (1) or float32 (0) storage.  The analysis entry points share one
// signature (the decimated one reads no `f`), and so do the synthesis ones
// (`geo`, poly_geometry(hlen) on the host, is read by the polyphase one
// only, `f` and `cen`, the dilated center, by the a-trous one only).

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

// `taps` is the (4, hlen) float32 device buffer of the synthesis: the low
// filter's first and second values, then the high filter's, correlation
// order.  The launch plan (kernels/mxu1d.py:inv1d_launch_plan): lc positions
// of column stride gc (1 or f), nt padded taps, threads, grid (gx, gy, gz)
// and dynamic shared-memory bytes; a plan that does not add up is refused
// (cudaErrorInvalidValue).
extern "C" int pdwt_inv_level_1d_mxu(const float* lo, const void* hi, void* out, int B, int M,
                                     const float* taps, int hlen, int f, int cen, const int* geo,
                                     int scheme, int hi_bf16, int out_bf16, int lc, int gc,
                                     int nt, int threads, int gx, int gy, int gz, int smem,
                                     void* stream) {
  return launch_inv<true>(lo, hi, out, B, M, taps, hlen, f, cen, geo, scheme, hi_bf16,
                          out_bf16, lc, gc, nt, threads, gx, gy, gz, smem, stream);
}

extern "C" int pdwt_swt_inv_level_1d_mxu(const float* lo, const void* hi, void* out, int B,
                                         int M, const float* taps, int hlen, int f, int cen,
                                         const int* geo, int scheme, int hi_bf16, int out_bf16,
                                         int lc, int gc, int nt, int threads, int gx, int gy,
                                         int gz, int smem, void* stream) {
  return launch_inv<false>(lo, hi, out, B, M, taps, hlen, f, cen, geo, scheme, hi_bf16,
                           out_bf16, lc, gc, nt, threads, gx, gy, gz, smem, stream);
}
