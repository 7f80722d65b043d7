// The batched 1D level kernels of the precision tiers for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py).
//
// The kernels of the two Pallas kernels of pdwt_tpu/kernels/mxu1d_pallas.py,
// each with a decimated and an a-trous instance (the TPU kernels' stride 2
// and dilated band matrices):
//
//   fwd1d_strip_kernel  <- _fwd1d_kernel  (mxu1d_pallas.py:102)
//   inv1d_strip_kernel  <- _inv1d_kernel  (mxu1d_pallas.py:153)
//
// In the fd scheme on float32 data they are also the four exact batched 1D
// kernels of swt_pallas.py (kernels 7-10: the decimated and a-trous
// analyses, the polyphase and a-trous syntheses), which have no entry point
// of their own: kernels/batched1d.py launches kernels 15's and 16's entry
// points (below) with scheme FD on float32 and counts the launches under
// kernels 7-10's names.  Kernel 7's norm launches have an entry point of
// their own (pdwt_fwd_level_1d_norm, below).
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
// Layout.  Both kernels are redesigned for Hopper's CUDA cores on
// band_strip.cuh, as adjoints of each other: a block owns kRows = 32 signals,
// one per lane, by lc positions, consecutive or one residue class mod f, so
// a window never grows with the dilation past 1.4x and no level needs a
// kernel that reads past shared memory; each signal's staged line is an odd
// number of words long, so a warp's shared loads fall on 32 distinct banks at
// any dilation and at stride 2; register-blocked strips sum both filters (or
// both parities) from one read of each sample; a float tile takes the sums
// and is written out with lanes along the positions.  The taps come from a
// small device buffer, read around the first staging, and a launch plan from
// the host (kernels/mxu1d.py), which the entry points check.
//
// Bound: device memory.  A level reads its input once and writes its output
// once; at 1024 x 4096, sym8, b3 does 3 * 16 FMAs per output and filter on
// operands split once per sample, about 0.4 GFLOP at level 1, 6 us on the
// float32 cores against 7.5 us for the bytes.  Each sample is staged and
// split once per window, never per tap.

#include "band_strip.cuh"

namespace {

using namespace pdwt_mxu;
using namespace pdwt_strip;

constexpr int kRows = 32;  // signals per block, one per lane

// Stage the windows of NB bands for the kRows signals from row0 (the last
// signal repeated past B), each signal's line at pitch LP, through the index
// table `cols` of the window's W positions: lanes along the window, warps
// over the signals, 16 loads per thread in flight.
template <int S, int NB, typename St>
__device__ __forceinline__ void stage_lines(const Bands& src, long long row0, int B, int M,
                                            const int* cols, int W, St* win, int LP, int bstride) {
  stage_window<S, NB, 4, 4 / NB>(
      src, [&](int r) { return (size_t)(row0 + r < B ? row0 + r : B - 1) * M; }, cols, kRows, W,
      win, LP, bstride, kRows * LP);
}

// ---------------------------------------------------------------------------
// Analysis level, decimated (OS = 2) or a-trous (OS = 1).  Replaces
// _fwd1d_kernel (mxu1d_pallas.py:102).  Redesigned for Hopper's CUDA cores
// (band_strip.cuh), the adjoint of the synthesis below.  A block owns kRows
// = 32 signals (one per lane) by lc output positions: consecutive (gc = 1,
// always when decimated) or one residue class mod f (gc = f, where the
// plan's L2 traffic says so).  Per group of 32 signals: stage the window (W
// = OS (lc - 1) + (nt - 1) dc + 1 samples per signal, window entry w <->
// sample OS (rho + gc q0) - cen + gc w, wrapped through a 32-bit index
// table, 16 loads per thread in flight, split into the scheme's operands;
// each signal's line an odd number of words long); then each thread takes a
// strip of kRowStrip outputs of one signal (OS = 2: consecutive outputs
// reading samples two apart; a-trous: outputs and taps dc apart), the 32
// lanes of a warp the same strip of 32 signals, and sums the low and the
// high filter from one read of each sample (R = 2), each output one float32
// sum per scheme term with the taps in order, as the plain version.  The
// sums go to two float tiles, written out with lanes along the positions.
// The taps (the (4, hlen) device buffer) are padded with zeros to nt, a
// multiple of 8, and read around the first staging.  The plan
// (kernels/mxu1d.py: fwd1d_launch_plan) picks lc and gc, and the entry
// points refuse a plan that does not add up.  Kernels 7 and 9, the exact
// decimated and a-trous analyses, are the decimated and the a-trous
// instance in fd on a float32 input and high band.
// ---------------------------------------------------------------------------
constexpr int kFwdCh = 8;  // taps per chunk of the analysis's strips

// Shared-memory bytes of the analysis: taps, the index table, the window,
// the two output tiles.  kernels/mxu1d.py:_fwd1d_smem mirrors it.
template <int S>
size_t fwd1d_smem(int os, int lc, int dc, int nt) {
  using St = Stage<S>;
  const size_t nd = kDataLo<S> ? 2 : 1, W = os * (lc - 1) + (size_t)(nt - 1) * dc + 1;
  return 16 * (size_t)nt + align16(W * sizeof(int)) +
         align16(nd * kRows * temp_pitch<St>((int)W) * sizeof(St)) +
         2 * (size_t)kRows * (lc | 1) * sizeof(float);
}

//
// PAD: kernel 7's padded launches, which replace fwd_level_1d_padded
// (swt_pallas.py:995): the decimated instance in fd on signals the caller
// extended (the pywt extension, core/modes.py), index tables that do not
// wrap (fill_table, cen = 0: out[n] = sum_j t[j] x[2n + j]) and n_out
// outputs a signal, N >= 2 (n_out - 1) + hlen.  Kernel 9's, which replace
// swt_fwd_level_1d_padded
// (swt_pallas.py:1043): the a-trous instance in fd on local shards that
// hold their ring halo (parallel/sharded.py), out[n] = sum_j t[j] x[n + j
// f], N >= n_out + (hlen - 1) f.  Kernel 15's, which replace the pad_fn= of
// mxu1d_pallas.py:211 and :272: the same instances in the tiers' schemes on
// the ring halo of the sharded 1D transforms.  All through kernel 15's
// padded entry points (pdwt_fwd_level_1d_mxu_padded,
// pdwt_swt_fwd_level_1d_mxu_padded), in fd on float32 for kernels 7 and 9.
//
// NM: kernel 7's norm launches (pdwt_fwd_level_1d_norm, below), the
// decimated instance in fd on a float32 input and high band, one instance
// a threshold mode (soft, hard, garrote; kNone, every other instance:
// `nrm` unread).  The high band is stored thresholded at the float at
// nrm.beta (mxu_common.cuh: thresh, the float32 operations of
// ops/threshold.py), and every thread sums |v| of each thresholded value v
// it stores, so the sum counts each stored output once and nothing
// store_tile skips (rows past B, the repeated last signal of a partial
// group, positions past n_out), over the block's groups.  The block then
// reduces the sums (warp shuffles, then shared memory) into one float32
// partial in its own slot of nrm.partials, x fastest: no atomics, and the
// same sum every call.  The low band is stored as it is.
template <int S, int OS, bool PAD = false, int NM = kNone>
__global__ void __launch_bounds__(256)
fwd1d_strip_kernel(const void* __restrict__ x, float* __restrict__ lo, void* __restrict__ hi,
                   int in_bf16, int hi_bf16, int B, int N, int hlen, int f, int cen,
                   const float* __restrict__ taps, int lc, int gc, int nt, int n_out_pad,
                   const NormOut nrm) {
  using St = Stage<S>;
  constexpr int P = kRowStrip<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dc = f / gc, W = OS * (lc - 1) + (nt - 1) * dc + 1, LP = temp_pitch<St>(W);
  const int OP = lc | 1;
  float* t1 = reinterpret_cast<float*>(smem_raw);  // lo | hi, first values
  float* t2 = t1 + 2 * nt;                          // second values
  int* cols = reinterpret_cast<int*>(t2 + 2 * nt);
  St* win = reinterpret_cast<St*>(reinterpret_cast<unsigned char*>(cols) +
                                  align16((size_t)W * sizeof(int)));
  float* tile = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(win) +
      align16((size_t)(kDataLo<S> ? 2 : 1) * kRows * LP * sizeof(St)));  // lo, hi: kRows x OP

  const int n_out = PAD ? n_out_pad : N / OS;
  const int frc = gc == 1 ? 1 : (f < n_out ? f : n_out);
  const int rho = blockIdx.x % frc, q0 = (blockIdx.x / frc) * lc;
  fill_table<PAD>(cols, W, OS * (rho + (long long)gc * q0) - cen, gc, N);
  __syncthreads();
  auto tap = [&](int e) { return dual_tap(e, nt, hlen); };
  const int ngroups = (B + kRows - 1) / kRows;
  float beta = 0.f, nsum = 0.f;  // NM: the threshold, this thread's sum of what it stored
  if constexpr (NM != kNone) beta = __ldg(nrm.beta);
  for (int grp = blockIdx.y; grp < ngroups; grp += gridDim.y) {
    const long long row0 = (long long)grp * kRows;
    // one staging per input type, each with the type a constant
    // (band_strip.cuh: Bands)
    auto stage_win = [&] {
      if (in_bf16)
        stage_lines<S, 1>(Bands{{x}, 1u}, row0, B, N, cols, W, win, LP, 0);
      else
        stage_lines<S, 1>(Bands{{x}, 0u}, row0, B, N, cols, W, win, LP, 0);
    };
    if (grp == (int)blockIdx.y)
      fill_around(t1, 4 * nt, taps, tap, stage_win);
    else
      stage_win();
    __syncthreads();
    // signal r (the lane), outputs t0 + dc q (q < P), both filters
    for (int it = threadIdx.x; it < kRows * (lc / P); it += blockDim.x) {
      const int r = it % kRows, sp = it / kRows, t0 = sp % dc + dc * (sp / dc) * P;
      Acc<S> acc[2][P];
      band_strip<S, P, 2, kFwdCh, OS>(acc, win + r * LP + OS * t0, kRows * LP, 0, 1, dc, t1, t2,
                                      nt, nt);
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int q = 0; q < P; ++q) tile[(k * kRows + r) * OP + t0 + dc * q] = acc[k][q].total();
    }
    __syncthreads();
    auto orow = [&](int i) { return row0 + i; };
    auto ocol = [&](int u) { return rho + (long long)gc * (q0 + u); };
    store_tile(lo, 0, B, n_out, tile, OP, kRows, lc, orow, ocol);
    if constexpr (NM != kNone)
      store_tile(static_cast<float*>(hi), 0, B, n_out, tile + kRows * OP, OP, kRows, lc, orow,
                 ocol, [&](float v) { nsum += fabsf(v); },
                 [&](float v) { return thresh(v, NM, beta); });
    else if (hi_bf16)
      store_tile(static_cast<__nv_bfloat16*>(hi), 0, B, n_out, tile + kRows * OP, OP, kRows, lc,
                 orow, ocol);
    else
      store_tile(static_cast<float*>(hi), 0, B, n_out, tile + kRows * OP, OP, kRows, lc, orow,
                 ocol);
    __syncthreads();
  }
  if constexpr (NM != kNone) {  // the loop ended at a barrier: the shared memory is free
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) nsum += __shfl_down_sync(0xffffffffu, nsum, o);
    float* ws = reinterpret_cast<float*>(smem_raw);  // a float a warp (16 nt bytes of taps)
    if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = nsum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += ws[w];
      nrm.partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = t;
    }
  }
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
// level needs a kernel that reads past shared memory.  Kernels 8 and 10,
// the exact polyphase and a-trous syntheses, are the polyphase and the
// a-trous instance in fd on float32 bands.
// ---------------------------------------------------------------------------
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

//
// PAD: kernel 8's padded launches, which replace inv_level_1d_padded
// (swt_pallas.py:1018): the polyphase instance in fd on bands the caller
// padded, index tables that do not wrap, starting pa.base coefficients in,
// and the outputs from the body's output pa.off on, pa.n_out of them a
// signal (band_strip.cuh: PadAxis, as kernel 2's padded instance).
// Kernel 10's, which replace swt_inv_level_1d_padded (swt_pallas.py:1069):
// the a-trous instance in fd
// on bands that hold their ring halo, cen = 0 and pa = {0, 0, n_out}:
// out[n] = sum_band sum_j t_band[j] x_band[n + j f], M >= n_out + (hlen -
// 1) f; its grid covers the n_out outputs.  Kernel 16's, which replace the
// pad_fn= of mxu1d_pallas.py:236 and :301: the same instances in the tiers'
// schemes.  All through kernel 16's padded entry points
// (pdwt_inv_level_1d_mxu_padded, pdwt_swt_inv_level_1d_mxu_padded), in fd
// on float32 for kernels 8 and 10.
template <int S, int NPH, bool PAD = false>
__global__ void __launch_bounds__(256)
inv1d_strip_kernel(const float* __restrict__ lo, const void* __restrict__ hi,
                   void* __restrict__ out, int hi_bf16, int out_bf16, int B, int M, int hlen,
                   int f, int cen, const Poly g, const float* __restrict__ taps, int lc, int gc,
                   int nt, const PadAxis pa) {
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
  const int nf = PAD && NPH == 1 ? pa.n_out : M;  // the positions the grid covers
  const int frc = gc == 1 ? 1 : (f < nf ? f : nf);
  const int rho = blockIdx.x % frc, q0 = (blockIdx.x / frc) * lc;
  // window entry i <-> position rho + gc (q0 + i) + shift
  const long long shift = NPH == 2 ? (long long)omin - g.lo : -(long long)cen;
  fill_table<PAD>(cols, W, rho + (long long)gc * q0 + shift + (PAD ? pa.base : 0), gc, M);
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
  const int Nout = PAD ? pa.n_out : NPH * M;
  for (int grp = blockIdx.y; grp < ngroups; grp += gridDim.y) {
    const long long row0 = (long long)grp * kRows;
    // one staging per type of the high band, each with the type a constant
    // (band_strip.cuh: Bands)
    auto stage_win = [&] {
      if (hi_bf16)
        stage_lines<S, 2>(Bands{{lo, hi}, 2u}, row0, B, M, cols, W, win, LP, BS);
      else
        stage_lines<S, 2>(Bands{{lo, hi}, 0u}, row0, B, M, cols, W, win, LP, BS);
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
      if constexpr (PAD && NPH == 2) {  // output i is the body's output i + off
        const long long c = 2LL * q0 + u - pa.off;
        return c < 0 ? (long long)Nout : c;
      }
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

// Does a plan's grid cover kRows-signal groups by n positions of lc,
// consecutive or of one residue class mod f?
bool lines_fit(int B, int n, int f, int lc, int gc, int gx, int gy, int gz) {
  const long long groups = (B + (long long)kRows - 1) / kRows;
  const long long want_x = gc == 1 ? (n + (long long)lc - 1) / lc : axis_blocks(n, f, lc);
  return gx == want_x && gy == (groups < 65535 ? groups : 65535) && gz == 1;
}

// Launch the analysis on its plan, after checking that the plan adds up.
// A norm mode other than kNone (kernel 7's norm launches: decimated, fd,
// float32 in and out) runs that mode's instance, which writes gx gy
// partials.
template <bool DECIM>
cudaError_t launch_fwd(const void* x, float* lo, void* hi, int B, int N, const float* taps,
                       int hlen, int f, int cen, int scheme, int in_bf16, int hi_bf16, int lc,
                       int gc, int nt, int threads, int gx, int gy, int gz, int smem,
                       void* stream, NormOut nrm = {}) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || N < 1 || f < 1 ||
      (DECIM && (f != 1 || N % 2)))
    return cudaErrorInvalidValue;
  constexpr int OS = DECIM ? 2 : 1;
  if (nt < hlen || nt % kFwdCh || nt > PDWT_MXU_MAX_HLEN || !(gc == 1 || gc == f) || lc < 1 ||
      threads < 32 || threads > 256 || threads % 32 ||
      !lines_fit(B, N / OS, f, lc, gc, gx, gy, gz))
    return cudaErrorInvalidValue;
  if (nrm.mode != kNone && (!DECIM || nrm.mode < kSoft || nrm.mode > kGarrote || !nrm.beta ||
                            !nrm.partials || scheme != FD || in_bf16 || hi_bf16))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) -> cudaError_t {
    constexpr int S = decltype(sc)::value;
    if (lc % (kRowStrip<S> * (f / gc)) || (size_t)smem != fwd1d_smem<S>(OS, lc, f / gc, nt))
      return cudaErrorInvalidValue;
    auto launch = [&](auto kernel) -> cudaError_t {
      cudaError_t e = prepare(kernel, smem);
      if (e != cudaSuccess) return e;
      kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
          x, lo, hi, in_bf16, hi_bf16, B, N, hlen, f, cen, taps, lc, gc, nt, 0, nrm);
      return cudaGetLastError();
    };
    if constexpr (S == FD && DECIM) {
      if (nrm.mode == kSoft) return launch(fwd1d_strip_kernel<FD, 2, false, kSoft>);
      if (nrm.mode == kHard) return launch(fwd1d_strip_kernel<FD, 2, false, kHard>);
      if (nrm.mode == kGarrote) return launch(fwd1d_strip_kernel<FD, 2, false, kGarrote>);
    }
    return launch(fwd1d_strip_kernel<S, OS>);
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
  const Poly g = DECIM ? make_poly(geo) : Poly{};
  int need = hlen;  // taps the plan must hold on the common origin
  if (DECIM) {
    const int o0 = g.lo + g.o[0], o1 = g.lo + g.o[1], omin = o0 < o1 ? o0 : o1;
    for (int q = 0; q < 2; ++q)
      if ((q ? o1 : o0) < 0 || g.p[q] < 0 || g.nb[q] < 1 || g.p[q] + 2 * (g.nb[q] - 1) >= hlen)
        return cudaErrorInvalidValue;
    need = (o0 - omin + g.nb[0]) > (o1 - omin + g.nb[1]) ? o0 - omin + g.nb[0]
                                                           : o1 - omin + g.nb[1];
  }
  constexpr int CH = kCh<DECIM ? 2 : 1>;
  if (nt < need || nt % CH || nt > PDWT_MXU_MAX_HLEN + CH || !(gc == 1 || gc == f) ||
      (DECIM && gc != 1) || lc < 1 || threads < 32 || threads > 256 || threads % 32 ||
      !lines_fit(B, M, f, lc, gc, gx, gy, gz))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) -> cudaError_t {
    constexpr int S = decltype(sc)::value;
    constexpr int NPH = DECIM ? 2 : 1;
    if (lc % (kRowStrip<S> * (f / gc)) || (size_t)smem != inv1d_smem<S>(NPH, lc, f / gc, nt))
      return cudaErrorInvalidValue;
    auto kernel = inv1d_strip_kernel<S, NPH>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
        lo, hi, out, hi_bf16, out_bf16, B, M, hlen, f, cen, g, taps, lc, gc, nt, PadAxis{});
    return cudaGetLastError();
  });
}

}  // namespace

namespace pdwt_m1d {

// The padded launchers take the scheme and the storage flags of their
// unpadded siblings (launch_fwd, launch_inv above) and run the PAD
// instances of the two bodies: kernels 15 and 16's padded entry points (the
// pdwt_*_1d_mxu_padded entry points below) call them, in the tiers'
// schemes and, for kernels 7-10's padded launches, in fd on float32.

// Launch the padded decimated analysis (fwd1d_strip_kernel<S, 2, true>) on
// (B, N) signals (bf16 where in_bf16) that hold their extension, into two
// (B, n_out) bands (the high one bf16 where hi_bf16); the plan is kernel
// 15's for n_out outputs (kernel 7's in fd: kernels/mxu1d.py:
// fwd1d_padded_launch_plan).
// Refused (cudaErrorInvalidValue) where the plan does not add up or the
// outputs would read past the signal.
int launch_fwd_padded(const void* x, float* lo, void* hi, int B, int N, int n_out,
                      const float* taps, int hlen, int scheme, int in_bf16, int hi_bf16, int lc,
                      int gc, int nt, int threads, int gx, int gy, int gz, int smem,
                      void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || n_out < 1 ||
      N < 2LL * (n_out - 1) + hlen)
    return cudaErrorInvalidValue;
  if (nt < hlen || nt % kFwdCh || nt > PDWT_MXU_MAX_HLEN || gc != 1 || lc < 1 || threads < 32 ||
      threads > 256 || threads % 32 || !lines_fit(B, n_out, 1, lc, 1, gx, gy, gz))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) -> cudaError_t {
    constexpr int S = decltype(sc)::value;
    if (lc % kRowStrip<S> || (size_t)smem != fwd1d_smem<S>(2, lc, 1, nt))
      return cudaErrorInvalidValue;
    auto kernel = fwd1d_strip_kernel<S, 2, true>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
        x, lo, hi, in_bf16, hi_bf16, B, N, hlen, 1, 0, taps, lc, 1, nt, n_out, NormOut{});
    return cudaGetLastError();
  });
}

// Launch the padded polyphase synthesis (inv1d_strip_kernel<S, 2, true>)
// on two (B, M) bands the caller padded (the low one float32, the high one
// bf16 where hi_bf16), into (B, pad[2]), bf16 where out_bf16: `pad` holds
// base, off and n_out (band_strip.cuh: PadAxis); taps and geometry as
// kernel 16's, the plan kernel 16's for pad_positions(pad) positions
// (kernel 8's in fd: kernels/mxu1d.py: inv1d_padded_launch_plan).  Refused
// (cudaErrorInvalidValue) where the plan does not add up or a stored
// output would read outside the bands (pad_axis_ok).
int launch_inv_padded(const float* lo, const void* hi, void* out, int B, int M, const int* pad,
                      const float* taps, int hlen, const int* geo, int scheme, int hi_bf16,
                      int out_bf16, int lc, int gc, int nt, int threads, int gx, int gy, int gz,
                      int smem, void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || M < 1) return cudaErrorInvalidValue;
  const Poly g = make_poly(geo);
  const PadAxis pa = {pad[0], pad[1], pad[2]};
  const int o0 = g.lo + g.o[0], o1 = g.lo + g.o[1], omin = o0 < o1 ? o0 : o1;
  for (int q = 0; q < 2; ++q)
    if ((q ? o1 : o0) < 0 || g.p[q] < 0 || g.nb[q] < 1 || g.p[q] + 2 * (g.nb[q] - 1) >= hlen)
      return cudaErrorInvalidValue;
  const int need = (o0 - omin + g.nb[0]) > (o1 - omin + g.nb[1]) ? o0 - omin + g.nb[0]
                                                                  : o1 - omin + g.nb[1];
  const long long npos = pad_positions(pa);
  if (!pad_axis_ok(pa, g, M) || npos > (1LL << 30) || nt < need || nt % kCh<2> ||
      nt > PDWT_MXU_MAX_HLEN + kCh<2> || gc != 1 || lc < 1 || threads < 32 || threads > 256 ||
      threads % 32 || !lines_fit(B, (int)npos, 1, lc, 1, gx, gy, gz))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) -> cudaError_t {
    constexpr int S = decltype(sc)::value;
    if (lc % kRowStrip<S> || (size_t)smem != inv1d_smem<S>(2, lc, 1, nt))
      return cudaErrorInvalidValue;
    auto kernel = inv1d_strip_kernel<S, 2, true>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
        lo, hi, out, hi_bf16, out_bf16, B, M, hlen, 1, 0, g, taps, lc, 1, nt, pa);
    return cudaGetLastError();
  });
}

// Launch the padded a-trous analysis (fwd1d_strip_kernel<S, 1, true>) on
// (B, N) signals (bf16 where in_bf16) that hold their halo, into two (B,
// n_out) bands (the high one bf16 where hi_bf16), on kernel 15's plan for
// n_out outputs (kernel 9's in fd: kernels/mxu1d.py:
// swt_fwd1d_padded_launch_plan).  Refused (cudaErrorInvalidValue) where the
// plan does not add up or the outputs would read past the signal.
int launch_swt_fwd_padded(const void* x, float* lo, void* hi, int B, int N, int n_out,
                          const float* taps, int hlen, int f, int scheme, int in_bf16,
                          int hi_bf16, int lc, int gc, int nt, int threads, int gx, int gy,
                          int gz, int smem, void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || n_out < 1 || f < 1 ||
      N < n_out + (long long)(hlen - 1) * f)
    return cudaErrorInvalidValue;
  if (nt < hlen || nt % kFwdCh || nt > PDWT_MXU_MAX_HLEN || !(gc == 1 || gc == f) || lc < 1 ||
      threads < 32 || threads > 256 || threads % 32 ||
      !lines_fit(B, n_out, f, lc, gc, gx, gy, gz))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) -> cudaError_t {
    constexpr int S = decltype(sc)::value;
    if (lc % (kRowStrip<S> * (f / gc)) || (size_t)smem != fwd1d_smem<S>(1, lc, f / gc, nt))
      return cudaErrorInvalidValue;
    auto kernel = fwd1d_strip_kernel<S, 1, true>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
        x, lo, hi, in_bf16, hi_bf16, B, N, hlen, f, 0, taps, lc, gc, nt, n_out, NormOut{});
    return cudaGetLastError();
  });
}

// Launch the padded a-trous synthesis (inv1d_strip_kernel<S, 1, true>) on
// two (B, M) bands that hold their halo (the low one float32, the high one
// bf16 where hi_bf16), into (B, n_out), bf16 where out_bf16, on kernel 16's
// plan for n_out positions (kernel 10's in fd: kernels/mxu1d.py:
// swt_inv1d_padded_launch_plan); the halved taps.  Refused
// (cudaErrorInvalidValue) where the plan does not add up or the outputs
// would read past the bands.
int launch_swt_inv_padded(const float* lo, const void* hi, void* out, int B, int M, int n_out,
                          const float* taps, int hlen, int f, int scheme, int hi_bf16,
                          int out_bf16, int lc, int gc, int nt, int threads, int gx, int gy,
                          int gz, int smem, void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || n_out < 1 || f < 1 ||
      M < n_out + (long long)(hlen - 1) * f)
    return cudaErrorInvalidValue;
  if (nt < hlen || nt % kCh<1> || nt > PDWT_MXU_MAX_HLEN + kCh<1> || !(gc == 1 || gc == f) ||
      lc < 1 || threads < 32 || threads > 256 || threads % 32 ||
      !lines_fit(B, n_out, f, lc, gc, gx, gy, gz))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) -> cudaError_t {
    constexpr int S = decltype(sc)::value;
    if (lc % (kRowStrip<S> * (f / gc)) || (size_t)smem != inv1d_smem<S>(1, lc, f / gc, nt))
      return cudaErrorInvalidValue;
    auto kernel = inv1d_strip_kernel<S, 1, true>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
        lo, hi, out, hi_bf16, out_bf16, B, M, hlen, f, 0, Poly{}, taps, lc, gc, nt,
        PadAxis{0, 0, n_out});
    return cudaGetLastError();
  });
}

}  // namespace pdwt_m1d

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).
// `taps` is a (4, hlen) float32 device buffer: the low filter's first and
// second values, then the high filter's, correlation order; `scheme` is the
// index in kernels/matmul.py:SCHEMES; the *_bf16 flags pick bf16 (1) or
// float32 (0) storage.  The analysis entry points share one signature (the
// decimated one takes f = 1), and so do the synthesis ones (`geo`,
// poly_geometry(hlen) on the host, is read by the polyphase one only, `f`
// and `cen`, the dilated center, by the a-trous one only).

// The launch plan (kernels/mxu1d.py:fwd1d_launch_plan): lc positions of
// column stride gc (1 or f), nt padded taps, threads, grid (gx, gy, gz) and
// dynamic shared-memory bytes; a plan that does not add up is refused
// (cudaErrorInvalidValue).
extern "C" int pdwt_fwd_level_1d_mxu(const void* x, float* lo, void* hi, int B, int N,
                                     const float* taps, int hlen, int f, int cen, int scheme,
                                     int in_bf16, int hi_bf16, int lc, int gc, int nt, int threads,
                                     int gx, int gy, int gz, int smem, void* stream) {
  return launch_fwd<true>(x, lo, hi, B, N, taps, hlen, f, cen, scheme, in_bf16, hi_bf16, lc, gc,
                          nt, threads, gx, gy, gz, smem, stream);
}

// Kernel 7's norm launches: pdwt_fwd_level_1d_mxu's arguments (scheme FD,
// float32 in and out, else refused), then norm_mode (1 soft, 2 hard, 3
// garrote), beta (one float on the device) and partials.  The high band is
// stored thresholded at beta, and the L1 norm of what is stored goes to gx
// gy float32 partials, one a block (fwd1d_strip_kernel<FD, 2, false, mode>),
// which pdwt_swt_norm_sum_2d (swt.cu) adds.  It takes the place of the
// plain threshold and the norm of the details in the batched 1D denoising
// step (the five torch passes a band of ops/threshold.py and the abs and sum
// of ops/norms.py: norm1), which read each band about seven times and wrote
// it four; the epilogue moves no byte more than the plain launch.
extern "C" int pdwt_fwd_level_1d_norm(const void* x, float* lo, void* hi, int B, int N,
                                      const float* taps, int hlen, int f, int cen, int scheme,
                                      int in_bf16, int hi_bf16, int lc, int gc, int nt,
                                      int threads, int gx, int gy, int gz, int smem,
                                      int norm_mode, const float* beta, float* partials,
                                      void* stream) {
  if (norm_mode == kNone) return cudaErrorInvalidValue;
  return launch_fwd<true>(x, lo, hi, B, N, taps, hlen, f, cen, scheme, in_bf16, hi_bf16, lc, gc,
                          nt, threads, gx, gy, gz, smem, stream, {norm_mode, beta, partials, 0});
}

extern "C" int pdwt_swt_fwd_level_1d_mxu(const void* x, float* lo, void* hi, int B, int N,
                                         const float* taps, int hlen, int f, int cen, int scheme,
                                         int in_bf16, int hi_bf16, int lc, int gc, int nt,
                                         int threads, int gx, int gy, int gz, int smem,
                                         void* stream) {
  return launch_fwd<false>(x, lo, hi, B, N, taps, hlen, f, cen, scheme, in_bf16, hi_bf16, lc, gc,
                           nt, threads, gx, gy, gz, smem, stream);
}

// The launch plan (kernels/mxu1d.py:inv1d_launch_plan): lc positions
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

// The padded entry points of kernels 15 and 16 (the sharded 1D transforms
// under the precision tiers, parallel/sharded.py), the counterparts of the
// pad_fn= of mxu1d_pallas.py:211 fwd_level_1d_mxu, :236 inv_level_1d_mxu,
// :272 swt_fwd_level_1d_mxu and :301 swt_inv_level_1d_mxu: the PAD
// instances of the two bodies in `scheme`, on signals or bands that hold
// their ring halo (the decimated ones: the odd extension and halo, and the
// polyphase pad with base, off and n_out in `pad`), reading no wrapped
// index.  The analyses: (B, N) (bf16 where in_bf16) -> two (B, n_out)
// bands, the high one bf16 where hi_bf16, out[n] = sum_j t[j] x[2n + j]
// (decimated) or x[n + j f] (a-trous); the syntheses: a float32 low band and
// a high band (bf16 where hi_bf16) -> (B, n_out), bf16 where out_bf16.
// Taps as kernels 15's and 16's (the a-trous synthesis's halved); the
// plans kernels/mxu1d.py: fwd1d_padded_launch_plan,
// inv1d_padded_launch_plan, swt_fwd1d_padded_launch_plan,
// swt_inv1d_padded_launch_plan.  Each is refused where an output would
// read outside its input.
extern "C" int pdwt_fwd_level_1d_mxu_padded(const void* x, float* lo, void* hi, int B, int N,
                                            int n_out, const float* taps, int hlen, int scheme,
                                            int in_bf16, int hi_bf16, int lc, int gc, int nt,
                                            int threads, int gx, int gy, int gz, int smem,
                                            void* stream) {
  return pdwt_m1d::launch_fwd_padded(x, lo, hi, B, N, n_out, taps, hlen, scheme, in_bf16,
                                     hi_bf16, lc, gc, nt, threads, gx, gy, gz, smem, stream);
}

extern "C" int pdwt_inv_level_1d_mxu_padded(const float* lo, const void* hi, void* out, int B,
                                            int M, const int* pad, const float* taps, int hlen,
                                            const int* geo, int scheme, int hi_bf16,
                                            int out_bf16, int lc, int gc, int nt, int threads,
                                            int gx, int gy, int gz, int smem, void* stream) {
  return pdwt_m1d::launch_inv_padded(lo, hi, out, B, M, pad, taps, hlen, geo, scheme, hi_bf16,
                                     out_bf16, lc, gc, nt, threads, gx, gy, gz, smem, stream);
}

extern "C" int pdwt_swt_fwd_level_1d_mxu_padded(const void* x, float* lo, void* hi, int B, int N,
                                                int n_out, const float* taps, int hlen, int f,
                                                int scheme, int in_bf16, int hi_bf16, int lc,
                                                int gc, int nt, int threads, int gx, int gy,
                                                int gz, int smem, void* stream) {
  return pdwt_m1d::launch_swt_fwd_padded(x, lo, hi, B, N, n_out, taps, hlen, f, scheme, in_bf16,
                                         hi_bf16, lc, gc, nt, threads, gx, gy, gz, smem, stream);
}

extern "C" int pdwt_swt_inv_level_1d_mxu_padded(const float* lo, const void* hi, void* out,
                                                int B, int M, int n_out, const float* taps,
                                                int hlen, int f, int scheme, int hi_bf16,
                                                int out_bf16, int lc, int gc, int nt, int threads,
                                                int gx, int gy, int gz, int smem, void* stream) {
  return pdwt_m1d::launch_swt_inv_padded(lo, hi, out, B, M, n_out, taps, hlen, f, scheme,
                                         hi_bf16, out_bf16, lc, gc, nt, threads, gx, gy, gz,
                                         smem, stream);
}
