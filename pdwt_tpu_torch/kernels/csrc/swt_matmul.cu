// The 2D a-trous level kernels of the precision tiers for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py
// links this file with the other sources into one library).
//
// Two kernels, one per Pallas kernel of pdwt_tpu/kernels/swt_matmul_pallas.py:
//
//   swt_fwd_mxu_kernel  <- _swt_fwd_mxu_kernel  (swt_matmul_pallas.py:166)
//   swt_inv_mxu_kernel  <- _swt_inv_mxu_kernel  (swt_matmul_pallas.py:293)
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
// Layout.  The forward's block owns a 32 x 32 tile of positions of one
// residue class mod f along each axis (mxu_common.cuh: Axis), so every
// dilated tap of its outputs lands in the staged window of (32 + hlen - 1)^2
// samples of those classes: shared memory does not grow with the level, and
// any size and dilation runs.  The inverse (redesigned for Hopper's CUDA
// cores, band_strip.cuh) takes a tile of rows of one class by consecutive
// columns where the window allows, register-blocked strips and a launch plan
// from the host; its own comment below says how.
//
// Bound.  At 1024^2 a level reads one image and writes four planes (forward)
// or the reverse: 4.2 MiB of bf16 in and 4 MiB of float32 plus 6 MiB of bf16
// out at level 1 (about 4 us at 3.35 TB/s); db7's six passes of 14 taps over
// a 1024^2 plane are 88 M multiply-adds per term, 0.18 GFLOP per level and
// term, 3 us for b1 and up to 8 us for b3 on the float32 cores: the level is
// close to balanced, and the staging matters as much as the sums.  Each input
// sample is staged once per window and split then, never per tap; the
// row-pass temps never leave shared memory.

#include "band_strip.cuh"

namespace {

using namespace pdwt_mxu;
using namespace pdwt_strip;

constexpr int LT = 32;  // tile positions per axis
constexpr int BX = 32;
constexpr int BY = 8;

// ---------------------------------------------------------------------------
// Forward level.  Replaces _swt_fwd_mxu_kernel (swt_matmul_pallas.py:166).
// Stages the W x W window (W = LT + hlen - 1) split into the scheme's
// operands; runs the dual pass along the rows for every window column into a
// shared temp, split again; then the dual pass along the columns, and writes
// A, H, V, D once.
// ---------------------------------------------------------------------------
template <int S, typename TI, typename TD>
__global__ void __launch_bounds__(BX * BY)
swt_fwd_mxu_kernel(const TI* __restrict__ x, float* __restrict__ a, TD* __restrict__ h,
                   TD* __restrict__ v, TD* __restrict__ d, int B, int R, int C, int hlen,
                   int f, int cen, int frr, int frc, const __grid_constant__ Taps4 tp) {
  using St = Stage<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nd = kDataLo<S> ? 2 : 1;
  const int W = LT + hlen - 1;
  St* in1 = reinterpret_cast<St*>(smem_raw);  // W x W window, first operand
  St* in2 = in1 + W * W;                       // second operand (b2d, b3)
  St* tl1 = in1 + nd * W * W;                  // LT x W, low-pass along the rows
  St* tl2 = tl1 + LT * W;
  St* th1 = tl1 + nd * LT * W;                 // LT x W, high-pass along the rows
  St* th2 = th1 + LT * W;
  __shared__ float4 tq[PDWT_MXU_MAX_HLEN];
  stage_taps(tq, tp, hlen);
  const Axis ar = axis_of<LT>(blockIdx.y, frr, f), ac = axis_of<LT>(blockIdx.x, frc, f);
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const TI* xb = x + (size_t)b * R * C;
    for (int i = ty; i < W; i += BY) {
      const TI* row = xb + (size_t)wrapl(ar.at(i - cen), R) * C;
      for (int j = tx; j < W; j += BX) stage<S>(load_f(row + wrapl(ac.at(j - cen), C)), in1, in2, i * W + j);
    }
    __syncthreads();

    // along the rows: output row tt of every window column
    for (int tt = ty; tt < LT; tt += BY) {
      for (int col = tx; col < W; col += BX) {
        Acc<S> lo, hi;
        const int base = tt * W + col;
        for (int j = 0; j < hlen; ++j) {
          const float d1 = to_f(in1[base + j * W]);
          const float d2 = kDataLo<S> ? to_f(in2[base + j * W]) : 0.f;
          const float4 t = tq[j];
          lo.add(t.x, t.y, d1, d2);
          hi.add(t.z, t.w, d1, d2);
        }
        stage<S>(lo.total(), tl1, tl2, tt * W + col);
        stage<S>(hi.total(), th1, th2, tt * W + col);
      }
    }
    __syncthreads();

    // along the columns: A = lo(lo rows), V = hi cols of lo rows, H = lo cols
    // of hi rows, D = hi(hi rows)
    const long long c = ac.at(tx);
    for (int tt = ty; tt < LT; tt += BY) {
      Acc<S> aa, vv, hh, dd;
      const int base = tt * W + tx;
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
      const long long r = ar.at(tt);
      if (r < R && c < C) {
        const size_t o = ((size_t)b * R + r) * C + c;
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

template <int S>
__global__ void __launch_bounds__(256)
swt_inv_mxu_kernel(const float* __restrict__ a, const void* __restrict__ h,
                   const void* __restrict__ v, const void* __restrict__ d, void* __restrict__ out,
                   int det_bf16, int out_bf16, int B, int R, int C, int hlen, int f, int cen,
                   int mode, const float* __restrict__ beta, int lr, int lc, int gc, int nph,
                   int nt, const float* __restrict__ taps) {
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
  fill_index(rows, WR, rho_r + (long long)f * (q0r - cen), f, R);
  fill_index(cols, WC, rho_c + (long long)gc * q0c - (long long)cen * f, gc, C);
  const float bt = mode == kNone ? 0.f : __ldg(beta);
  const unsigned tb = det_bf16 ? 0xe : 0;  // H, V, D bf16
  const Bands all = {{a, h, v, d}, tb}, ah = {{a, h}, tb & 3}, vd = {{v, d}, tb >> 2};
  __syncthreads();
  // t1 = (lo, hi) first values, t2 second values, from taps (4, hlen) = lo
  // first, lo second, hi first, hi second
  auto tap = [&](int e) {
    const int k = e % nt, u = e / nt;  // u: lo1, hi1, lo2, hi2
    return k < hlen ? ((u & 1) * 2 + (u >> 1)) * hlen + k : -1;
  };

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const size_t plane = (size_t)b * R * C;
    for (int ph = 0; ph < nph; ++ph) {
      const unsigned thr = mode == kNone ? 0 : (nph == 1 ? 0xe : (ph == 0 ? 2 : 3));
      auto stage_phase = [&] {
        if (nph == 1)
          stage_bands<S, 4, kStageLoads>(all, thr, plane, C, rows, cols, WR, WC, win, BS,
                                         WR * WC, mode, bt);
        else
          stage_bands<S, 2, kStageLoads>(ph == 0 ? ah : vd, thr, plane, C, rows, cols, WR, WC,
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

// Grid of one level: (column class, chunk) in x, (row class, chunk) in y,
// batch in z; fr* = the classes per axis.
cudaError_t level_grid(int B, int R, int C, int f, dim3* grid, int* frr, int* frc) {
  const long long gx = axis_blocks(C, f, LT), gy = axis_blocks(R, f, LT);
  if (gy > 65535 || gx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)gx, (unsigned)gy, B < 65535 ? B : 65535);
  *frr = f < R ? f : R;
  *frc = f < C ? f : C;
  return cudaSuccess;
}

}  // namespace

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).
// `scheme` is the index in kernels/matmul.py:SCHEMES; the *_bf16 flags pick
// bf16 (1) or float32 (0) storage; `cen` is the center in taps
// (fwd_center(hlen) forward, swt_inv_center(hlen) inverse), f the dilation.

extern "C" int pdwt_swt_fwd_level_2d_mxu(const void* x, float* a, void* h, void* v, void* d,
                                         int B, int R, int C, const float* lo1, const float* lo2,
                                         const float* hi1, const float* hi2, int hlen, int f,
                                         int cen, int scheme, int in_bf16, int det_bf16,
                                         void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || R < 1 || C < 1 || f < 1)
    return cudaErrorInvalidValue;
  dim3 grid;
  int frr, frc;
  cudaError_t e = level_grid(B, R, C, f, &grid, &frr, &frc);
  if (e != cudaSuccess) return e;
  const Taps4 tp = make_taps4(lo1, lo2, hi1, hi2, hlen);
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    return with_type(in_bf16, [&](auto ti) {
      using TI = typename decltype(ti)::type;
      return with_type(det_bf16, [&](auto td) -> cudaError_t {
        using TD = typename decltype(td)::type;
        constexpr int nd = kDataLo<S> ? 2 : 1;
        const size_t W = LT + hlen - 1;
        const size_t smem = sizeof(Stage<S>) * nd * (W * W + 2 * LT * W);
        auto kernel = swt_fwd_mxu_kernel<S, TI, TD>;
        cudaError_t e2 = prepare(kernel, smem);
        if (e2 != cudaSuccess) return e2;
        kernel<<<grid, dim3(BX, BY), smem, (cudaStream_t)stream>>>(
            static_cast<const TI*>(x), a, static_cast<TD*>(h), static_cast<TD*>(v),
            static_cast<TD*>(d), B, R, C, hlen, f, cen, frr, frc, tp);
        return cudaGetLastError();
      });
    });
  });
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
      threads % 32 || lc % (kColStrip * (f / gc)))
    return cudaErrorInvalidValue;
  const long long want_x = gc == 1 ? (C + (long long)lc - 1) / lc : axis_blocks(C, f, lc);
  if (gx != want_x || gy != axis_blocks(R, f, lr) || gy > 65535 || gz != (B < 65535 ? B : 65535))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    if (lr % pdwt_strip::kRowStrip<S> || (size_t)smem != inv_smem<S>(lr, lc, f / gc, nt, nph))
      return cudaErrorInvalidValue;
    auto kernel = swt_inv_mxu_kernel<S>;
    cudaError_t e2 = prepare(kernel, smem, 0);
    if (e2 != cudaSuccess) return e2;
    kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
        a, h, v, d, out, det_bf16, out_bf16, B, R, C, hlen, f, cen, thresh_mode, beta, lr, lc, gc,
        nph, nt, taps);
    return cudaGetLastError();
  });
}
