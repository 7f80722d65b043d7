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
// Layout.  A block owns a 32 x 32 tile of positions of one residue class mod f
// along each axis (mxu_common.cuh: Axis), so every dilated tap of its outputs
// lands in the staged window of (32 + hlen - 1)^2 samples of those classes:
// shared memory does not grow with the level (db7: 45 x 45 samples at any f),
// and any size and dilation runs, the route rule's or not.
//
// Bound.  At 1024^2 a level reads one image and writes four planes (forward)
// or the reverse: 4.2 MiB of bf16 in and 4 MiB of float32 plus 6 MiB of bf16
// out at level 1 (about 4 us at 3.35 TB/s); db7's six passes of 14 taps over
// a 1024^2 plane are 88 M multiply-adds per term, 0.18 GFLOP per level and
// term, 3 us for b1 and up to 8 us for b3 on the float32 cores: the level is
// close to balanced, and the staging matters as much as the sums.  Each input
// sample is staged once per window (1.98x for db7 at LT = 32) and split then,
// never per tap; the row-pass temps never leave shared memory.  At f > 1 the
// tile's global reads and writes are f apart (uncoalesced); a layout with
// consecutive columns and tensor cores over band tiles are later work.

#include "mxu_common.cuh"

namespace {

using namespace pdwt_mxu;

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
// Stages the W x W windows of the four subbands split into the scheme's
// operands (H, V, D thresholded first when `mode` asks); synthesises along
// the rows from (A, H) and from (V, D) into two shared temps, each one
// float32 sum over the low taps on the first band then the high taps on the
// second, split again; then along the columns, the low taps on the first temp
// then the high taps on the second, and writes the output once.
// ---------------------------------------------------------------------------
template <int S, typename TD, typename TO>
__global__ void __launch_bounds__(BX * BY)
swt_inv_mxu_kernel(const float* __restrict__ a, const TD* __restrict__ h,
                   const TD* __restrict__ v, const TD* __restrict__ d, TO* __restrict__ out,
                   int B, int R, int C, int hlen, int f, int cen, int frr, int frc, int mode,
                   const float* __restrict__ beta, const __grid_constant__ Taps4 tp) {
  using St = Stage<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nd = kDataLo<S> ? 2 : 1;
  const int W = LT + hlen - 1;
  const int WW = W * W;
  St* s = reinterpret_cast<St*>(smem_raw);  // band k, operand e at s + (k*nd + e)*WW
  St* sa = s;
  St* sh = s + nd * WW;
  St* sv = s + 2 * nd * WW;
  St* sd = s + 3 * nd * WW;
  St* t1 = s + 4 * nd * WW;       // LT x W, rows synthesised from (A, H)
  St* t2 = t1 + nd * LT * W;      // LT x W, rows synthesised from (V, D)
  const int TW = LT * W;          // offset of a temp's second operand
  __shared__ float4 tq[PDWT_MXU_MAX_HLEN];
  stage_taps(tq, tp, hlen);
  const Axis ar = axis_of<LT>(blockIdx.y, frr, f), ac = axis_of<LT>(blockIdx.x, frc, f);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float bt = mode == kNone ? 0.f : __ldg(beta);

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    for (int i = ty; i < W; i += BY) {
      const size_t roff = ((size_t)b * R + wrapl(ar.at(i - cen), R)) * C;
      for (int j = tx; j < W; j += BX) {
        const size_t o = roff + wrapl(ac.at(j - cen), C);
        const int k = i * W + j;
        stage<S>(__ldg(a + o), sa, sa + WW, k);
        stage<S>(thresh(load_f(h + o), mode, bt), sh, sh + WW, k);
        stage<S>(thresh(load_f(v + o), mode, bt), sv, sv + WW, k);
        stage<S>(thresh(load_f(d + o), mode, bt), sd, sd + WW, k);
      }
    }
    __syncthreads();

    // along the rows: output row tt of every window column
    for (int tt = ty; tt < LT; tt += BY) {
      for (int col = tx; col < W; col += BX) {
        const int base = tt * W + col;
        Acc<S> acc1, acc2;
        for (int j = 0; j < hlen; ++j) {
          const int i = base + j * W;
          const float x1 = kDataLo<S> ? to_f(sa[i + WW]) : 0.f;
          const float y1 = kDataLo<S> ? to_f(sv[i + WW]) : 0.f;
          const float4 t = tq[j];
          acc1.add(t.x, t.y, to_f(sa[i]), x1);
          acc2.add(t.x, t.y, to_f(sv[i]), y1);
        }
        for (int j = 0; j < hlen; ++j) {
          const int i = base + j * W;
          const float x1 = kDataLo<S> ? to_f(sh[i + WW]) : 0.f;
          const float y1 = kDataLo<S> ? to_f(sd[i + WW]) : 0.f;
          const float4 t = tq[j];
          acc1.add(t.z, t.w, to_f(sh[i]), x1);
          acc2.add(t.z, t.w, to_f(sd[i]), y1);
        }
        stage<S>(acc1.total(), t1, t1 + TW, base);
        stage<S>(acc2.total(), t2, t2 + TW, base);
      }
    }
    __syncthreads();

    // along the columns
    const long long c = ac.at(tx);
    for (int tt = ty; tt < LT; tt += BY) {
      const int base = tt * W + tx;
      Acc<S> acc;
      for (int j = 0; j < hlen; ++j) {
        const float x1 = kDataLo<S> ? to_f(t1[base + j + TW]) : 0.f;
        const float4 t = tq[j];
        acc.add(t.x, t.y, to_f(t1[base + j]), x1);
      }
      for (int j = 0; j < hlen; ++j) {
        const float x1 = kDataLo<S> ? to_f(t2[base + j + TW]) : 0.f;
        const float4 t = tq[j];
        acc.add(t.z, t.w, to_f(t2[base + j]), x1);
      }
      const long long r = ar.at(tt);
      if (r < R && c < C) out[((size_t)b * R + r) * C + c] = from_f<TO>(acc.total());
    }
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

// thresh_mode: 0 none, 1 soft, 2 hard, 3 garrote of H, V and D with the float
// at `beta` (device memory; unread when thresh_mode is 0).
extern "C" int pdwt_swt_inv_level_2d_mxu(const float* a, const void* h, const void* v,
                                         const void* d, void* out, int B, int R, int C,
                                         const float* lo1, const float* lo2, const float* hi1,
                                         const float* hi2, int hlen, int f, int cen, int scheme,
                                         int det_bf16, int out_bf16, int thresh_mode,
                                         const float* beta, void* stream) {
  if (hlen < 2 || hlen > PDWT_MXU_MAX_HLEN || B < 1 || R < 1 || C < 1 || f < 1 ||
      thresh_mode < kNone || thresh_mode > kGarrote || (thresh_mode != kNone && !beta))
    return cudaErrorInvalidValue;
  dim3 grid;
  int frr, frc;
  cudaError_t e = level_grid(B, R, C, f, &grid, &frr, &frc);
  if (e != cudaSuccess) return e;
  const Taps4 tp = make_taps4(lo1, lo2, hi1, hi2, hlen);
  return with_scheme(scheme, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    return with_type(det_bf16, [&](auto td) {
      using TD = typename decltype(td)::type;
      return with_type(out_bf16, [&](auto to) -> cudaError_t {
        using TO = typename decltype(to)::type;
        constexpr int nd = kDataLo<S> ? 2 : 1;
        const size_t W = LT + hlen - 1;
        const size_t smem = sizeof(Stage<S>) * nd * (4 * W * W + 2 * LT * W);
        auto kernel = swt_inv_mxu_kernel<S, TD, TO>;
        cudaError_t e2 = prepare(kernel, smem);
        if (e2 != cudaSuccess) return e2;
        kernel<<<grid, dim3(BX, BY), smem, (cudaStream_t)stream>>>(
            a, static_cast<const TD*>(h), static_cast<const TD*>(v), static_cast<const TD*>(d),
            static_cast<TO*>(out), B, R, C, hlen, f, cen, frr, frc, thresh_mode, beta, tp);
        return cudaGetLastError();
      });
    });
  });
}
