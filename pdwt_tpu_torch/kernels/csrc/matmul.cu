// The 2D level kernels of the precision tiers for Hopper (sm_90a), with a plain
// C interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py links
// this file with the other sources into one library).
//
// The kernels of the two Pallas kernels of pdwt_tpu/kernels/matmul_pallas.py:
//
//   fwd_mxu_kernel                <- _fwd_mxu_kernel  (matmul_pallas.py:242)
//   separable.cu: inv_level_kernel <- _inv_mxu_kernel  (matmul_pallas.py:360)
//
// The synthesis is kernel 2's body on band_strip.cuh, templated on the
// scheme (separable.cu), reached through this file's entry point.
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
// pair of the forward is a template instance (the inverse takes them as
// run-time flags); bf16 is loaded and stored 2 bytes at a time, so a window
// that starts on an odd column needs no alignment.
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

// A block of the forward owns an LT x LT tile of each output subband and runs
// BX x BY threads.
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

namespace pdwt_sep {
int launch_inv_level(const float* a, const void* h, const void* v, const void* d, void* out,
                     int B, int Mr, int Mc, const float* taps, int hlen, const int* geo,
                     int scheme, int det_bf16, int out_bf16, int lr, int lc, int nt, int threads,
                     int gx, int gy, int gz, int smem, void* stream);
}

// Kernel 12 runs kernel 2's body (separable.cu: inv_level_kernel) in the
// scheme.  `taps` is a (4, hlen) float32 device buffer (the low filter's
// first and second values, then the high filter's, correlation order), `geo`
// poly_geometry(hlen); the launch plan (kernels/separable.py:
// inv_level_launch_plan for the scheme: tile lr x lc, nt padded taps per
// parity, threads, grid (gx, gy, gz), dynamic shared-memory bytes) is
// checked by the launcher, which refuses one that does not add up.
extern "C" int pdwt_inv_level_2d_mxu(const float* a, const void* h, const void* v, const void* d,
                                     void* out, int B, int Mr, int Mc, const float* taps, int hlen,
                                     const int* geo, int scheme, int det_bf16, int out_bf16,
                                     int lr, int lc, int nt, int threads, int gx, int gy, int gz,
                                     int smem, void* stream) {
  return pdwt_sep::launch_inv_level(a, h, v, d, out, B, Mr, Mc, taps, hlen, geo, scheme,
                                    det_bf16, out_bf16, lr, lc, nt, threads, gx, gy, gz, smem,
                                    stream);
}
