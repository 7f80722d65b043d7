// Separable periodization DWT kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py).
//
// The kernels of the four Pallas kernels of pdwt_tpu/kernels/separable_pallas.py:
//
//   swt_matmul.cu: swt_fwd_mxu_kernel<FD, 2>
//                     <- _make_fwd_kernel       (separable_pallas.py:234)
//   inv_level_kernel  <- _make_inv_kernel       (separable_pallas.py:385),
//                        and _inv_mxu_kernel (matmul_pallas.py:360) in the
//                        precision tiers' compute schemes (kernel 12)
//   fwd_tail_kernel   <- _make_tail_fwd_kernel  (separable_pallas.py:576)
//   inv_tail_kernel   <- _make_tail_inv_kernel  (separable_pallas.py:648)
//
// Index spec (pdwt_tpu_torch/core/conv.py, the same as pdwt_tpu/core/conv.py):
//   analysis   out[n]      = sum_j t[j] * x[(2n - cen + j) mod N]
//   synthesis  out[2m + q] = sum_band sum_b t_band[p_q + 2b] * x_band[(m + o_q + b) mod M]
// with t the reversed filter (correlation order), cen = fwd_center(hlen) and
// (p, o, nb, lo, hi) = poly_geometry(hlen).  The wrappers compute cen and the
// polyphase geometry with those Python helpers and pass them in, so the offsets
// are defined once.  Sizes reaching these kernels are even: odd sizes are
// extended by one sample (odd_extend) before the call.
//
// The analysis level (kernel 1) is kernel 11's function in the fd scheme on
// float32 data: one float32 sum per output and pass, the taps in order, one
// FMA each.  So its entry point (pdwt_fwd_level_2d, below) runs kernel 13's
// body at output step 2 (swt_matmul.cu: swt_fwd_mxu_kernel<FD, 2>, through
// pdwt_swtmm::launch_fwd), on a launch plan made on the host
// (kernels/separable.py: fwd_level_launch_plan): rows (axis -2) first, then
// the columns, as the Pallas kernel (separable_pallas.py:272-283); its plain
// version runs the columns first, so the two differ by float32 roundoff.
//
// Periodic boundaries are an index "mod N" at load time, as in the reference
// CUDA library; nothing is padded on the host.  The tails take their taps as
// float32 kernel parameters (__grid_constant__), read through the constant
// bank; the levels (redesigned for Hopper's CUDA cores on band_strip.cuh,
// their launch plans from the host) read them from a small device buffer
// into shared memory.

#include "band_strip.cuh"

#define PDWT_MAX_HLEN 128
#define PDWT_MAX_TAIL_LEVELS 16

namespace {

using namespace pdwt_strip;

struct Taps {
  float lo[PDWT_MAX_HLEN];
  float hi[PDWT_MAX_HLEN];
};

struct OutBands {
  float* p[3 * PDWT_MAX_TAIL_LEVELS];
};

struct InBands {
  const float* p[3 * PDWT_MAX_TAIL_LEVELS];
};

// Tail kernels: one block of TAIL_THREADS threads per batch element.
constexpr int TAIL_THREADS = 1024;

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// ---------------------------------------------------------------------------
// Inverse level.  Replaces _make_inv_kernel (separable_pallas.py:385) and,
// in the compute schemes of the precision tiers, _inv_mxu_kernel
// (matmul_pallas.py:360; matmul.cu's entry pdwt_inv_level_2d_mxu).  Bound:
// device memory, as the analysis level: the four subbands are read once and
// the image written once (32 MiB at 1024^2 float32 subbands, 10 us at 3.35
// TB/s); the 2 hlen multiply-adds per output of each pass take about a third
// of that at the float32 rate (b3: three terms, as much as the bytes).
// Redesigned for Hopper's CUDA cores on band_strip.cuh, as kernel 18's
// polyphase synthesis (ns_matmul.cu; its body would sum all four subbands
// into each temp, twice this row pass's work, and takes 40 taps at most): a
// block owns lr x lc subband positions, and its launch plan
// (kernels/separable.py:inv_level_launch_plan) shrinks the tile on the deep
// levels so that they still get about two blocks per SM.  Per batch item:
// stage the windows of the four subbands (lr + offmax + nt - 1 rows by lc +
// offmax + nt - 1 columns, wrapped through 32-bit index tables, 16 loads per
// thread in flight, the taps read around the first staging, split into the
// scheme's operands; H, V, D float32 or bf16); along the rows, each thread
// takes a strip of kRowStrip subband rows of one window column and, per
// output parity q, sums the low taps on A then the high taps on H (on V then
// D) into the temp of (A, H) (of (V, D)), rows 2 (r0 + i) + q, split again
// per scheme (b1, b2f: rounded to bf16; b2d, b3: hi and lo; fd: float32), as
// the plain version splits the row pass's result; along the columns, each
// thread takes a strip of kColStrip positions of one temp row and, per
// parity, sums the low taps on the first temp then the high taps on the
// second into a float tile of 2 lr x 2 lc outputs, written out once (float32
// or rounded to bf16) with lanes along the columns.  Every output keeps one
// float32 sum per scheme term in the plain version's order (band outer, tap
// inner), so the b-schemes match it bit for bit.  Parity q's taps p_q + 2 b
// (b < nb_q) of each filter are one zero-padded table of nt taps (a multiple
// of kInvCh) per value the scheme reads, read as float4 broadcasts.  The
// polyphase form reads no stuffed zeros; the checked launcher below refuses a
// plan that does not add up.
// ---------------------------------------------------------------------------
constexpr int kInvCh = 4;        // taps per chunk of the strips
constexpr int kStageLoads = 16;  // loads in flight per thread while staging

// Window offset of parity q's first tap: lo + o_q >= 0.
__host__ __device__ inline int poly_off(const Poly& g, int q) { return g.lo + g.o[q]; }

// Shared-memory bytes of the inverse level: taps, index tables, the four band
// windows (which hold the output tile once the row pass is done), the two
// temps.  kernels/separable.py:_inv_smem mirrors it.
template <int S>
size_t inv_smem(int offmax, int lr, int lc, int nt) {
  using St = Stage<S>;
  const size_t nd = kDataLo<S> ? 2 : 1, nv = kTapLo<S> ? 2 : 1;
  const size_t WR = lr + offmax + nt - 1, WC = lc + offmax + nt - 1;
  const size_t win = 4 * nd * WR * WC * sizeof(St);
  const size_t tile = 2 * (size_t)lr * (2 * lc + 1) * sizeof(float);
  return 16 * nv * (size_t)nt + align16((WR + WC) * sizeof(int)) +
         align16(win > tile ? win : tile) +
         2 * nd * 2 * (size_t)lr * temp_pitch<St>((int)WC) * sizeof(St);
}

template <int S>
__global__ void __launch_bounds__(256)
inv_level_kernel(const float* __restrict__ a, const void* __restrict__ h,
                 const void* __restrict__ v, const void* __restrict__ d, void* __restrict__ out,
                 int det_bf16, int out_bf16, int B, int Mr, int Mc, int hlen, const Poly g,
                 const float* __restrict__ taps, int lr, int lc, int nt) {
  using St = Stage<S>;
  constexpr int nd = kDataLo<S> ? 2 : 1, nv = kTapLo<S> ? 2 : 1;
  constexpr int PR = kRowStrip<S>, PC = kColStrip;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int off[2] = {poly_off(g, 0), poly_off(g, 1)};
  const int offmax = off[0] > off[1] ? off[0] : off[1];
  const int WR = lr + offmax + nt - 1, WC = lc + offmax + nt - 1;
  const int TP = temp_pitch<St>(WC), TR = 2 * lr, OC = 2 * lc + 1;
  float* t1 = reinterpret_cast<float*>(smem_raw);  // [q][low, high][nt], first values
  float* t2 = t1 + (nv - 1) * 4 * nt;               // second values (b2f, b3)
  int* rows = reinterpret_cast<int*>(t1 + nv * 4 * nt);
  int* cols = rows + WR;
  unsigned char* p = smem_raw + 16 * nv * (size_t)nt + align16((size_t)(WR + WC) * sizeof(int));
  St* win = reinterpret_cast<St*>(p);  // band s (A, H, V, D), operand e at win + (s nd + e) WR WC
  float* tile = reinterpret_cast<float*>(p);  // TR x OC, after the row pass
  const size_t wbytes = (size_t)4 * nd * WR * WC * sizeof(St);
  const size_t tbytes = (size_t)TR * OC * sizeof(float);
  St* tmp = reinterpret_cast<St*>(p + align16(wbytes > tbytes ? wbytes : tbytes));
  const int BS = nd * WR * WC, TS = nd * TR * TP;  // band and temp strides

  const int q0r = blockIdx.y * lr, q0c = blockIdx.x * lc;
  fill_index(rows, WR, (long long)q0r - g.lo, 1, Mr);
  fill_index(cols, WC, (long long)q0c - g.lo, 1, Mc);
  __syncthreads();
  // t1[(2 q + k) nt + j] = taps[2 k hlen + p_q + 2 j] (k = 0 low, 1 high), 0
  // past nb_q; t2 the same from row 2 k + 1 (the (4, hlen) buffer's second
  // values)
  auto tap = [&](int e) {
    const int j = e % nt, qk = (e / nt) % 4, q = qk >> 1, val = e / (4 * nt);
    return j < g.nb[q] ? (2 * (qk & 1) + val) * hlen + g.p[q] + 2 * j : -1;
  };

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const size_t plane = (size_t)b * Mr * Mc;
    // one staging per detail type, each with the type a constant (Bands)
    auto stage_all = [&] {
      if (det_bf16)
        stage_bands<S, 4, kStageLoads>(Bands{{a, h, v, d}, 0xeu}, 0, plane, Mc, rows, cols, WR,
                                       WC, win, BS, WR * WC, kNone, 0.f);
      else
        stage_bands<S, 4, kStageLoads>(Bands{{a, h, v, d}, 0u}, 0, plane, Mc, rows, cols, WR, WC,
                                       win, BS, WR * WC, kNone, 0.f);
    };
    if (b == (int)blockIdx.z)
      fill_around(t1, nv * 4 * nt, taps, tap, stage_all);
    else
      stage_all();
    __syncthreads();
    // along the rows: temp k from bands (2k, 2k + 1), rows 2 (r0 + i) + q of window column w
    const int per = (lr / PR) * WC;
    for (int it = threadIdx.x; it < 2 * per; it += blockDim.x) {
      const int k = it / per, rem = it % per, r0 = (rem / WC) * PR, w = rem % WC;
      St* dst = tmp + k * TS;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        Acc<S> acc[1][PR];
        band_strip<S, PR, 1, kInvCh>(acc, win + 2 * k * BS + (r0 + off[q]) * WC + w, WR * WC, BS,
                                     2, WC, t1 + 2 * q * nt, t2 + 2 * q * nt, 0, nt);
#pragma unroll
        for (int i = 0; i < PR; ++i)
          stage<S>(acc[0][i].total(), dst, dst + TR * TP, (2 * (r0 + i) + q) * TP + w);
      }
    }
    __syncthreads();
    // along the columns: temp row r2, outputs 2 (t0 + i) + q
    for (int it = threadIdx.x; it < TR * (lc / PC); it += blockDim.x) {
      const int r2 = it % TR, t0 = (it / TR) * PC;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        Acc<S> acc[1][PC];
        band_strip<S, PC, 1, kInvCh>(acc, tmp + r2 * TP + t0 + off[q], TR * TP, TS, 2, 1,
                                     t1 + 2 * q * nt, t2 + 2 * q * nt, 0, nt);
#pragma unroll
        for (int i = 0; i < PC; ++i) tile[r2 * OC + 2 * (t0 + i) + q] = acc[0][i].total();
      }
    }
    __syncthreads();
    auto orow = [&](int r2) { return 2LL * q0r + r2; };
    auto ocol = [&](int u) { return 2LL * q0c + u; };
    const size_t oplane = (size_t)b * 4 * Mr * Mc;
    if (out_bf16)
      store_tile(static_cast<__nv_bfloat16*>(out), oplane, 2 * Mr, 2 * Mc, tile, OC, TR, 2 * lc,
                 orow, ocol);
    else
      store_tile(static_cast<float*>(out), oplane, 2 * Mr, 2 * Mc, tile, OC, TR, 2 * lc, orow,
                 ocol);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Forward tail.  Replaces _make_tail_fwd_kernel (separable_pallas.py:576).
// Bound: at the small deep levels it serves, launch count and latency, not
// bytes (a 128x128 level is 64 KiB).  Design: one block per batch element runs
// all remaining levels in one launch; the approximation stays in shared memory
// from level to level, and H, V, D of each level go straight to device memory.
// The periodic index walks with the tap (k = k + 1, back to 0 at N), so halos
// wider than the level (long filters at 8-pixel levels) need nothing special.
// Shared memory: 2 * R * C floats (approximation and the lo/hi temp).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(TAIL_THREADS)
fwd_tail_kernel(const float* __restrict__ x, float* __restrict__ a_out,
                const __grid_constant__ OutBands det, int R, int C, int levels,
                int hlen, int cen, const __grid_constant__ Taps taps) {
  extern __shared__ float smem[];
  float* s_a = smem;          // the current approximation, r x c
  float* s_t = smem + R * C;  // lo then hi along the columns, r x c/2 each
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* xb = x + (size_t)b * R * C;
  for (int i = tid; i < R * C; i += TAIL_THREADS) s_a[i] = xb[i];
  __syncthreads();

  int r = R, c = C;
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int mr = r / 2, mc = c / 2;
    float* s_lo = s_t;
    float* s_hi = s_t + r * mc;
    for (int idx = tid; idx < r * mc; idx += TAIL_THREADS) {
      const int i = idx / mc, n = idx - i * mc;
      const float* row = s_a + i * c;
      int k = wrap(2 * n - cen, c);
      float lo = 0.f, hi = 0.f;
      for (int j = 0; j < hlen; ++j) {
        const float s = row[k];
        lo = fmaf(taps.lo[j], s, lo);
        hi = fmaf(taps.hi[j], s, hi);
        if (++k == c) k = 0;
      }
      s_lo[idx] = lo;
      s_hi[idx] = hi;
    }
    __syncthreads();

    const size_t boff = (size_t)b * mr * mc;
    float* H = det.p[3 * lvl] + boff;
    float* V = det.p[3 * lvl + 1] + boff;
    float* D = det.p[3 * lvl + 2] + boff;
    float* A = (lvl == levels - 1) ? a_out + boff : s_a;
    for (int idx = tid; idx < mr * mc; idx += TAIL_THREADS) {
      const int m = idx / mc, n = idx - m * mc;
      int k = wrap(2 * m - cen, r);
      float aa = 0.f, hh = 0.f, vv = 0.f, dd = 0.f;
      for (int j = 0; j < hlen; ++j) {
        const float l = s_lo[k * mc + n];
        const float gg = s_hi[k * mc + n];
        aa = fmaf(taps.lo[j], l, aa);
        hh = fmaf(taps.hi[j], l, hh);
        vv = fmaf(taps.lo[j], gg, vv);
        dd = fmaf(taps.hi[j], gg, dd);
        if (++k == r) k = 0;
      }
      A[idx] = aa;
      H[idx] = hh;
      V[idx] = vv;
      D[idx] = dd;
    }
    __syncthreads();
    r = mr;
    c = mc;
  }
}

// ---------------------------------------------------------------------------
// Inverse tail.  Replaces _make_tail_inv_kernel (separable_pallas.py:648).
// Bound: launch count and latency, as the forward tail.  Design: one block per
// batch element synthesises the k deepest levels, deepest first; the
// approximation stays in shared memory, H, V, D are read from device memory
// where they are needed, and only the last level's output is written out.
// Shared memory: R*C/4 floats for the approximation, R*C for the two row
// temps; the wrapper reserves 2*R*C, the forward tail's size, so that one
// predicate (tail_supported) covers both directions.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(TAIL_THREADS)
inv_tail_kernel(const float* __restrict__ a_in, const __grid_constant__ InBands det,
                float* __restrict__ out, int mr0, int mc0, int levels, int hlen,
                const Poly g, const __grid_constant__ Taps taps) {
  extern __shared__ float smem[];
  const int R = mr0 << levels, C = mc0 << levels;
  float* s_a = smem;                  // the current approximation, r x c
  float* s_t = smem + (R / 2) * (C / 2);
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* ab = a_in + (size_t)b * mr0 * mc0;
  for (int i = tid; i < mr0 * mc0; i += TAIL_THREADS) s_a[i] = ab[i];
  __syncthreads();

  int r = mr0, c = mc0;
  for (int lvl = 0; lvl < levels; ++lvl) {
    const size_t boff = (size_t)b * r * c;
    const float* H = det.p[3 * lvl] + boff;
    const float* V = det.p[3 * lvl + 1] + boff;
    const float* D = det.p[3 * lvl + 2] + boff;
    float* s_t1 = s_t;               // 2r x c, rows synthesised from (A, H)
    float* s_t2 = s_t + 2 * r * c;   // 2r x c, rows synthesised from (V, D)
    for (int idx = tid; idx < r * c; idx += TAIL_THREADS) {
      const int t = idx / c, col = idx - t * c;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = g.p[q], nb = g.nb[q];
        const int k0 = wrap(t + g.o[q], r);
        float acc1 = 0.f, acc2 = 0.f;
        int k = k0;
        for (int j = 0; j < nb; ++j) {
          acc1 = fmaf(taps.lo[p + 2 * j], s_a[k * c + col], acc1);
          acc2 = fmaf(taps.lo[p + 2 * j], __ldg(V + k * c + col), acc2);
          if (++k == r) k = 0;
        }
        k = k0;
        for (int j = 0; j < nb; ++j) {
          acc1 = fmaf(taps.hi[p + 2 * j], __ldg(H + k * c + col), acc1);
          acc2 = fmaf(taps.hi[p + 2 * j], __ldg(D + k * c + col), acc2);
          if (++k == r) k = 0;
        }
        s_t1[(2 * t + q) * c + col] = acc1;
        s_t2[(2 * t + q) * c + col] = acc2;
      }
    }
    __syncthreads();

    float* dst = (lvl == levels - 1) ? out + (size_t)b * 4 * r * c : s_a;
    for (int idx = tid; idx < 2 * r * c; idx += TAIL_THREADS) {
      const int r2 = idx / c, u = idx - r2 * c;
      const float* t1 = s_t1 + r2 * c;
      const float* t2 = s_t2 + r2 * c;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = g.p[q], nb = g.nb[q];
        const int k0 = wrap(u + g.o[q], c);
        float acc = 0.f;
        int k = k0;
        for (int j = 0; j < nb; ++j) {
          acc = fmaf(taps.lo[p + 2 * j], t1[k], acc);
          if (++k == c) k = 0;
        }
        k = k0;
        for (int j = 0; j < nb; ++j) {
          acc = fmaf(taps.hi[p + 2 * j], t2[k], acc);
          if (++k == c) k = 0;
        }
        dst[r2 * 2 * c + 2 * u + q] = acc;
      }
    }
    __syncthreads();
    r *= 2;
    c *= 2;
  }
}

Taps make_taps(const float* lo, const float* hi, int hlen) {
  Taps t = {};
  for (int i = 0; i < hlen; ++i) {
    t.lo[i] = lo[i];
    t.hi[i] = hi[i];
  }
  return t;
}

}  // namespace

namespace pdwt_sep {

// Launch the inverse level in compute scheme `scheme` (the index in
// kernels/matmul.py:SCHEMES; H, V, D bf16 where det_bf16, the output bf16
// where out_bf16) on its launch plan (kernels/separable.py:
// inv_level_launch_plan): tile lr x lc subband positions, nt padded taps per
// parity, threads, grid (gx, gy, gz) and dynamic shared-memory bytes; a plan
// that does not add up is refused (cudaErrorInvalidValue).  `taps` is a (4,
// hlen) float32 device buffer: the low filter's first and second values,
// then the high filter's, correlation order; `geo` is poly_geometry(hlen).
// Kernel 2 (pdwt_inv_level_2d, below) runs it in fd on float32, kernel 12
// (matmul.cu: pdwt_inv_level_2d_mxu) in the tiers' schemes.
int launch_inv_level(const float* a, const void* h, const void* v, const void* d, void* out,
                     int B, int Mr, int Mc, const float* taps, int hlen, const int* geo,
                     int scheme, int det_bf16, int out_bf16, int lr, int lc, int nt, int threads,
                     int gx, int gy, int gz, int smem, void* stream) {
  if (hlen < 2 || hlen > PDWT_MAX_HLEN || B < 1 || Mr < 1 || Mc < 1)
    return cudaErrorInvalidValue;
  const Poly g = make_poly(geo);
  for (int q = 0; q < 2; ++q)
    if (poly_off(g, q) < 0 || g.p[q] < 0 || g.nb[q] < 1 || g.nb[q] > nt ||
        g.p[q] + 2 * (g.nb[q] - 1) >= hlen)
      return cudaErrorInvalidValue;
  if (nt % kInvCh || nt > PDWT_MAX_HLEN || lr < 1 || lc < 1 || lc % kColStrip || threads < 32 ||
      threads > 256 || threads % 32)
    return cudaErrorInvalidValue;
  const int offmax = poly_off(g, 0) > poly_off(g, 1) ? poly_off(g, 0) : poly_off(g, 1);
  if (gx != (Mc + (long long)lc - 1) / lc || gy != (Mr + (long long)lr - 1) / lr ||
      gy > 65535 || gz != (B < 65535 ? B : 65535))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) -> cudaError_t {
    constexpr int S = decltype(sc)::value;
    if (lr % kRowStrip<S> || (size_t)smem != inv_smem<S>(offmax, lr, lc, nt))
      return cudaErrorInvalidValue;
    auto kernel = inv_level_kernel<S>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
        a, h, v, d, out, det_bf16, out_bf16, B, Mr, Mc, hlen, g, taps, lr, lc, nt);
    return cudaGetLastError();
  });
}

}  // namespace pdwt_sep

namespace pdwt_swtmm {
int launch_fwd(const void* x, float* a, void* h, void* v, void* d, int B, int R, int C,
               const float* taps, int hlen, int os, int f, int cen, int scheme, int in_bf16,
               int det_bf16, int lr, int lc, int gc, int nph, int nt, int threads, int gx,
               int gy, int gz, int smem, void* stream);
}

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).

// Kernel 1 runs kernel 13's body (swt_matmul.cu: swt_fwd_mxu_kernel) at
// output step 2 in the fd scheme, on an even (B, R, C) float32 image into
// four float32 subbands.  `taps` is the (4, hlen) float32 device buffer of
// kernels/_launch.py: dual_taps in fd (the second values 0); `cen` =
// fwd_center(hlen); the launch plan (kernels/separable.py:
// fwd_level_launch_plan: tile lr x lc subband positions, column stride gc =
// 1, nph output phases, nt padded taps, threads, grid (gx, gy, gz), dynamic
// shared-memory bytes) is checked by the launcher, which refuses one that
// does not add up.
extern "C" int pdwt_fwd_level_2d(const float* x, float* a, float* h, float* v, float* d, int B,
                                 int R, int C, const float* taps, int hlen, int cen, int lr,
                                 int lc, int gc, int nph, int nt, int threads, int gx, int gy,
                                 int gz, int smem, void* stream) {
  return pdwt_swtmm::launch_fwd(x, a, h, v, d, B, R, C, taps, hlen, 2, 1, cen, pdwt_mxu::FD, 0,
                                0, lr, lc, gc, nph, nt, threads, gx, gy, gz, smem, stream);
}

// `taps` is the (4, hlen) float32 device buffer of kernels/_launch.py:
// dual_taps in fd (the second values 0); `geo` is poly_geometry(hlen)
// (kernels/_launch.py:poly_geo); the launch plan is
// kernels/separable.py:inv_level_launch_plan's for fd, checked by the
// launcher.
extern "C" int pdwt_inv_level_2d(const float* a, const float* h, const float* v,
                                 const float* d, float* out, int B, int Mr, int Mc,
                                 const float* taps, int hlen, const int* geo, int lr, int lc,
                                 int nt, int threads, int gx, int gy, int gz, int smem,
                                 void* stream) {
  return pdwt_sep::launch_inv_level(a, h, v, d, out, B, Mr, Mc, taps, hlen, geo, FD, 0, 0, lr,
                                    lc, nt, threads, gx, gy, gz, smem, stream);
}

// `det` holds 3*levels device pointers, (H, V, D) of level 1 first.
extern "C" int pdwt_fwd_tail_2d(const float* x, float* a_out, void* const* det, int B,
                                int R, int C, int levels, const float* taps_lo,
                                const float* taps_hi, int hlen, int cen, void* stream) {
  if (hlen < 2 || hlen > PDWT_MAX_HLEN || B < 1 || levels < 1 ||
      levels > PDWT_MAX_TAIL_LEVELS || R % (1 << levels) || C % (1 << levels))
    return cudaErrorInvalidValue;
  OutBands bands = {};
  for (int i = 0; i < 3 * levels; ++i) bands.p[i] = static_cast<float*>(det[i]);
  const size_t smem = sizeof(float) * 2 * (size_t)R * C;
  cudaError_t e = prepare(fwd_tail_kernel, smem);
  if (e != cudaSuccess) return e;
  fwd_tail_kernel<<<B, TAIL_THREADS, smem, (cudaStream_t)stream>>>(
      x, a_out, bands, R, C, levels, hlen, cen, make_taps(taps_lo, taps_hi, hlen));
  return cudaGetLastError();
}

// `det` holds 3*levels device pointers, (H, V, D) of the deepest level first.
extern "C" int pdwt_inv_tail_2d(const float* a, void* const* det, float* out, int B,
                                int Mr, int Mc, int levels, const float* taps_lo,
                                const float* taps_hi, int hlen, const int* geo,
                                void* stream) {
  if (hlen < 2 || hlen > PDWT_MAX_HLEN || B < 1 || Mr < 1 || Mc < 1 || levels < 1 ||
      levels > PDWT_MAX_TAIL_LEVELS)
    return cudaErrorInvalidValue;
  InBands bands = {};
  for (int i = 0; i < 3 * levels; ++i) bands.p[i] = static_cast<const float*>(det[i]);
  const size_t smem = sizeof(float) * 2 * ((size_t)Mr << levels) * ((size_t)Mc << levels);
  cudaError_t e = prepare(inv_tail_kernel, smem);
  if (e != cudaSuccess) return e;
  inv_tail_kernel<<<B, TAIL_THREADS, smem, (cudaStream_t)stream>>>(
      a, bands, out, Mr, Mc, levels, hlen, make_poly(geo), make_taps(taps_lo, taps_hi, hlen));
  return cudaGetLastError();
}

extern "C" const char* pdwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
