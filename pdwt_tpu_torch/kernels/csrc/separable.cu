// Separable periodization DWT kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (pdwt_tpu_torch/kernels/_build.py).
//
// Four kernels, one per Pallas kernel of pdwt_tpu/kernels/separable_pallas.py:
//
//   fwd_level_kernel  <- _make_fwd_kernel       (separable_pallas.py:234)
//   inv_level_kernel  <- _make_inv_kernel       (separable_pallas.py:385)
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
// Periodic boundaries are an index "mod N" at load time, as in the reference
// CUDA library; nothing is padded on the host.  Taps travel as float32 kernel
// parameters (__grid_constant__), read through the constant bank.

#include <cuda_runtime.h>

#define PDWT_MAX_HLEN 128
#define PDWT_MAX_TAIL_LEVELS 16

namespace {

struct Taps {
  float lo[PDWT_MAX_HLEN];
  float hi[PDWT_MAX_HLEN];
};

struct Poly {
  int p[2];
  int o[2];
  int nb[2];
  int lo;
  int hi;
};

struct OutBands {
  float* p[3 * PDWT_MAX_TAIL_LEVELS];
};

struct InBands {
  const float* p[3 * PDWT_MAX_TAIL_LEVELS];
};

// Level kernels: a block owns an LT x LT tile of coefficients (forward: of
// each output subband; inverse: of each input subband) and runs with
// BX x BY threads, BX == LT.
constexpr int LT = 32;
constexpr int BX = 32;
constexpr int BY = 8;
// Tail kernels: one block of TAIL_THREADS threads per batch element.
constexpr int TAIL_THREADS = 1024;
// Dynamic shared memory a block may use on Hopper.
constexpr size_t SMEM_LIMIT = 232448;

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// ---------------------------------------------------------------------------
// Forward level.  Replaces _make_fwd_kernel (separable_pallas.py:234).
// Bound: device memory.  Per level it reads the input once (R x C) and writes
// the four subbands once (R x C in all); the 2*hlen FMAs per output of each
// pass are cheap beside that.  Design: the block loads its input window, halo
// included, into shared memory with the periodic index, runs the pass along
// the columns (last axis) into a shared lo/hi temp, then the pass along the
// rows from that temp, and writes A, H, V, D once.  The temp never reaches
// device memory, which the two-launch reference design pays for.  The halo
// re-read costs (2*LT + hlen - 2)^2 / (2*LT)^2 of the input (1.41x for db7).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(BX * BY)
fwd_level_kernel(const float* __restrict__ x, float* __restrict__ a,
                 float* __restrict__ h, float* __restrict__ v,
                 float* __restrict__ d, int B, int R, int C, int hlen, int cen,
                 const __grid_constant__ Taps taps) {
  extern __shared__ float smem[];
  const int W = 2 * LT + hlen - 2;  // input window per axis
  float* s_in = smem;               // W x W
  float* s_lo = s_in + W * W;       // W x LT, low-pass along the columns
  float* s_hi = s_lo + W * LT;      // W x LT, high-pass along the columns
  const int Mr = R / 2, Mc = C / 2;
  const int m0 = blockIdx.y * LT, n0 = blockIdx.x * LT;
  const int r0 = 2 * m0 - cen, c0 = 2 * n0 - cen;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const float* xb = x + (size_t)b * R * C;
    for (int i = ty; i < W; i += BY) {
      const float* row = xb + (size_t)wrap(r0 + i, R) * C;
      for (int j = tx; j < W; j += BX) s_in[i * W + j] = __ldg(row + wrap(c0 + j, C));
    }
    __syncthreads();

    // along the columns: output column tx of every window row
    for (int i = ty; i < W; i += BY) {
      const float* src = s_in + i * W + 2 * tx;
      float lo = 0.f, hi = 0.f;
      for (int j = 0; j < hlen; ++j) {
        const float s = src[j];
        lo = fmaf(taps.lo[j], s, lo);
        hi = fmaf(taps.hi[j], s, hi);
      }
      s_lo[i * LT + tx] = lo;
      s_hi[i * LT + tx] = hi;
    }
    __syncthreads();

    // along the rows: A = lo(lo), H = hi rows of lo, V = lo rows of hi, D
    const int n = n0 + tx;
    for (int mm = ty; mm < LT; mm += BY) {
      float aa = 0.f, hh = 0.f, vv = 0.f, dd = 0.f;
      for (int j = 0; j < hlen; ++j) {
        const float l = s_lo[(2 * mm + j) * LT + tx];
        const float g = s_hi[(2 * mm + j) * LT + tx];
        aa = fmaf(taps.lo[j], l, aa);
        hh = fmaf(taps.hi[j], l, hh);
        vv = fmaf(taps.lo[j], g, vv);
        dd = fmaf(taps.hi[j], g, dd);
      }
      const int m = m0 + mm;
      if (m < Mr && n < Mc) {
        const size_t o = ((size_t)b * Mr + m) * Mc + n;
        a[o] = aa;
        h[o] = hh;
        v[o] = vv;
        d[o] = dd;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Inverse level.  Replaces _make_inv_kernel (separable_pallas.py:385).
// Bound: device memory, as the forward level: the four subbands are read once
// and the image written once.  Design: the block loads the LT x LT windows of
// the four subbands (halo lo/hi of poly_geometry) with the periodic index,
// synthesises along the rows into two shared temps, (A,H) and (V,D), each with
// both output parities, then along the columns, and writes each output pair
// (2u, 2u+1) as one float2.  The polyphase form reads no stuffed zeros.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(BX * BY)
inv_level_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ v, const float* __restrict__ d,
                 float* __restrict__ out, int B, int Mr, int Mc, int hlen,
                 const Poly g, const __grid_constant__ Taps taps) {
  extern __shared__ float smem[];
  const int W = LT + g.lo + g.hi;  // coefficient window per axis
  float* s_a = smem;
  float* s_h = s_a + W * W;
  float* s_v = s_h + W * W;
  float* s_d = s_v + W * W;
  float* s_t1 = s_d + W * W;         // 2LT x W, rows synthesised from (A, H)
  float* s_t2 = s_t1 + 2 * LT * W;   // 2LT x W, rows synthesised from (V, D)
  const int R = 2 * Mr, C = 2 * Mc;
  const int t0 = blockIdx.y * LT, u0 = blockIdx.x * LT;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const size_t boff = (size_t)b * Mr * Mc;
    for (int i = ty; i < W; i += BY) {
      const size_t roff = boff + (size_t)wrap(t0 - g.lo + i, Mr) * Mc;
      for (int j = tx; j < W; j += BX) {
        const size_t o = roff + wrap(u0 - g.lo + j, Mc);
        s_a[i * W + j] = __ldg(a + o);
        s_h[i * W + j] = __ldg(h + o);
        s_v[i * W + j] = __ldg(v + o);
        s_d[i * W + j] = __ldg(d + o);
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
          float acc1 = 0.f, acc2 = 0.f;
          for (int k = 0; k < nb; ++k) {
            acc1 = fmaf(taps.lo[p + 2 * k], s_a[base + k * W], acc1);
            acc2 = fmaf(taps.lo[p + 2 * k], s_v[base + k * W], acc2);
          }
          for (int k = 0; k < nb; ++k) {
            acc1 = fmaf(taps.hi[p + 2 * k], s_h[base + k * W], acc1);
            acc2 = fmaf(taps.hi[p + 2 * k], s_d[base + k * W], acc2);
          }
          s_t1[(2 * t + q) * W + col] = acc1;
          s_t2[(2 * t + q) * W + col] = acc2;
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
        float acc = 0.f;
        for (int k = 0; k < nb; ++k) acc = fmaf(taps.lo[p + 2 * k], s_t1[base + k], acc);
        for (int k = 0; k < nb; ++k) acc = fmaf(taps.hi[p + 2 * k], s_t2[base + k], acc);
        res[q] = acc;
      }
      const int orow = 2 * t0 + r2, ocol = 2 * (u0 + tx);
      if (orow < R && ocol < C)
        *reinterpret_cast<float2*>(out + ((size_t)b * R + orow) * C + ocol) =
            make_float2(res[0], res[1]);
    }
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

Poly make_poly(const int* geo) {
  Poly g;
  g.p[0] = geo[0];
  g.p[1] = geo[1];
  g.o[0] = geo[2];
  g.o[1] = geo[3];
  g.nb[0] = geo[4];
  g.nb[1] = geo[5];
  g.lo = geo[6];
  g.hi = geo[7];
  return g;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

dim3 level_grid(int Mr, int Mc, int B) {
  return dim3((Mc + LT - 1) / LT, (Mr + LT - 1) / LT, B < 65535 ? B : 65535);
}

}  // namespace

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).

extern "C" int pdwt_fwd_level_2d(const float* x, float* a, float* h, float* v, float* d,
                                 int B, int R, int C, const float* taps_lo,
                                 const float* taps_hi, int hlen, int cen, void* stream) {
  if (hlen < 2 || hlen > PDWT_MAX_HLEN || B < 1 || R < 2 || C < 2 || ((R | C) & 1))
    return cudaErrorInvalidValue;
  const int W = 2 * LT + hlen - 2;
  const size_t smem = sizeof(float) * ((size_t)W * W + 2 * (size_t)W * LT);
  cudaError_t e = prepare(fwd_level_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = level_grid(R / 2, C / 2, B);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  fwd_level_kernel<<<grid, dim3(BX, BY), smem, (cudaStream_t)stream>>>(
      x, a, h, v, d, B, R, C, hlen, cen, make_taps(taps_lo, taps_hi, hlen));
  return cudaGetLastError();
}

extern "C" int pdwt_inv_level_2d(const float* a, const float* h, const float* v,
                                 const float* d, float* out, int B, int Mr, int Mc,
                                 const float* taps_lo, const float* taps_hi, int hlen,
                                 const int* geo, void* stream) {
  if (hlen < 2 || hlen > PDWT_MAX_HLEN || B < 1 || Mr < 1 || Mc < 1)
    return cudaErrorInvalidValue;
  const Poly g = make_poly(geo);
  const int W = LT + g.lo + g.hi;
  const size_t smem = sizeof(float) * (4 * (size_t)W * W + 4 * (size_t)LT * W);
  cudaError_t e = prepare(inv_level_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = level_grid(Mr, Mc, B);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  inv_level_kernel<<<grid, dim3(BX, BY), smem, (cudaStream_t)stream>>>(
      a, h, v, d, out, B, Mr, Mc, hlen, g, make_taps(taps_lo, taps_hi, hlen));
  return cudaGetLastError();
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
