// The compute schemes of the precision tiers, shared by separable.cu (2D;
// kernel 12 runs its synthesis), swt_matmul.cu (2D a-trous; kernels 11 and 1
// run its analysis at step 2), mxu1d.cu (batched 1D) and ns_matmul.cu (rank-r
// non-separable); the exact kernels (1, 2 and 5-10) are their fd instances,
// launched through the tiers' entry points with scheme FD.  The scheme table
// is pdwt_tpu_torch/kernels/matmul.py's:
//
//   b1   sum h(f) h(x)                       (one term)
//   fd   sum f x in float32                  (one term)
//   b2f  sum f_h h(x) + sum f_l h(x)
//   b2d  sum f_h x_h + sum f_h x_l
//   b3   sum f_h x_h + sum f_h x_l + sum f_l x_h
//
// h() rounds to bf16, nearest even; x_h = h(x), x_l = h(x - x_h).  The host
// splits the taps (t1 = f_h, or f for fd; t2 = f_l); the kernels split the
// data.  Every product of two bf16 values is exact in float32, so an FMA
// gives the plain version's product-then-sum bit for bit; each term keeps
// its own float32 sum over the taps, in the plain version's tap order, and
// the terms are added in table order at the end.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#define PDWT_MXU_MAX_HLEN 128

namespace pdwt_mxu {

// The order of kernels/matmul.py:SCHEMES.
enum Scheme { B1 = 0, FD = 1, B2F = 2, B2D = 3, B3 = 4 };

// poly_geometry(hlen) of core/conv.py: the polyphase synthesis's offsets.
struct Poly {
  int p[2];
  int o[2];
  int nb[2];
  int lo;
  int hi;
};

// The Poly of the int32 array kernels/_launch.py:poly_geo passes:
// p[0], p[1], o[0], o[1], nb[0], nb[1], lo, hi.
inline Poly make_poly(const int* geo) {
  return {{geo[0], geo[1]}, {geo[2], geo[3]}, {geo[4], geo[5]}, geo[6], geo[7]};
}

// Does the scheme use the data's second operand x_l?
template <int S>
constexpr bool kDataLo = (S == B2D || S == B3);

// How a scheme's data operands are kept in shared memory: float for fd,
// bf16 (exact: they are bf16 values) for the others.
template <int S>
using Stage = std::conditional_t<S == FD, float, __nv_bfloat16>;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The scheme's data operands of one value: (x, -) for fd, (h(x), -) for
// b1/b2f, (x_h, x_l) for b2d/b3.
template <int S>
__device__ __forceinline__ void split(float v, float& d1, float& d2) {
  if constexpr (S == FD) {
    d1 = v;
    d2 = 0.f;
  } else {
    d1 = round_bf16(v);
    d2 = kDataLo<S> ? round_bf16(v - d1) : 0.f;
  }
}

// Split v and store its operands at index i of the two staging arrays.
template <int S>
__device__ __forceinline__ void stage(float v, Stage<S>* s1, Stage<S>* s2, int i) {
  float d1, d2;
  split<S>(v, d1, d2);
  s1[i] = from_f<Stage<S>>(d1);
  if constexpr (kDataLo<S>) s2[i] = from_f<Stage<S>>(d2);
}

// One output's sums, one float32 accumulator per term.
template <int S>
struct Acc {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  // one tap: t1, t2 its first and second value, d1, d2 the data operands
  __device__ __forceinline__ void add(float t1, float t2, float d1, float d2) {
    s0 = fmaf(t1, d1, s0);
    if constexpr (S == B2F) s1 = fmaf(t2, d1, s1);
    if constexpr (kDataLo<S>) s1 = fmaf(t1, d2, s1);
    if constexpr (S == B3) s2 = fmaf(t2, d1, s2);
  }
  __device__ __forceinline__ float total() const {
    if constexpr (S == B3) return (s0 + s1) + s2;
    if constexpr (S == B2F || S == B2D) return s0 + s1;
    return s0;
  }
};

// Call f(std::integral_constant<int, S>) for a runtime scheme S.
template <typename F>
cudaError_t with_scheme(int scheme, F&& f) {
  switch (scheme) {
    case B1: return f(std::integral_constant<int, B1>{});
    case FD: return f(std::integral_constant<int, FD>{});
    case B2F: return f(std::integral_constant<int, B2F>{});
    case B2D: return f(std::integral_constant<int, B2D>{});
    case B3: return f(std::integral_constant<int, B3>{});
    default: return cudaErrorInvalidValue;
  }
}

constexpr size_t kSmemLimit = 232448;  // shared memory a block may use

// Allow `smem` bytes of dynamic shared memory (the kernels use no static
// shared memory).  Past 48 KB a launch needs the kernel's opt-in, or it is
// refused.
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

// i mod n in [0, n), for any i.
__device__ __forceinline__ int wrapl(long long i, int n) {
  const int r = static_cast<int>(i % n);
  return r < 0 ? r + n : r;
}

// thresh_mode of the fused a-trous syntheses and norm_mode of the fused
// norms (kernels/_launch.py:THRESH_CODES).
enum Thresh { kNone = 0, kSoft = 1, kHard = 2, kGarrote = 3 };

// The elementwise thresholds of the TPU kernels (swt_pallas.py:206-214) in
// float32: soft sign(x) max(|x| - b, 0), hard x where |x| > b, garrote
// x - b^2 / x where x^2 > b^2, each else 0.
__device__ __forceinline__ float thresh(float x, int mode, float b) {
  if (mode == kSoft) {
    const float m = fmaxf(fabsf(x) - b, 0.f);
    return x > 0.f ? m : (x < 0.f ? -m : 0.f);
  }
  if (mode == kHard) return fabsf(x) > b ? x : 0.f;
  if (mode == kGarrote) {
    const float b2 = b * b;
    return x * x > b2 ? x - b2 / (x == 0.f ? 1.f : x) : 0.f;
  }
  return x;
}

// The thresholded L1 norm that kernel 5's norm launches take as they store
// (swt_matmul.cu: swt_fwd_mxu_kernel<FD, 1, mode>): the threshold mode of H,
// V and D (kNone: no norm) at the float at `beta` (device memory), |A| added
// too where `approx` (the last level), and one float32 partial a block into
// partials[block], the blocks numbered x fastest, then y, then z.
struct NormOut {
  int mode;
  const float* beta;
  float* partials;
  int approx;
};

// |thresh(x, M, b)|, the term of the fused thresholded L1 norm
// (ops/norms.py: thresholded_norm1): soft max(|x| - b, 0), hard |x| where
// |x| > b, garrote |x| - b2 / |x| where |x| > b, each else 0; b2 = b * b in
// float32, as ops/threshold.py: beta_squared rounds it.  The mode is a
// constant: a run-time one cost kernel 5's norm launches a third more time
// in their stores.
template <int M>
__device__ __forceinline__ float thresh_l1(float x, float b, float b2) {
  const float ax = fabsf(x);
  if constexpr (M == kSoft) return fmaxf(ax - b, 0.f);
  if constexpr (M == kHard) return ax > b ? ax : 0.f;
  if constexpr (M == kGarrote) return ax > b ? ax - b2 / ax : 0.f;
  return ax;
}

// A block's share of one axis of an a-trous level at dilation f: it owns the
// LT positions rho + (q0 + t) * f, t < LT, of residue class rho mod f, so a
// dilated tap of any of them lands in the same class and a window of
// LT + hlen - 1 positions of that class covers the block's taps at any f.
// The grid numbers (class, chunk) pairs: class = index % fr, fr = min(f, n).
struct Axis {
  int rho, q0, f;
  // the position of tile (or window) entry t along the axis, before the wrap
  __device__ __forceinline__ long long at(int t) const {
    return rho + static_cast<long long>(q0 + t) * f;
  }
};

template <int LT>
__device__ __forceinline__ Axis axis_of(unsigned index, int fr, int f) {
  return {static_cast<int>(index % fr), static_cast<int>(index / fr) * LT, f};
}

// Blocks along an axis of n positions at dilation f with tiles of LT: fr
// classes, each of ceil(n / f) positions at most, cut into chunks of LT.
inline long long axis_blocks(int n, int f, int lt) {
  const long long fr = f < n ? f : n;
  const long long nq = (n + static_cast<long long>(f) - 1) / f;
  return fr * ((nq + lt - 1) / lt);
}

}  // namespace pdwt_mxu
