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
//   swt_matmul.cu: fwd_tail_kernel
//                     <- _make_tail_fwd_kernel  (separable_pallas.py:576)
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
// FMA each, and the synthesis level (kernel 2) kernel 12's.  So neither has
// an entry point of its own: kernels/separable.py launches kernel 11's and
// 12's (matmul.cu: pdwt_fwd_level_2d_mxu, pdwt_inv_level_2d_mxu, and their
// padded forms) with scheme FD on float32, on their launch plans in fd
// (kernels/matmul.py), and counts the launches under kernels 1's and 2's
// names.  The analysis runs kernel 13's body at output step 2
// (swt_matmul.cu: swt_fwd_mxu_kernel<FD, 2>): rows (axis -2) first, then
// the columns, as the Pallas kernel (separable_pallas.py:272-283); its plain
// version runs the columns first, so the two differ by float32 roundoff.
//
// The tails (kernels 3 and 4) fuse the deep levels into one launch, as the
// Pallas kernels do, and run each level as the level kernels run it: the
// forward tail (swt_matmul.cu: fwd_tail_kernel) on kernel 1's per-tile
// work (fwd_tile<FD, 2>), the inverse tail (below) on kernel 2's
// (inv_level_kernel<FD>'s, in a body of its own), so each level sums the
// same float32 terms in the same order as the level kernel.  A batch
// item's levels are spread over the blocks of one thread-block cluster,
// which meet at a cluster barrier between levels, on a launch plan from
// the host (kernels/separable.py: tail_launch_plan).
//
// Periodic boundaries are an index "mod N" at load time, as in the reference
// CUDA library; nothing is padded on the host.  Every kernel here is built
// on band_strip.cuh, reads its taps from a small device buffer into shared
// memory, and takes a launch plan from the host that its entry point checks.

#include <cooperative_groups.h>

#include "band_strip.cuh"

#define PDWT_MAX_HLEN 128

namespace {

using namespace pdwt_strip;

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
// (kernels/matmul.py:inv_level_launch_plan) shrinks the tile on the deep
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
// temps.  kernels/matmul.py:_inv_smem mirrors it.
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

//
// PAD: kernel 12's padded entry point (matmul.cu:
// pdwt_inv_level_2d_mxu_padded): in fd on float32 kernel 2's padded launch,
// which replaces inv_level_2d_padded (separable_pallas.py:498); in the
// tiers' schemes the replacement of the pad_fn= of inv_level_2d_mxu
// (matmul_pallas.py:442) on the ring halo of the sharded DWT: the same tile work on
// subbands the caller padded (zeros or nothing on a pywt axis, the
// periodic halo on a periodization axis), with index tables that do not
// wrap (fill_table) starting `base` coefficients in, and per axis the
// outputs from the body's output `off` on, n_out of them, written straight
// to an n_out_r x n_out_c plane (band_strip.cuh: PadAxis).  The pywt
// synthesis at shift 1 is the body's at shift inv_shift(hlen) moved by
// whole coefficients (base) and at most one output (off), so the taps and
// the geometry stay kernel 2's.  TIER (with PAD) also stores a bf16
// output where out_bf16: kernel 12's padded entry point in the tiers; the
// float32 store alone is kernel 2's padded instance (TIER false), whose
// code it keeps.
template <int S, bool PAD = false, bool TIER = false>
__global__ void __launch_bounds__(256)
inv_level_kernel(const float* __restrict__ a, const void* __restrict__ h,
                 const void* __restrict__ v, const void* __restrict__ d, void* __restrict__ out,
                 int det_bf16, int out_bf16, int B, int Mr, int Mc, int hlen, const Poly g,
                 const float* __restrict__ taps, int lr, int lc, int nt, const PadAxis pr,
                 const PadAxis pc) {
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
  fill_table<PAD>(rows, WR, (long long)pr.base + q0r - g.lo, 1, Mr);
  fill_table<PAD>(cols, WC, (long long)pc.base + q0c - g.lo, 1, Mc);
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
    if constexpr (PAD) {
      // output i is the body's output i + off; one before 0 maps past n_out
      // and is not stored
      auto orow = [&](int r2) {
        const long long r = 2LL * q0r + r2 - pr.off;
        return r < 0 ? (long long)pr.n_out : r;
      };
      auto ocol = [&](int u) {
        const long long c = 2LL * q0c + u - pc.off;
        return c < 0 ? (long long)pc.n_out : c;
      };
      const size_t op = (size_t)b * pr.n_out * pc.n_out;
      if (TIER && out_bf16)
        store_tile(static_cast<__nv_bfloat16*>(out), op, pr.n_out, pc.n_out, tile, OC, TR,
                   2 * lc, orow, ocol);
      else
        store_tile(static_cast<float*>(out), op, pr.n_out, pc.n_out, tile, OC, TR, 2 * lc, orow,
                   ocol);
      __syncthreads();
      continue;
    }
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
// Inverse tail (kernel 4).  Replaces _make_tail_inv_kernel
// (separable_pallas.py:648): the k deepest synthesis levels of (B, m, m')
// float32 subbands in one launch, deepest first, each level kernel 2's
// function (inv_level_kernel<FD> above: rows first, band outer and taps
// inner, one FMA each, in the same order).  Bound: launch count and
// latency, as the forward tail (swt_matmul.cu: fwd_tail_kernel), and spread
// the same way: a batch item owns nb blocks (one cluster where k > 1), tile
// j of a level on block j mod nb, a cluster barrier between levels, on the
// plan of kernels/separable.py: tail_launch_plan.  Each level's
// approximation goes to `scratch` and the next level stages it with
// coherent loads (load_band<CG>); the first approximation and every H, V,
// D are inputs no thread writes, read through the read-only path.  Only the
// last level writes `out`.
//
// A tile's work is inv_level_kernel<FD>'s, on the same band_strip.cuh
// pieces (fill_index, stage_bands, band_strip, store_tile), in a body of
// its own: sharing one body with the level kernel cost kernels 2 and 12
// 1-3 % on their 1024^2-256^2 levels on an H100 whatever its form (PERF.md,
// section 6), so the level kernel stays as it was.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
inv_tail_kernel(const float* __restrict__ a_in, float* __restrict__ out, float* scratch,
                const __grid_constant__ TailArgs t, int B, int mr0, int mc0, int levels, int hlen,
                const Poly g, const float* __restrict__ taps, int nb, int nt) {
  constexpr int PR = kRowStrip<FD>, PC = kColStrip;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / nb, rank = blockIdx.x % nb;
  const int off[2] = {poly_off(g, 0), poly_off(g, 1)};
  const int offmax = off[0] > off[1] ? off[0] : off[1];
  float* t1 = reinterpret_cast<float*>(smem_raw);  // [q][low, high][nt]
  int* rows = reinterpret_cast<int*>(t1 + 4 * nt);
  // t1[(2 q + k) nt + j] = taps[2 k hlen + p_q + 2 j] (k = 0 low, 1 high), 0 past nb_q
  auto tap = [&](int e) {
    const int j = e % nt, qk = (e / nt) % 4, q = qk >> 1;
    return j < g.nb[q] ? 2 * (qk & 1) * hlen + g.p[q] + 2 * j : -1;
  };
  bool load_taps = true;
  const float* src = a_in;
  float* scr = scratch;
  int mr = mr0, mc = mc0;
  for (int l = 0; l < levels; ++l) {
    const int lr = t.tile[l].lr, lc = t.tile[l].lc;
    const int tx = (mc + lc - 1) / lc, ntile = tx * ((mr + lr - 1) / lr);
    const int WR = lr + offmax + nt - 1, WC = lc + offmax + nt - 1;
    const int TP = temp_pitch<float>(WC), TR = 2 * lr, OC = 2 * lc + 1;
    int* cols = rows + WR;
    unsigned char* p = smem_raw + 16 * (size_t)nt + align16((size_t)(WR + WC) * sizeof(int));
    float* win = reinterpret_cast<float*>(p);   // band s (A, H, V, D) at win + s WR WC
    float* tile = reinterpret_cast<float*>(p);  // TR x OC, after the row pass
    const size_t wbytes = (size_t)4 * WR * WC * sizeof(float);
    const size_t tbytes = (size_t)TR * OC * sizeof(float);
    float* tmp = reinterpret_cast<float*>(p + align16(wbytes > tbytes ? wbytes : tbytes));
    const int BS = WR * WC, TS = TR * TP;  // band and temp strides
    float* dst = l == levels - 1 ? out : scr;
    const float* h = static_cast<const float*>(t.det[3 * l]);
    const float* v = static_cast<const float*>(t.det[3 * l + 1]);
    const float* d = static_cast<const float*>(t.det[3 * l + 2]);
    const size_t plane = (size_t)b * mr * mc;
    for (int k = rank; k < ntile; k += nb) {
      const int q0r = (k / tx) * lr, q0c = (k % tx) * lc;
      fill_index(rows, WR, (long long)q0r - g.lo, 1, mr);
      fill_index(cols, WC, (long long)q0c - g.lo, 1, mc);
      __syncthreads();
      auto stage_all = [&] {
        if (l == 0)
          stage_bands<FD, 4, kStageLoads>(Bands{{a_in, h, v, d}, 0u}, 0, plane, mc, rows, cols,
                                          WR, WC, win, BS, WR * WC, kNone, 0.f);
        else
          stage_bands<FD, 4, kStageLoads, 1u>(Bands{{src, h, v, d}, 0u}, 0, plane, mc, rows,
                                              cols, WR, WC, win, BS, WR * WC, kNone, 0.f);
      };
      if (load_taps)
        fill_around(t1, 4 * nt, taps, tap, stage_all);
      else
        stage_all();
      load_taps = false;
      __syncthreads();
      // along the rows: temp k from bands (2k, 2k + 1), rows 2 (r0 + i) + q of window column w
      const int per = (lr / PR) * WC;
      for (int it = threadIdx.x; it < 2 * per; it += blockDim.x) {
        const int kt = it / per, rem = it % per, r0 = (rem / WC) * PR, w = rem % WC;
        float* tk = tmp + kt * TS;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          Acc<FD> acc[1][PR];
          band_strip<FD, PR, 1, kInvCh>(acc, win + 2 * kt * BS + (r0 + off[q]) * WC + w, WR * WC,
                                        BS, 2, WC, t1 + 2 * q * nt, t1, 0, nt);
#pragma unroll
          for (int i = 0; i < PR; ++i) tk[(2 * (r0 + i) + q) * TP + w] = acc[0][i].total();
        }
      }
      __syncthreads();
      // along the columns: temp row r2, outputs 2 (t0 + i) + q
      for (int it = threadIdx.x; it < TR * (lc / PC); it += blockDim.x) {
        const int r2 = it % TR, t0 = (it / TR) * PC;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          Acc<FD> acc[1][PC];
          band_strip<FD, PC, 1, kInvCh>(acc, tmp + r2 * TP + t0 + off[q], TR * TP, TS, 2, 1,
                                        t1 + 2 * q * nt, t1, 0, nt);
#pragma unroll
          for (int i = 0; i < PC; ++i) tile[r2 * OC + 2 * (t0 + i) + q] = acc[0][i].total();
        }
      }
      __syncthreads();
      auto orow = [&](int r2) { return 2LL * q0r + r2; };
      auto ocol = [&](int u) { return 2LL * q0c + u; };
      store_tile(dst, 4 * plane, 2 * mr, 2 * mc, tile, OC, TR, 2 * lc, orow, ocol);
      __syncthreads();
    }
    if (l + 1 < levels) cooperative_groups::this_cluster().sync();
    src = dst;
    scr = dst + (size_t)B * 4 * mr * mc;
    mr *= 2;
    mc *= 2;
  }
}

}  // namespace

namespace pdwt_sep {

// Launch the inverse level in compute scheme `scheme` (the index in
// kernels/matmul.py:SCHEMES; H, V, D bf16 where det_bf16, the output bf16
// where out_bf16) on its launch plan (kernels/matmul.py:
// inv_level_launch_plan): tile lr x lc subband positions, nt padded taps per
// parity, threads, grid (gx, gy, gz) and dynamic shared-memory bytes; a plan
// that does not add up is refused (cudaErrorInvalidValue).  `taps` is a (4,
// hlen) float32 device buffer: the low filter's first and second values,
// then the high filter's, correlation order; `geo` is poly_geometry(hlen).
// Kernel 12's entry point (matmul.cu: pdwt_inv_level_2d_mxu) calls it, in
// the tiers' schemes and, for kernel 2, in fd on float32.
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
        a, h, v, d, out, det_bf16, out_bf16, B, Mr, Mc, hlen, g, taps, lr, lc, nt, PadAxis{},
        PadAxis{});
    return cudaGetLastError();
  });
}

// Launch the padded synthesis level (inv_level_kernel<S, true, ...>) in compute
// scheme `scheme` on (B, Mr, Mc) subbands the caller padded (A float32, H,
// V, D bf16 where det_bf16), into (B, n_out_r, n_out_c), bf16 where
// out_bf16: `pad` holds base, off and n_out of the rows, then of the
// columns (PadAxis); taps, geometry and plan as kernel 12's (kernel 2's in
// fd), the plan made for pad_positions(row) x pad_positions(column)
// positions (kernels/matmul.py: inv_padded_launch_plan).  Kernel 12's
// padded entry point (matmul.cu: pdwt_inv_level_2d_mxu_padded) calls it, in
// the tiers' schemes and, for kernel 2, in fd on float32: a float32 output in
// fd takes kernel 2's padded instance (inv_level_kernel<FD, true>), every
// other call the scheme's TIER instance, which also stores bf16.  Refused
// (cudaErrorInvalidValue) where the plan does not add up or a stored
// output would read outside the subbands (pad_axis_ok).
int launch_inv_padded(const float* a, const void* h, const void* v, const void* d, void* out,
                      int B, int Mr, int Mc, const int* pad, const float* taps, int hlen,
                      const int* geo, int scheme, int det_bf16, int out_bf16, int lr, int lc,
                      int nt, int threads, int gx, int gy, int gz, int smem, void* stream) {
  if (hlen < 2 || hlen > PDWT_MAX_HLEN || B < 1 || Mr < 1 || Mc < 1)
    return cudaErrorInvalidValue;
  const Poly g = make_poly(geo);
  const PadAxis pr = {pad[0], pad[1], pad[2]}, pc = {pad[3], pad[4], pad[5]};
  for (int q = 0; q < 2; ++q)
    if (poly_off(g, q) < 0 || g.p[q] < 0 || g.nb[q] < 1 || g.nb[q] > nt ||
        g.p[q] + 2 * (g.nb[q] - 1) >= hlen)
      return cudaErrorInvalidValue;
  if (!pad_axis_ok(pr, g, Mr) || !pad_axis_ok(pc, g, Mc) || nt % kInvCh || nt > PDWT_MAX_HLEN ||
      lr < 1 || lc < 1 || lc % kColStrip || threads < 32 || threads > 256 || threads % 32)
    return cudaErrorInvalidValue;
  const int offmax = poly_off(g, 0) > poly_off(g, 1) ? poly_off(g, 0) : poly_off(g, 1);
  if (gx != (pad_positions(pc) + lc - 1) / lc || gy != (pad_positions(pr) + lr - 1) / lr ||
      gy > 65535 || gz != (B < 65535 ? B : 65535))
    return cudaErrorInvalidValue;
  return with_scheme(scheme, [&](auto sc) -> cudaError_t {
    constexpr int S = decltype(sc)::value;
    if (lr % kRowStrip<S> || (size_t)smem != inv_smem<S>(offmax, lr, lc, nt))
      return cudaErrorInvalidValue;
    auto launch = [&](auto kernel) -> cudaError_t {
      cudaError_t e = prepare(kernel, smem);
      if (e != cudaSuccess) return e;
      kernel<<<dim3(gx, gy, gz), threads, smem, (cudaStream_t)stream>>>(
          a, h, v, d, out, det_bf16, out_bf16, B, Mr, Mc, hlen, g, taps, lr, lc, nt, pr, pc);
      return cudaGetLastError();
    };
    if constexpr (S == FD)
      if (!out_bf16) return launch(inv_level_kernel<FD, true>);
    return launch(inv_level_kernel<S, true, true>);
  });
}

// Launch the inverse tail (kernel 4) on (B, Mr, Mc) deepest subbands and
// `levels` levels on its plan (kernels/separable.py: tail_launch_plan): nb
// blocks per batch item in clusters of cs, threads, dynamic shared-memory
// bytes (the largest level's), and each level's tile in `tiles` (lr, lc,
// nph = 1 per level, deepest first); `det` holds the 3 * levels detail
// planes, (H, V, D) of the deepest level first; `scratch` the
// approximations the levels before the last synthesise, one after the
// other.  The taps and geometry are kernel 2's.  A plan that does not add
// up, or that the card cannot hold, is refused (cudaErrorInvalidValue).
int launch_inv_tail(const float* a, void* const* det, float* out, float* scratch, int B, int Mr,
                    int Mc, int levels, const float* taps, int hlen, const int* geo, int nb,
                    int cs, int nt, int threads, int smem, const int* tiles, void* stream) {
  if (hlen < 2 || hlen > PDWT_MAX_HLEN || B < 1 || Mr < 1 || Mc < 1 || levels < 1 ||
      levels > PDWT_MAX_TAIL_LEVELS || (long long)Mr << levels > (1 << 30) ||
      (long long)Mc << levels > (1 << 30) || (levels > 1 && !scratch) ||
      !tail_grid_ok(B, levels, nb, cs, threads))
    return cudaErrorInvalidValue;
  const Poly g = make_poly(geo);
  for (int q = 0; q < 2; ++q)
    if (poly_off(g, q) < 0 || g.p[q] < 0 || g.nb[q] < 1 || g.nb[q] > nt ||
        g.p[q] + 2 * (g.nb[q] - 1) >= hlen)
      return cudaErrorInvalidValue;
  if (nt % kInvCh || nt > PDWT_MAX_HLEN) return cudaErrorInvalidValue;
  const int offmax = poly_off(g, 0) > poly_off(g, 1) ? poly_off(g, 0) : poly_off(g, 1);
  TailArgs t = {};
  size_t need = 0;
  for (int l = 0; l < levels; ++l) {
    const TailTile tt = {tiles[3 * l], tiles[3 * l + 1], tiles[3 * l + 2]};
    if (tt.lr < 1 || tt.lc < 1 || tt.lr % kRowStrip<FD> || tt.lc % kColStrip || tt.nph != 1)
      return cudaErrorInvalidValue;
    const size_t sm = inv_smem<FD>(offmax, tt.lr, tt.lc, nt);
    need = sm > need ? sm : need;
    t.tile[l] = tt;
    for (int k = 0; k < 3; ++k) t.det[3 * l + k] = det[3 * l + k];
  }
  if ((size_t)smem != need) return cudaErrorInvalidValue;
  return launch_clusters(inv_tail_kernel, B * nb, threads, need, cs, stream, a, out, scratch, t,
                         B, Mr, Mc, levels, hlen, g, taps, nb, nt);
}

}  // namespace pdwt_sep

namespace pdwt_swtmm {
int launch_fwd_tail(const float* x, float* a, float* scratch, void* const* det, int B, int R,
                    int C, int levels, const float* taps, int hlen, int cen, int nb, int cs,
                    int nt, int threads, int smem, const int* tiles, void* stream);
}

// Every entry point returns a cudaError_t as int: 0 once the launch has been
// queued on `stream`, else the reason it was refused (cudaGetLastError()).

// Kernel 3: `levels` analysis levels of a (B, R, C) float32 image in one
// launch -> a_out (B, R >> levels, C >> levels) and the detail planes
// `det` (3 * levels device pointers, (H, V, D) of level 1 first); `scratch`
// holds the intermediate approximations.  `taps` and `cen` are kernel 1's;
// the plan (kernels/separable.py: tail_launch_plan: nb, cs, nt, threads,
// smem, and lr, lc, nph per level in `tiles`) is checked by the launcher.
extern "C" int pdwt_fwd_tail_2d(const float* x, float* a_out, float* scratch, void* const* det,
                                int B, int R, int C, int levels, const float* taps, int hlen,
                                int cen, int nb, int cs, int nt, int threads, int smem,
                                const int* tiles, void* stream) {
  return pdwt_swtmm::launch_fwd_tail(x, a_out, scratch, det, B, R, C, levels, taps, hlen, cen, nb,
                                     cs, nt, threads, smem, tiles, stream);
}

// Kernel 4: the `levels` deepest synthesis levels of (B, Mr, Mc) float32
// subbands in one launch -> out (B, Mr << levels, Mc << levels); `det`
// holds 3 * levels device pointers, (H, V, D) of the deepest level first;
// `scratch` the intermediate approximations.  `taps` and `geo` are kernel
// 2's; the plan (tail_launch_plan(..., inverse=True)) is checked by the
// launcher.
extern "C" int pdwt_inv_tail_2d(const float* a, void* const* det, float* out, float* scratch,
                                int B, int Mr, int Mc, int levels, const float* taps, int hlen,
                                const int* geo, int nb, int cs, int nt, int threads, int smem,
                                const int* tiles, void* stream) {
  return pdwt_sep::launch_inv_tail(a, det, out, scratch, B, Mr, Mc, levels, taps, hlen, geo, nb,
                                   cs, nt, threads, smem, tiles, stream);
}

extern "C" const char* pdwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
