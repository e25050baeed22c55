// Flash-attention forward for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_attn_kernel
// together with its wrapper src/repro/kernels/ops.py::flash_attention: blocked
// online-softmax attention with float32 running max / sum / accumulator, causal
// and sliding-window masks, fully masked tiles skipped with the reference's
// liveness tests, ragged sequence ends masked by kpos < Skv, masked scores set
// to -1e30 (not -inf) and the finalize acc / max(l, 1e-20).  GQA reads kv head
// h / (Hq / Hkv) directly instead of repeating K/V (kv-major grouping, as
// src/repro/models/attention.py:119).  Inputs are read in their (B, S, H, hd)
// layout through strides: no transpose or pad copy.  Like the Pallas kernel it
// takes any head_dim (here 1 to 512) in float32, bf16 or float16; P stays
// float32 (16-bit types carry it as two halves, below).
//
// Bound on the H100 at the serving path's shape (B=4, S=2048, Hq=32, Hkv=4,
// hd=64, causal, bf16): ~69 GFLOP of live products against ~75 MB of q/k/v/o,
// so it is bound by the tensor cores (0.0695 ms at 989 TFLOP/s), not by memory
// (~22 us at 3.35 TB/s).  The Pallas kernel keeps P in float32 for the PV
// product; here P goes through the tensor cores as two 16-bit halves
// (P_hi = T(P), P_lo = T(P - P_hi)) into one float32 accumulator, which
// is 1.5x the products the bound counts: 0.104 ms at the peak rate.
//
// Variants, chosen by dtype, head_dim and whether every row is 16-byte
// aligned, in variant() (never one for another); T is bf16 or float16:
//
//   attn_fwd_wgmma_kernel — 16-bit, instances at head_dim 64, 80, 96, 128
//     and 192 (80 is zamba2's heads, 96 phi-3-vision's, 192
//     nemotron-4-340b's), each in two forms: hd equal to its width, and the
//     head dims below it that are a multiple of 8 (hd 8 to 192 but 16 and
//     32), the map reading hd columns and zero-filling the rest (below),
//     only hd columns stored.  One CTA of
//     three warpgroups takes 128 q rows.  What held the mma.sync design back,
//     and what this one does about it:
//     * mma.sync m16n8k16 with fragments read from shared memory by 32-bit
//       loads reaches a fraction of the tensor cores' rate.  Both products are
//       wgmma.mma_async m64nNk16: S = Q K^T with Q and K read from shared
//       memory (SS, K-major: K's natural layout), O += P V with P from
//       registers as the A operand (RS; P_hi then P_lo) and V read in its
//       natural (kv, hd) layout through the transposed-B mode of 16-bit wgmma.
//     * Tiles were loaded by every thread (16 bytes each, then stored), and
//       V was transposed into shared memory one element at a time with bank
//       conflicts.  Q, K and V come in by TMA (cp.async.bulk.tensor, 4-D maps
//       over (hd, S, H, B) with the inputs' byte strides) into 128-byte
//       swizzled shared memory, complete on mbarriers, and TMA's zero fill
//       past Sq / Skv replaces the masked loads.
//     * Head dims that are not a multiple of 64.  A row is ceil(hd / 64)
//       boxes of 64 columns (two at hd 80, 96 and 128, three at 192), each a
//       128-byte swizzle atom wide; the map's first dimension stays hd, so TMA
//       reads only hd columns and zero-fills the rest of the last box.  This
//       keeps one descriptor layout for every head dim, where a narrower last
//       box would need its own swizzle (32 or 64 bytes), its own maps and a
//       second PV product.  S = Q K^T runs exactly hd / 16 k16 steps (5 at
//       80, 6 at 96, 12 at 192), so the zero columns cost no product; O +=
//       P V is one m64n80 / n96 / n192 wgmma a k16 step, whose B descriptor
//       reads the first 16 or 32 columns of the second atom (n128 over the
//       zero columns does 1.6x / 1.33x the PV products and is slower on the
//       card: scripts/attention_pv_width.py), and only hd columns of O are
//       stored.
//     * Load -> sync -> compute -> sync on every tile let no copy overlap a
//       product.  A ring of K/V stages with full and empty mbarriers is fed
//       by one producer warp (its warpgroup gives registers to the consumers
//       with setmaxnreg): 4 stages at hd 64 (16 KB of Q and 16 KB a stage, 81
//       KB in all) and at 80 / 96 / 128 (32 and 32 KB, 161 KB); 3 at 192 (48
//       and 48 KB, 193 KB: 4 would take 240 KB of the card's 227).
//     * 64 q rows a CTA loaded every K/V tile for little work.  Two consumer
//       warpgroups of 64 rows share each K/V tile.
//     * The softmax left the tensor cores idle.  A warpgroup issues tile n's
//       S = Q K^T together with tile n - 1's P V and runs tile n's softmax
//       while that product is in flight, and the two warpgroups take turns
//       at issuing (named barriers), so one's softmax overlaps the other's
//       products.  The K/V tiles are 64 rows, not 128: at 128, S, P_hi +
//       P_lo and O in flight at once need more registers than ptxas gives
//       the consumers, and it serialises the wgmmas.  For the same reason a
//       warpgroup at hd 192 (O alone is 96 registers a thread) lets its P V
//       complete before it issues S = Q K^T (Plan::OVERLAP); the turns
//       still overlap one warpgroup's softmax with the other's products.
//     Online softmax runs on the accumulator registers, in base 2 with
//     log2(e) folded into the scale (one FFMA and one ex2.approx a score,
//     the ex2 on the special-function unit, which then bounds the softmax).
//     Tiles the masks leave dead are never loaded, and only tiles
//     that a mask cuts are masked element by element.  Longest causal rows
//     first.
//   attn_fwd_mma_kernel — 16-bit head_dim 16 and 32 (mma.sync m16n8k16, P
//     as P_hi + P_lo from registers, V transposed into shared memory), and
//     float32 at head_dim 16, 32, 64, 80, 96, 128 and 192 (plain FMAs, no
//     TF32, P through shared memory), rows 16-byte aligned: 64 q rows a CTA
//     of 4 warps, 64-row K/V tiles loaded synchronously.  Every loop runs
//     over HD / 16 k-steps and HD / 8 n-tiles and every tile row is HD / 8
//     (16-bit) or HD / 4 (float32) 16-byte chunks, so any multiple of 16
//     works.  The padded rows (HD + 8 16-bit, HD + 4 float32 elements) keep a
//     warp's fragment reads on distinct banks.  float32 above head_dim 32
//     (69,632 bytes at 64, 167,936 at 192) takes more shared memory than the
//     48 KB default, which launch() opts into.
//   attn_fwd_split_kernel — every other (dtype, head_dim, layout): 16-bit
//     head dims that are not a multiple of 8 (their rows cannot be 16-byte
//     aligned, which TMA and the 16-byte loads need) or above 192, float32
//     head dims off the seven instances, and the mma kernel's head dims on
//     rows off 16 bytes.  What it does about the two limits:
//     * O above 192 columns does not fit a CTA's registers (at 192 the
//       wgmma kernel already spills).  O's columns are split over CTAs, 128
//       each (grid x runs over q tiles x column blocks), and each CTA
//       recomputes S = Q K^T over the whole head: at head_dim 320, 3 CTAs
//       a q tile, 3x the QK^T products.
//     * Q and K rows of any width and alignment.  Q (64 rows, hd padded to
//       64) sits in shared memory, K comes in chunks of 64 columns and V in
//       the CTA's 128 columns, each loaded element by element with zeros
//       past hd and past S (no 16-byte rule), so the padded columns add
//       zero to S and to O; only columns below hd are stored.  The products
//       are the mma kernel's (mma.sync for 16-bit, FMAs for float32), one
//       instance a dtype with hd at run time.  Q and K are read per 64-key
//       tile once per column block: a simple kernel that is right first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;   // the reference's sentinel, never -inf
constexpr int MAX_HEAD_DIM = 512;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, Hq, Hkv, hd;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal;
  int window;                       // <= 0: no window
  float sm_scale;
};

template <typename T>
constexpr bool kSixteen = !std::is_same<T, float>::value;   // bf16 or float16
template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (kHalf<T>)
    return __float2half_rn(x);
  else if constexpr (kSixteen<T>)
    return __float2bfloat16_rn(x);
  else
    return x;
}

// Two floats as one packed pair of T (.x, the low half, = lo).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// (x0, x1) as two packed pairs of T, hi = T(x) and lo = T(x - hi), so that
// hi + lo carries x to ~16 (bf16) or ~22 (float16) mantissa bits.
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack2<T>(x0, x1);
  float2 hf;
  if constexpr (kHalf<T>)
    hf = __half22float2(*reinterpret_cast<const __half2*>(&hi));
  else
    hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack2<T>(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store_pair(__half* p, float x0, float x1) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x0, x1);
}

// Two adjacent 16-bit values as one 32-bit fragment register.
template <typename T>
__device__ __forceinline__ uint32_t ld_pair(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A(16x16, row) * B(16x8, col), T inputs, f32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if constexpr (kHalf<T>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Scale, mask and online softmax of one 64-key tile starting at k0, for
// the two rows (qpos) of one thread of the mma and split kernels, in the
// mma accumulator layout: s holds the raw scores and leaves holding P; the
// row statistics are reduced over the 4 lanes of a quad, which together hold
// a row's 64 columns; alpha is the factor by which the accumulator must be
// rescaled.
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&m_i)[2],
                                               float (&l_i)[2], float (&alpha)[2],
                                               const int (&qpos)[2], int k0, int tig,
                                               const Params& p) {
  float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hr = i >> 1;
      const int kpos = k0 + nt * 8 + tig * 2 + (i & 1);
      bool ok = kpos < p.Skv;
      if (p.causal) ok = ok && qpos[hr] >= kpos;
      if (p.window > 0) ok = ok && qpos[hr] - kpos < p.window;
      const float x = ok ? s[nt][i] * p.sm_scale : NEG_INF;
      s[nt][i] = x;
      mx[hr] = fmaxf(mx[hr], x);
    }
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    alpha[hr] = expf(m_i[hr] - mx[hr]);
    m_i[hr] = mx[hr];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = expf(s[nt][i] - m_i[i >> 1]);
      s[nt][i] = e;
      rs[i >> 1] += e;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
    l_i[hr] = l_i[hr] * alpha[hr] + rs[hr];
  }
}

// ---------------------------------------------------------------------------
// attn_fwd_mma_kernel: 16-bit head_dim 16 / 32 and float32 at its seven
// instance widths
// ---------------------------------------------------------------------------

namespace mma {

constexpr int BQ = 64;              // q rows per CTA
constexpr int BK = 64;              // kv rows per tile
constexpr int NWARPS = BQ / 16;     // one warp per 16 q rows
constexpr int NTHREADS = NWARPS * 32;

// Shared-memory plan.  Rows are padded by 16 bytes: keeps 16-byte stores
// aligned and spreads the fragment reads of one warp over distinct banks.
template <typename T, int HD>
struct Plan {
  static constexpr bool k16 = kSixteen<T>;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int KSTR = HD + PAD;        // K rows; Q and V rows too for fp32
  static constexpr int VTSTR = BK + PAD;       // 16-bit: V stored transposed, (hd, BK)
  static constexpr int PSTR = BK + 4;          // fp32: per-warp P rows
  static constexpr int K_ELEMS = BK * KSTR;    // 16-bit stages the Q tile here first
  static constexpr int V_ELEMS = k16 ? HD * VTSTR : BK * KSTR;
  static constexpr int Q_ELEMS = k16 ? 0 : BQ * KSTR;
  static constexpr int P_FLOATS = k16 ? 0 : NWARPS * 16 * PSTR;
  static constexpr size_t kBytes =
      (size_t)(K_ELEMS + V_ELEMS + Q_ELEMS) * sizeof(T) + (size_t)P_FLOATS * sizeof(float);
};

// Copy 64 rows [row0, row0 + 64) of one head into shared memory (row-major,
// stride dst_stride), 16 bytes per thread per step; rows at or past `rows`
// are zero-filled so that masked columns meet finite K and V.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, int dst_stride, const T* src,
                                          long long row_stride, int row0, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;
  for (int c = threadIdx.x; c < 64 * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * VEC;
    const int g = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < rows) val = *reinterpret_cast<const uint4*>(src + g * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * dst_stride + col) = val;
  }
}

// 16-bit V tile stored transposed, vt[d][j], so that the PV product's B
// fragments are 32-bit reads along j.
template <typename T, int HD, int VTSTR>
__device__ __forceinline__ void load_tile_transposed(T* vt, const T* src, long long row_stride,
                                                     int row0, int rows) {
  constexpr int CPR = HD / 8;
  for (int c = threadIdx.x; c < 64 * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int g = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < rows) val = *reinterpret_cast<const uint4*>(src + g * row_stride + col);
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) vt[(col + i) * VTSTR + r] = e[i];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) attn_fwd_mma_kernel(const Params p) {
  using P = Plan<T, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + P::K_ELEMS;
  T* q_s = v_s + P::V_ELEMS;                                 // fp32 only
  float* p_s = reinterpret_cast<float*>(q_s + P::Q_ELEMS);   // fp32 only

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // This thread holds rows r_lo and r_lo + 8 of the warp's 16, in the layout
  // of an mma accumulator: element i of n-tile nt is row r_lo + 8 * (i >> 1),
  // column nt * 8 + tig * 2 + (i & 1).
  const int r_lo = warp * 16 + group;
  const int qpos[2] = {q0 + r_lo, q0 + r_lo + 8};

  float o_acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o_acc[dt][i] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};

  uint32_t qa[HD / 16][4];   // 16-bit: Q as mma A fragments, kept in registers
  if constexpr (P::k16) {
    load_tile<T, HD>(k_s, P::KSTR, qg, p.q_ss, q0, p.Sq);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const T* base = k_s + r_lo * P::KSTR + kk * 16 + tig * 2;
      qa[kk][0] = ld_pair(base);
      qa[kk][1] = ld_pair(base + 8 * P::KSTR);
      qa[kk][2] = ld_pair(base + 8);
      qa[kk][3] = ld_pair(base + 8 * P::KSTR + 8);
    }
  } else {
    load_tile<T, HD>(q_s, P::KSTR, qg, p.q_ss, q0, p.Sq);
  }

  const int nk = (p.Skv + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    // the tile is live unless causality or the window masks all of it
    // (the tests of flash_attention.py:52-56)
    if (p.causal && !(k0 <= q0 + BQ - 1)) continue;
    if (p.window > 0 && !(k0 + BK > q0 - p.window + 1)) continue;

    __syncthreads();   // every warp is done with the previous tile (and Q staging)
    load_tile<T, HD>(k_s, P::KSTR, kg, p.k_ss, k0, p.Skv);
    if constexpr (P::k16) {
      load_tile_transposed<T, HD, P::VTSTR>(v_s, vg, p.v_ss, k0, p.Skv);
    } else {
      load_tile<T, HD>(v_s, P::KSTR, vg, p.v_ss, k0, p.Skv);
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 columns
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    if constexpr (P::k16) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const T* kb = k_s + (nt * 8 + group) * P::KSTR + kk * 16 + tig * 2;
          mma16<T>(s[nt], qa[kk], ld_pair(kb), ld_pair(kb + 8));
        }
      }
    } else {
      for (int d = 0; d < HD; ++d) {
        const float qlo = q_s[r_lo * P::KSTR + d];
        const float qhi = q_s[(r_lo + 8) * P::KSTR + d];
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float kv = k_s[(nt * 8 + tig * 2 + e) * P::KSTR + d];
            s[nt][e] = fmaf(qlo, kv, s[nt][e]);
            s[nt][2 + e] = fmaf(qhi, kv, s[nt][2 + e]);
          }
        }
      }
    }

    float alpha[2];
    online_softmax(s, m_i, l_i, alpha, qpos, k0, tig, p);
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o_acc[dt][i] *= alpha[i >> 1];

    // O += P V
    if constexpr (P::k16) {
      // the accumulator layout of two adjacent n-tiles is the A-fragment
      // layout of one 16-wide k step: P never leaves registers.  P goes in
      // as P_hi + P_lo (two products into one accumulator), keeping its f32
      // precision as the Pallas kernel does
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        uint32_t a_hi[4], a_lo[4];
        split2<T>(s[2 * t][0], s[2 * t][1], a_hi[0], a_lo[0]);
        split2<T>(s[2 * t][2], s[2 * t][3], a_hi[1], a_lo[1]);
        split2<T>(s[2 * t + 1][0], s[2 * t + 1][1], a_hi[2], a_lo[2]);
        split2<T>(s[2 * t + 1][2], s[2 * t + 1][3], a_hi[3], a_lo[3]);
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          const T* vb = v_s + (dt * 8 + group) * P::VTSTR + t * 16 + tig * 2;
          const uint32_t b0 = ld_pair(vb), b1 = ld_pair(vb + 8);
          mma16<T>(o_acc[dt], a_hi, b0, b1);
          mma16<T>(o_acc[dt], a_lo, b0, b1);
        }
      }
    } else {
      float* pw = p_s + warp * 16 * P::PSTR;   // this warp's 16 x 64 P rows
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pw[(group + 8 * (i >> 1)) * P::PSTR + nt * 8 + tig * 2 + (i & 1)] = s[nt][i];
      __syncwarp();
      for (int jj = 0; jj < BK; ++jj) {
        const float plo = pw[group * P::PSTR + jj];
        const float phi = pw[(group + 8) * P::PSTR + jj];
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float vv = v_s[jj * P::KSTR + dt * 8 + tig * 2 + e];
            o_acc[dt][e] = fmaf(plo, vv, o_acc[dt][e]);
            o_acc[dt][2 + e] = fmaf(phi, vv, o_acc[dt][2 + e]);
          }
        }
      }
    }
  }

  // finalize: acc / max(l, 1e-20), written in the input dtype
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qpos[hr] >= p.Sq) continue;
    const float l = fmaxf(l_i[hr], 1e-20f);
    T* orow = og + qpos[hr] * p.o_ss;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      store_pair(orow + dt * 8 + tig * 2, o_acc[dt][2 * hr] / l, o_acc[dt][2 * hr + 1] / l);
  }
}


template <typename T, int HD>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t bytes = Plan<T, HD>::kBytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_mma_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, batch);
  attn_fwd_mma_kernel<T, HD><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace mma

// ---------------------------------------------------------------------------
// attn_fwd_split_kernel: every other head_dim, any layout with a unit last
// stride, every dtype
// ---------------------------------------------------------------------------

namespace split {

constexpr int BQ = 64;              // q rows per CTA
constexpr int BK = 64;              // kv rows per tile
constexpr int DK = 64;              // head columns of a K chunk in S = Q K^T
constexpr int DV = 128;             // columns of O (and of V) a CTA owns
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;

// Shared memory: Q (64 rows of hd padded to DK, at run time), one K chunk
// (64 x DK), the CTA's V columns (transposed for 16-bit, (DV, BK)) and, in
// float32, each warp's P rows.  Rows padded by 16 bytes as in the mma
// kernel.  Mirrored by kernels/flash_attention.py::split_smem_bytes.
template <typename T>
struct Plan {
  static constexpr bool k16 = kSixteen<T>;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int KSTR = DK + PAD;
  static constexpr int VSTR = k16 ? BK + PAD : DV + PAD;
  static constexpr int V_ELEMS = k16 ? DV * VSTR : BK * VSTR;
  static constexpr int PSTR = BK + 4;
  static constexpr int P_FLOATS = k16 ? 0 : NWARPS * 16 * PSTR;
  __host__ __device__ static int qstr(int hd) { return (hd + DK - 1) / DK * DK + PAD; }
  __host__ __device__ static size_t bytes(int hd) {
    return (size_t)(BQ * qstr(hd) + BK * KSTR + V_ELEMS) * sizeof(T) +
           (size_t)P_FLOATS * sizeof(float);
  }
};

// Rows [row0, row0 + rn) x columns [c0, c0 + cn) of one head, element by
// element (any row stride, any alignment), into dst (row-major at stride
// ds, or transposed: dst[col * ds + row]); zeros past `rows` and past hd.
template <typename T, bool TRANSPOSE>
__device__ __forceinline__ void load_block(T* dst, int ds, const T* src, long long row_stride,
                                           int row0, int rn, int rows, int c0, int cn, int hd) {
  for (int i = threadIdx.x; i < rn * cn; i += NTHREADS) {
    const int r = i / cn, c = i % cn;
    const int g = row0 + r, col = c0 + c;
    const T val = g < rows && col < hd ? src[g * row_stride + col] : from_f<T>(0.f);
    if (TRANSPOSE)
      dst[c * ds + r] = val;
    else
      dst[r * ds + c] = val;
  }
}

// One CTA: 64 q rows of one head and DV columns of their O; grid x runs
// over (q tile, column block).  S = Q K^T is taken over the whole head in
// chunks of DK columns (each column block's CTA recomputes it), the online
// softmax as in the mma kernel, then O += P V over the CTA's columns.
template <typename T>
__global__ void __launch_bounds__(NTHREADS) attn_fwd_split_kernel(const Params p, int nsplit) {
  using P = Plan<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = p.hd, qstr = P::qstr(hd), hdp = qstr - P::PAD;
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + BQ * qstr;
  T* v_s = k_s + BK * P::KSTR;
  float* p_s = reinterpret_cast<float*>(v_s + P::V_ELEMS);   // fp32 only

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane >> 2, tig = lane & 3;
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x / nsplit) * BQ;   // longest causal rows first
  const int c0 = ((int)blockIdx.x % nsplit) * DV;             // this CTA's O columns
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int r_lo = warp * 16 + group;
  const int qpos[2] = {q0 + r_lo, q0 + r_lo + 8};

  float o_acc[DV / 8][4];
#pragma unroll
  for (int dt = 0; dt < DV / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o_acc[dt][i] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};

  load_block<T, false>(q_s, qstr, qg, p.q_ss, q0, BQ, p.Sq, 0, hdp, hd);

  const int nk = (p.Skv + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    if (p.causal && !(k0 <= q0 + BQ - 1)) continue;
    if (p.window > 0 && !(k0 + BK > q0 - p.window + 1)) continue;

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += DK) {
      __syncthreads();   // the previous chunk's and tile's readers are done
      load_block<T, false>(k_s, P::KSTR, kg, p.k_ss, k0, BK, p.Skv, d0, DK, hd);
      if (d0 == 0)
        load_block<T, P::k16>(v_s, P::VSTR, vg, p.v_ss, k0, BK, p.Skv, c0, DV, hd);
      __syncthreads();
      if constexpr (P::k16) {
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          const T* qb = q_s + r_lo * qstr + d0 + kk * 16 + tig * 2;
          const uint32_t a[4] = {ld_pair(qb), ld_pair(qb + 8 * qstr), ld_pair(qb + 8),
                                 ld_pair(qb + 8 * qstr + 8)};
#pragma unroll
          for (int nt = 0; nt < BK / 8; ++nt) {
            const T* kb = k_s + (nt * 8 + group) * P::KSTR + kk * 16 + tig * 2;
            mma16<T>(s[nt], a, ld_pair(kb), ld_pair(kb + 8));
          }
        }
      } else {
        for (int d = 0; d < DK; ++d) {
          const float qlo = q_s[r_lo * qstr + d0 + d];
          const float qhi = q_s[(r_lo + 8) * qstr + d0 + d];
#pragma unroll
          for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float kv = k_s[(nt * 8 + tig * 2 + e) * P::KSTR + d];
              s[nt][e] = fmaf(qlo, kv, s[nt][e]);
              s[nt][2 + e] = fmaf(qhi, kv, s[nt][2 + e]);
            }
          }
        }
      }
    }

    float alpha[2];
    online_softmax(s, m_i, l_i, alpha, qpos, k0, tig, p);
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o_acc[dt][i] *= alpha[i >> 1];

    // O += P V over this CTA's columns
    if constexpr (P::k16) {
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        uint32_t a_hi[4], a_lo[4];
        split2<T>(s[2 * t][0], s[2 * t][1], a_hi[0], a_lo[0]);
        split2<T>(s[2 * t][2], s[2 * t][3], a_hi[1], a_lo[1]);
        split2<T>(s[2 * t + 1][0], s[2 * t + 1][1], a_hi[2], a_lo[2]);
        split2<T>(s[2 * t + 1][2], s[2 * t + 1][3], a_hi[3], a_lo[3]);
#pragma unroll
        for (int dt = 0; dt < DV / 8; ++dt) {
          const T* vb = v_s + (dt * 8 + group) * P::VSTR + t * 16 + tig * 2;
          const uint32_t b0 = ld_pair(vb), b1 = ld_pair(vb + 8);
          mma16<T>(o_acc[dt], a_hi, b0, b1);
          mma16<T>(o_acc[dt], a_lo, b0, b1);
        }
      }
    } else {
      float* pw = p_s + warp * 16 * P::PSTR;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pw[(group + 8 * (i >> 1)) * P::PSTR + nt * 8 + tig * 2 + (i & 1)] = s[nt][i];
      __syncwarp();
      for (int jj = 0; jj < BK; ++jj) {
        const float plo = pw[group * P::PSTR + jj];
        const float phi = pw[(group + 8) * P::PSTR + jj];
#pragma unroll
        for (int dt = 0; dt < DV / 8; ++dt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float vv = v_s[jj * P::VSTR + dt * 8 + tig * 2 + e];
            o_acc[dt][e] = fmaf(plo, vv, o_acc[dt][e]);
            o_acc[dt][2 + e] = fmaf(phi, vv, o_acc[dt][2 + e]);
          }
        }
      }
    }
  }

  // finalize: acc / max(l, 1e-20) in the input dtype, element by element,
  // only the columns below hd
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qpos[hr] >= p.Sq) continue;
    const float l = fmaxf(l_i[hr], 1e-20f);
    T* orow = og + qpos[hr] * p.o_ss;
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + dt * 8 + tig * 2 + e;
        if (col < hd) orow[col] = from_f<T>(o_acc[dt][2 * hr + e] / l);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t bytes = Plan<T>::bytes(p.hd);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const int nsplit = (p.hd + DV - 1) / DV;
  const dim3 grid((p.Sq + BQ - 1) / BQ * nsplit, p.Hq, batch);
  attn_fwd_split_kernel<T><<<grid, NTHREADS, bytes, stream>>>(p, nsplit);
  return cudaGetLastError();
}

}  // namespace split

namespace wg {

constexpr int BQ = 128;             // q rows per CTA: two consumer warpgroups
constexpr int BK = 64;              // kv rows per tile
constexpr int NTHREADS = 384;       // warpgroup 0 produces, 1 and 2 consume
constexpr int Q_BOX = BQ * 128;     // one TMA box of Q: 128 rows x 64 16-bit values
constexpr int KV_BOX = BK * 128;    // one TMA box of K or V: 64 rows x 64 16-bit values
constexpr uint32_t WAIT_LIMIT = 1u << 24;    // mbarrier tries before a trap
// A running max below this is the masking sentinel times the scale: the row
// has met no live score yet.
constexpr float DEAD_MAX = -1e28f;

template <int HD>
struct Plan {
  // 64-column boxes a row; at hd 80 and 96 TMA zero-fills the last past hd
  static constexpr int NBOX = (HD + 63) / 64;
  // K/V ring depth: at hd 192 four stages would take 240 KB of the 227
  static constexpr int STAGES = NBOX > 2 ? 3 : 4;
  // Whether tile n's S and tile n - 1's P are in flight together.  ptxas
  // allocates a consumer the 168 registers of a 384-thread block (not the
  // 240 that setmaxnreg gives it at run time): at hd 192, O (96 float32 a
  // thread), S (32) and P_hi + P_lo (32) together spilled 200 bytes, so
  // there P V completes before S = Q K^T is issued (32 bytes still spill,
  // and ptxas still serialises the wgmmas: the build's -Xptxas -v report).
  static constexpr bool OVERLAP = HD <= 128;
  static constexpr int Q_TILE = NBOX * Q_BOX;
  static constexpr int KV_TILE = NBOX * KV_BOX;     // a K or a V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_TILE;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]; 1 KB to align
  static constexpr size_t kBytes = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Wait for the phase of `bar` with this parity to complete.  A barrier that
// never completes (a lost arrival) traps after WAIT_LIMIT tries instead of
// hanging the card: the launch then fails with an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0; !mbar_try(bar, parity);)
    if (++tries == WAIT_LIMIT) __trap();
}

// Named barriers 1 and 2 give the two consumer warpgroups turns at issuing
// their products (ping-pong): a warpgroup syncs on its own and, once it has
// issued, arrives on the other's, so one's softmax runs while the other's
// products do.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - cw) : "memory");
}

// One TMA box of a 4-D map (hd, inner, outer, B) into shared memory,
// completing on `bar`.  `heads_inner` says which of S and H is the map's
// second dimension (the one with the smaller stride).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head, int b, int heads_inner) {
  const int c1 = heads_inner ? head : row, c2 = heads_inner ? row : head;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(c1), "r"(c2), "r"(b),
         "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 128B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// 2^x on the special-function unit (flushes subnormal results to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving reads of accumulator registers above the
// wait that completes the asynchronous products writing them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D(64 x N, f32) (+)= A * B: m64nNk16 in T's type (bf16 or f16).  _ss: A
// and B from shared memory, both K-major.  _rs: A from registers (the
// m16n8k16 A-fragment layout, per warp), B from shared memory, MN-major
// (transposed B).  Each asm is written once for the type name TY.
#define ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

#define WGMMA_SS_N64(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                      \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "   \
               "{"                                                         \
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"  \
               "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                        \
               : ACC8(0), ACC8(8), ACC8(16), ACC8(24)                       \
               : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
  if constexpr (kHalf<T>)
    WGMMA_SS_N64("f16");
  else
    WGMMA_SS_N64("bf16");
}
#undef WGMMA_SS_N64

#define WGMMA_RS_N64(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
               "{"                                                         \
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"  \
               "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
               : ACC8(0), ACC8(8), ACC8(16), ACC8(24) \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define WGMMA_RS_N80(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " " \
               "{"                                                         \
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39"  \
               "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n" \
               : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32) \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define WGMMA_RS_N96(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " " \
               "{"                                                         \
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"  \
               "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n" \
               : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40) \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define WGMMA_RS_N128(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
               "{"                                                         \
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"  \
               "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
               : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), \
                 ACC8(48), ACC8(56) \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define WGMMA_RS_N192(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " " \
               "{"                                                         \
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "  \
               "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
               "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"  \
               "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n" \
               : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), \
                 ACC8(48), ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88) \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// The RS product at the N of O += P V: head_dim 64, 80, 96, 128 or 192.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 80 || N == 96 || N == 128 || N == 192, "no RS instance");
  if constexpr (N == 64) {
    if constexpr (kHalf<T>) WGMMA_RS_N64("f16"); else WGMMA_RS_N64("bf16");
  } else if constexpr (N == 80) {
    if constexpr (kHalf<T>) WGMMA_RS_N80("f16"); else WGMMA_RS_N80("bf16");
  } else if constexpr (N == 96) {
    if constexpr (kHalf<T>) WGMMA_RS_N96("f16"); else WGMMA_RS_N96("bf16");
  } else if constexpr (N == 128) {
    if constexpr (kHalf<T>) WGMMA_RS_N128("f16"); else WGMMA_RS_N128("bf16");
  } else if constexpr (N == 192) {
    if constexpr (kHalf<T>) WGMMA_RS_N192("f16"); else WGMMA_RS_N192("bf16");
  }
}
#undef WGMMA_RS_N64
#undef WGMMA_RS_N80
#undef WGMMA_RS_N96
#undef WGMMA_RS_N128
#undef WGMMA_RS_N192
#undef ACC8

// The softmax state of one consumer thread's two rows (qpos[0] and
// qpos[0] + 8 of its warpgroup): the keys each may see, [klo, khi], its
// running max m (base 2, scaled) and sum l.
struct Rows {
  int first;                 // the warpgroup's first q row
  int tig;                   // the thread's column pair within an n8 block
  float scale;               // sm_scale * log2(e)
  int qpos[2], klo[2], khi[2];
  float m[2], l[2];
};

// S = Q K^T for one warpgroup's 64 rows against a BK-key tile: exactly
// hd / 16 k16 steps (4, 5, 6, 8 or 12), four to a 64-column box, so the
// zero-filled columns of a last box (hd 80, 96) cost no product.
template <typename T, int HD>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q, uint32_t k) {
  static_assert(BK == 64, "S is one m64n64 accumulator");
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_n64<T>(s, sw128_desc(q + (kk / 4) * Q_BOX + col, 16, 1024),
                 sw128_desc(k + (kk / 4) * KV_BOX + col, 16, 1024), kk > 0);
  }
}

// O += P V with P as P_hi then P_lo: V (kv, hd) is MN-major B, 16 kv rows a
// k16 step, each further 64-column box one leading offset away.
template <typename T, int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&a_hi)[BK / 16][4],
                                         const uint32_t (&a_lo)[BK / 16][4], uint32_t v) {
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt) {
    const uint64_t db = sw128_desc(v + kt * 16 * 128, KV_BOX, 1024);
    wgmma_rs<T, HD>(o, a_hi[kt], db);
    wgmma_rs<T, HD>(o, a_lo[kt], db);
  }
}

// Online softmax of one BK-key tile starting at k0, in place: s holds the
// raw scores and leaves holding P (float32); alpha is the factor by which
// the accumulator must be rescaled.  The mask is applied only where one cuts
// the tile; a row's BK columns lie in the 4 threads of a quad; then
// p = 2^(s * scale - m) as one FFMA and one ex2.
__device__ __forceinline__ void softmax(float (&s)[BK / 2], float (&alpha)[2], Rows& r,
                                        const Params& p, int k0) {
  if (k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > r.first) ||
      (p.window > 0 && r.first + 63 - k0 >= p.window)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + 8 * j + 2 * r.tig + (i & 1);
        const bool ok = kpos >= r.klo[i >> 1] && kpos <= r.khi[i >> 1];
        s[4 * j + i] = ok ? s[4 * j + i] : NEG_INF;
      }
    }
  }
  float mx[2][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[hr][c] = fmaxf(s[4 * c + 2 * hr], s[4 * c + 2 * hr + 1]);
#pragma unroll
  for (int j = 4; j < BK / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      mx[hr][j & 3] = fmaxf(mx[hr][j & 3], fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
  float sc[2], neg_m[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float m = fmaxf(fmaxf(mx[hr][0], mx[hr][1]), fmaxf(mx[hr][2], mx[hr][3]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(r.m[hr], m * r.scale);
    alpha[hr] = ex2(r.m[hr] - m_new);
    r.m[hr] = m_new;
    // a row with no live score so far holds only the sentinel: p = 1 for
    // each, as exp(-1e30 - (-1e30)) is in the reference, exactly
    const bool dead = m_new < DEAD_MAX;
    sc[hr] = dead ? 0.f : r.scale;
    neg_m[hr] = dead ? 0.f : -m_new;
  }
  float rs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = ex2(fmaf(s[4 * j + i], sc[i >> 1], neg_m[i >> 1]));
      s[4 * j + i] = e;
      rs[i >> 1][((j & 1) << 1) | (i & 1)] += e;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = (rs[hr][0] + rs[hr][1]) + (rs[hr][2] + rs[hr][3]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    r.l[hr] = r.l[hr] * alpha[hr] + sum;
  }
}

// P as the PV product's A fragments: accumulator n-blocks 2t and 2t + 1 are
// the A fragment of k16 step t.  P_hi + P_lo keep its float32 precision.
template <typename T>
__device__ __forceinline__ void to_fragments(const float (&s)[BK / 2], uint32_t (&a_hi)[BK / 16][4],
                                             uint32_t (&a_lo)[BK / 16][4]) {
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      split2<T>(s[8 * kt + 2 * f], s[8 * kt + 2 * f + 1], a_hi[kt][f], a_lo[kt][f]);
}

// Thread roles: warpgroup 0 is the producer (one thread issues every TMA
// load), warpgroups 1 and 2 each own 64 of the CTA's 128 q rows.  Thread t
// of a consumer warpgroup holds, as a wgmma accumulator does, rows
// 16 * (t / 32) + (t % 32) / 4 and that + 8; element 4 * j + i of a row block
// is column 8 * j + 2 * (t % 4) + (i & 1) of row half i >> 1.
template <typename T, int HD, bool FULL>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Params p,
                      const int q_hin, const int k_hin, const int v_hin) {
  using P = Plan<HD>;
  constexpr int NBOX = P::NBOX, STAGES = P::STAGES;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;      // swizzle atoms are 1 KB
  const uint32_t q_s = base + P::Q_OFF;
  const uint32_t bar = base + P::BAR_OFF;
  auto k_s = [&](int st) { return base + P::K_OFF + st * P::KV_TILE; };
  auto v_s = [&](int st) { return base + P::V_OFF + st * P::KV_TILE; };
  const uint32_t q_full = bar;
  auto k_full = [&](int st) { return bar + 8u * (1 + st); };
  auto v_full = [&](int st) { return bar + 8u * (1 + STAGES + st); };
  auto empty = [&](int st) { return bar + 8u * (1 + 2 * STAGES + st); };

  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  // the live K/V tiles [j_lo, j_hi] of these 128 rows (the liveness tests
  // of flash_attention.py:52-56)
  const int nk = (p.Skv + BK - 1) / BK;
  int j_hi = nk - 1, j_lo = 0;
  if (p.causal) j_hi = min(j_hi, (q0 + BQ - 1) / BK);
  if (p.window > 0) {
    const int first = q0 - p.window + 2 - BK;    // least live k0
    j_lo = first <= 0 ? 0 : (first + BK - 1) / BK;
  }
  const int ntiles = max(0, j_hi - j_lo + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 8);               // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, P::Q_TILE);
      for (int c = 0; c < NBOX; ++c)
        tma_load(q_s + c * Q_BOX, &tq, q_full, c * 64, q0, h, b, q_hin);
      for (int n = 0; n < ntiles; ++n) {
        const int st = n % STAGES;
        if (n >= STAGES) mbar_wait(empty(st), ((n / STAGES) & 1) ^ 1);
        const int k0 = (j_lo + n) * BK;
        mbar_expect_tx(k_full(st), P::KV_TILE);
        for (int c = 0; c < NBOX; ++c)
          tma_load(k_s(st) + c * KV_BOX, &tk, k_full(st), c * 64, k0, hk, b, k_hin);
        mbar_expect_tx(v_full(st), P::KV_TILE);
        for (int c = 0; c < NBOX; ++c)
          tma_load(v_s(st) + c * KV_BOX, &tv, v_full(st), c * 64, k0, hk, b, v_hin);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;          // consumer warpgroup: 0 or 1
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int group = lane >> 2, tig = lane & 3;
  Rows rows;
  rows.first = q0 + 64 * cw;                     // this warpgroup's first row
  rows.scale = p.sm_scale * 1.4426950408889634f;  // base-2 softmax
  rows.tig = tig;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rows.qpos[hr] = rows.first + warp * 16 + group + 8 * hr;
    rows.klo[hr] = p.window > 0 ? rows.qpos[hr] - p.window + 1 : 0;
    rows.khi[hr] = p.causal ? min(rows.qpos[hr], p.Skv - 1) : p.Skv - 1;
    rows.m[hr] = NEG_INF;
    rows.l[hr] = 0.f;
  }
  const uint32_t q_wg = q_s + 64 * 128 * cw;      // this warpgroup's Q rows

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float s[BK / 2], alpha[2];
  uint32_t a_hi[BK / 16][4], a_lo[BK / 16][4];

  // Tile n's S = Q K^T and tile n - 1's O += P V are issued together, in
  // this warpgroup's turn (warpgroup 0 first); the softmax of tile n runs
  // while the PV product is still on the tensor cores (at hd 192, P V
  // completes first: Plan::OVERLAP).  Each warpgroup takes ntiles + 1
  // turns, and each turn's pass is awaited, so no arrival is left at exit.
  mbar_wait(q_full, 0);
  if (ntiles > 0) {
    if (cw == 1) turn_pass(cw);
    mbar_wait(k_full(0), 0);
    turn_wait(cw);
    wgmma_fence();
    issue_qk<T, HD>(s, q_wg, k_s(0));
    wgmma_commit();
    turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(s, alpha, rows, p, j_lo * BK);
    to_fragments<T>(s, a_hi, a_lo);
  }
  for (int n = 1; n < ntiles; ++n) {
    const int st = n % STAGES, prev = (n - 1) % STAGES;
    mbar_wait(k_full(st), (n / STAGES) & 1);
    mbar_wait(v_full(prev), ((n - 1) / STAGES) & 1);
    turn_wait(cw);
    wgmma_fence();
    if constexpr (P::OVERLAP) {
      issue_qk<T, HD>(s, q_wg, k_s(st));
      wgmma_commit();
      issue_pv<T, HD>(o, a_hi, a_lo, v_s(prev));
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<1>();                           // S of tile n is in
      fence_regs(s);
      softmax(s, alpha, rows, p, (j_lo + n) * BK);
      wgmma_wait<0>();                           // PV of tile n - 1 is done
      fence_regs(o);
    } else {
      issue_pv<T, HD>(o, a_hi, a_lo, v_s(prev));
      wgmma_commit();
      wgmma_wait<0>();                           // PV of tile n - 1 is done
      fence_regs(o);
      wgmma_fence();
      issue_qk<T, HD>(s, q_wg, k_s(st));
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<0>();                           // S of tile n is in
      fence_regs(s);
      softmax(s, alpha, rows, p, (j_lo + n) * BK);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(prev));     // this warp is done with it
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    to_fragments<T>(s, a_hi, a_lo);
  }
  if (ntiles > 0) {
    const int last = (ntiles - 1) % STAGES;
    mbar_wait(v_full(last), ((ntiles - 1) / STAGES) & 1);
    turn_wait(cw);
    wgmma_fence();
    issue_pv<T, HD>(o, a_hi, a_lo, v_s(last));
    wgmma_commit();
    if (cw == 0) turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(o);
  }

  // finalize: acc / max(l, 1e-20), written in T; columns past hd are not
  // stored (FULL: hd is the instance's width, and the store needs no test,
  // which would cost the exact widths 2-4% of their time)
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (rows.qpos[hr] >= p.Sq) continue;
    const float l = fmaxf(rows.l[hr], 1e-20f);
    T* orow = og + rows.qpos[hr] * p.o_ss;
#pragma unroll
    for (int d8 = 0; d8 < HD / 8; ++d8) {
      const float x0 = o[4 * d8 + 2 * hr] / l, x1 = o[4 * d8 + 2 * hr + 1] / l;
      if (FULL || d8 * 8 < p.hd) store_pair(orow + d8 * 8 + tig * 2, x0, x1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library links against
// the CUDA runtime alone.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The 4-D map of one (B, S, H, hd) input of 16-bit type `dtype`: dimensions
// (hd, inner, outer, B) where inner is whichever of S and H has the smaller
// stride, a box of 64 columns x box_rows rows, 128-byte swizzle, zeros past
// the ends (the columns of a last box past hd too: hd 80 or 96, or any hd
// below the instance's padded width).  A dimension of size 1 gets a nominal
// stride.  Returns false if cuTensorMapEncodeTiled refuses the map.
bool encode(CUtensorMap* map, CUtensorMapDataType dtype, const void* ptr, int hd, int s, int h,
            int batch, long long ss, long long sh, long long sb, int box_rows,
            int* heads_inner) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  if (s == 1) ss = hd;
  if (h == 1) sh = hd;
  if (batch == 1) sb = hd;
  const bool hin = sh <= ss;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)(hin ? h : s),
                              (cuuint64_t)(hin ? s : h), (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(2 * (hin ? sh : ss)),
                                 (cuuint64_t)(2 * (hin ? ss : sh)), (cuuint64_t)(2 * sb)};
  const cuuint32_t rows = (cuuint32_t)box_rows;
  const cuuint32_t box[4] = {64, hin ? 1u : rows, hin ? rows : 1u, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  *heads_inner = hin ? 1 : 0;
  return fn(map, dtype, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The instance of width HD runs hd == HD (FULL) or any smaller hd that is
// a multiple of 8 (the map reads hd columns; the wrapper's TMA rule holds
// the rows).
template <typename T, int HD, bool FULL>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int q_hin, k_hin, v_hin;
  const CUtensorMapDataType dt =
      kHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode(&tq, dt, p.q, p.hd, p.Sq, p.Hq, batch, p.q_ss, p.q_sh, p.q_sb, BQ, &q_hin) ||
      !encode(&tk, dt, p.k, p.hd, p.Skv, p.Hkv, batch, p.k_ss, p.k_sh, p.k_sb, BK, &k_hin) ||
      !encode(&tv, dt, p.v, p.hd, p.Skv, p.Hkv, batch, p.v_ss, p.v_sh, p.v_sb, BK, &v_hin))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = Plan<HD>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_wgmma_kernel<T, HD, FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, batch);
  attn_fwd_wgmma_kernel<T, HD, FULL><<<grid, NTHREADS, bytes, stream>>>(tq, tk, tv, p, q_hin,
                                                                          k_hin, v_hin);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

// The variant that takes (dtype, head_dim, rows 16-byte aligned): 0
// attn_fwd_mma_kernel with FMAs (float32 at its seven widths), 1
// attn_fwd_mma_kernel with mma.sync (16-bit hd 16 / 32), 2
// attn_fwd_wgmma_kernel (16-bit hd a multiple of 8 up to 192, but 16 and
// 32; the TMA rule on the rows is the wrapper's to hold), 3
// attn_fwd_split_kernel (the rest); -1 none.  dtype: 0 float32, 1 bf16, 2
// float16.  Mirrored by kernels/flash_attention.py::variant_of.
int variant(int dtype, int hd, int aligned) {
  if (hd < 1 || hd > MAX_HEAD_DIM || dtype < 0 || dtype > 2) return -1;
  if (dtype == 0) {
    const bool inst = hd == 16 || hd == 32 || hd == 64 || hd == 80 || hd == 96 || hd == 128 ||
                      hd == 192;
    return inst && aligned ? 0 : 3;
  }
  if (hd == 16 || hd == 32) return aligned ? 1 : 3;
  return hd % 8 == 0 && hd <= 192 ? 2 : 3;
}

// The wgmma instance of the least width that holds hd.
int wgmma_width(int hd) { return hd <= 64 ? 64 : hd <= 80 ? 80 : hd <= 96 ? 96 : hd <= 128 ? 128 : 192; }

template <typename T>
cudaError_t dispatch16(const Params& p, int var, int batch, cudaStream_t stream) {
  if (var == 1) return p.hd == 16 ? mma::launch<T, 16>(p, batch, stream)
                                  : mma::launch<T, 32>(p, batch, stream);
  if (var == 3) return split::launch<T>(p, batch, stream);
  const int width = wgmma_width(p.hd);
  if (p.hd == width) {
    switch (width) {
      case 64: return wg::launch<T, 64, true>(p, batch, stream);
      case 80: return wg::launch<T, 80, true>(p, batch, stream);
      case 96: return wg::launch<T, 96, true>(p, batch, stream);
      case 128: return wg::launch<T, 128, true>(p, batch, stream);
      default: return wg::launch<T, 192, true>(p, batch, stream);
    }
  }
  switch (width) {
    case 64: return wg::launch<T, 64, false>(p, batch, stream);
    case 80: return wg::launch<T, 80, false>(p, batch, stream);
    case 96: return wg::launch<T, 96, false>(p, batch, stream);
    case 128: return wg::launch<T, 128, false>(p, batch, stream);
    default: return wg::launch<T, 192, false>(p, batch, stream);
  }
}

cudaError_t dispatch(const Params& p, int dtype, int var, int batch, cudaStream_t stream) {
  if (var < 0) return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch16<__nv_bfloat16>(p, var, batch, stream);
  if (dtype == 2) return dispatch16<__half>(p, var, batch, stream);
  if (var == 3) return split::launch<float>(p, batch, stream);
  switch (p.hd) {
    case 16: return mma::launch<float, 16>(p, batch, stream);
    case 32: return mma::launch<float, 32>(p, batch, stream);
    case 64: return mma::launch<float, 64>(p, batch, stream);
    case 80: return mma::launch<float, 80>(p, batch, stream);
    case 96: return mma::launch<float, 96>(p, batch, stream);
    case 128: return mma::launch<float, 128>(p, batch, stream);
    default: return mma::launch<float, 192>(p, batch, stream);
  }
}

int smem_bytes(int dtype, int hd, int aligned) {
  const int var = variant(dtype, hd, aligned);
  if (var < 0) return -1;
  if (var == 3)
    return (int)(dtype == 0 ? split::Plan<float>::bytes(hd)
                            : split::Plan<__nv_bfloat16>::bytes(hd));   // both 16-bit alike
  if (var == 2) {
    switch (wgmma_width(hd)) {
      case 64: return (int)wg::Plan<64>::kBytes;
      case 80: return (int)wg::Plan<80>::kBytes;
      case 96: return (int)wg::Plan<96>::kBytes;
      case 128: return (int)wg::Plan<128>::kBytes;
      default: return (int)wg::Plan<192>::kBytes;
    }
  }
  if (var == 1)
    return (int)(hd == 16 ? mma::Plan<__nv_bfloat16, 16>::kBytes
                          : mma::Plan<__nv_bfloat16, 32>::kBytes);
  switch (hd) {
    case 16: return (int)mma::Plan<float, 16>::kBytes;
    case 32: return (int)mma::Plan<float, 32>::kBytes;
    case 64: return (int)mma::Plan<float, 64>::kBytes;
    case 80: return (int)mma::Plan<float, 80>::kBytes;
    case 96: return (int)mma::Plan<float, 96>::kBytes;
    case 128: return (int)mma::Plan<float, 128>::kBytes;
    default: return (int)mma::Plan<float, 192>::kBytes;
  }
}

// Whether every walked (b, s, h) row of one input starts on 16 bytes (a
// dimension of size 1 is never stepped over).
bool rows16(const void* ptr, const long long* st, int b, int s, int h, int esize) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const int n[3] = {b, s, h};
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && (st[i] * esize) % 16) return false;
  return true;
}

}  // namespace

// Dynamic shared memory of one CTA, in bytes (-1: no variant takes it), for
// (dtype, head_dim) on rows 16-byte aligned or not.
extern "C" int flash_attention_smem_bytes(int dtype, int hd, int aligned) {
  return smem_bytes(dtype, hd, aligned);
}

// Which kernel variant flash_attention_fwd launches for (dtype, head_dim,
// rows 16-byte aligned): 0 mma kernel with FMAs, 1 mma kernel with mma.sync,
// 2 wgmma + TMA, 3 split kernel; -1 none.
extern "C" int flash_attention_variant(int dtype, int hd, int aligned) {
  return variant(dtype, hd, aligned);
}

// q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), o (B, Sq, Hq, hd), each with a unit
// last stride; strides[12] holds the (batch, seq, head) strides, in elements,
// of q, k, v and o in that order.  dtype: 0 = float32, 1 = bfloat16, 2 =
// float16; hd in 1..512.  Returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue also when cuTensorMapEncodeTiled refuses a
// TMA map).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int batch, int sq, int skv, int hq, int hkv,
                                   int hd, const long long* strides, int causal, int window,
                                   float sm_scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.Sq = sq; p.Skv = skv; p.Hq = hq; p.Hkv = hkv; p.hd = hd;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.causal = causal; p.window = window; p.sm_scale = sm_scale;
  const int esize = dtype == 0 ? 4 : 2;
  const bool aligned = rows16(q, strides, batch, sq, hq, esize) &&
                       rows16(k, strides + 3, batch, skv, hkv, esize) &&
                       rows16(v, strides + 6, batch, skv, hkv, esize);
  return (int)dispatch(p, dtype, variant(dtype, hd, aligned), batch,
                       static_cast<cudaStream_t>(stream));
}
