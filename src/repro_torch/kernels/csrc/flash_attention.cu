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
//   attn_fwd_split_kernel — float32 at head dims off the mma kernel's seven
//     widths, and at those widths on rows off 16 bytes.  O's columns are
//     split over CTAs, 128 each, and each CTA recomputes S = Q K^T over the
//     whole head in FMAs; Q (64 rows, hd padded to 64) sits in shared
//     memory, K comes in chunks of 64 columns and V in the CTA's 128
//     columns, each loaded element by element with zeros past hd and past S
//     (any alignment), so the padded columns add zero to S and to O.  No
//     tensor core computes float32 attention within the port's 1e-4 short of
//     3xTF32: a simple kernel that is right first.
//   attn_fwd_wgmma_cols_kernel — every other 16-bit call (variants 4 and 5):
//     in flash_attention_cols.cu, a library of its own.
//
// flash_attention.cuh holds what this file and flash_attention_cols.cu share.

#include "flash_attention.cuh"

namespace {

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
// attn_fwd_split_kernel: float32 at every head_dim off the mma kernel's seven
// widths, and at those widths on rows off 16 bytes
// ---------------------------------------------------------------------------

namespace split {

constexpr int BQ = 64;              // q rows per CTA
constexpr int BK = 64;              // kv rows per tile
constexpr int DK = 64;              // head columns of a K chunk in S = Q K^T
constexpr int DV = 128;             // columns of O (and of V) a CTA owns
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;

// Shared memory, in floats: Q (64 rows of hd padded to DK, at run time),
// one K chunk (64 x DK), the CTA's V columns (BK x DV) and each warp's P
// rows; rows padded by 16 bytes as in the mma kernel.  Mirrored by
// kernels/flash_attention.py::split_smem_bytes.
struct Plan {
  static constexpr int PAD = 4;
  static constexpr int KSTR = DK + PAD;
  static constexpr int VSTR = DV + PAD;
  static constexpr int PSTR = BK + 4;
  static constexpr int V_FLOATS = BK * VSTR;
  static constexpr int P_FLOATS = NWARPS * 16 * PSTR;
  __host__ __device__ static int qstr(int hd) { return (hd + DK - 1) / DK * DK + PAD; }
  __host__ __device__ static size_t bytes(int hd) {
    return (size_t)(BQ * qstr(hd) + BK * KSTR + V_FLOATS + P_FLOATS) * sizeof(float);
  }
};

// Rows [row0, row0 + rn) x columns [c0, c0 + cn) of one head, element by
// element (any row stride, any alignment), into dst (row-major at stride
// ds); zeros past `rows` and past hd.
__device__ __forceinline__ void load_block(float* dst, int ds, const float* src,
                                           long long row_stride, int row0, int rn, int rows,
                                           int c0, int cn, int hd) {
  for (int i = threadIdx.x; i < rn * cn; i += NTHREADS) {
    const int r = i / cn, c = i % cn;
    const int g = row0 + r, col = c0 + c;
    dst[r * ds + c] = g < rows && col < hd ? src[g * row_stride + col] : 0.f;
  }
}

// One CTA: 64 q rows of one head and DV columns of their O; grid x runs
// over (q tile, column block).  S = Q K^T is taken over the whole head in
// chunks of DK columns (each column block's CTA recomputes it), the online
// softmax as in the mma kernel, then O += P V over the CTA's columns, all
// in FMAs.
__global__ void __launch_bounds__(NTHREADS) attn_fwd_split_kernel(const Params p, int nsplit) {
  using P = Plan;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = p.hd, qstr = P::qstr(hd), hdp = qstr - P::PAD;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + BQ * qstr;
  float* v_s = k_s + BK * P::KSTR;
  float* p_s = v_s + P::V_FLOATS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane >> 2, tig = lane & 3;
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x / nsplit) * BQ;   // longest causal rows first
  const int c0 = ((int)blockIdx.x % nsplit) * DV;             // this CTA's O columns
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int r_lo = warp * 16 + group;
  const int qpos[2] = {q0 + r_lo, q0 + r_lo + 8};

  float o_acc[DV / 8][4];
#pragma unroll
  for (int dt = 0; dt < DV / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o_acc[dt][i] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};

  load_block(q_s, qstr, qg, p.q_ss, q0, BQ, p.Sq, 0, hdp, hd);

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
      load_block(k_s, P::KSTR, kg, p.k_ss, k0, BK, p.Skv, d0, DK, hd);
      if (d0 == 0) load_block(v_s, P::VSTR, vg, p.v_ss, k0, BK, p.Skv, c0, DV, hd);
      __syncthreads();
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

    float alpha[2];
    online_softmax(s, m_i, l_i, alpha, qpos, k0, tig, p);
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o_acc[dt][i] *= alpha[i >> 1];

    // O += P V over this CTA's columns
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

  // finalize: acc / max(l, 1e-20), element by element, only the columns
  // below hd
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qpos[hr] >= p.Sq) continue;
    const float l = fmaxf(l_i[hr], 1e-20f);
    float* orow = og + qpos[hr] * p.o_ss;
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + dt * 8 + tig * 2 + e;
        if (col < hd) orow[col] = o_acc[dt][2 * hr + e] / l;
      }
    }
  }
}

cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t bytes = Plan::bytes(p.hd);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const int nsplit = (p.hd + DV - 1) / DV;
  const dim3 grid((p.Sq + BQ - 1) / BQ * nsplit, p.Hq, batch);
  attn_fwd_split_kernel<<<grid, NTHREADS, bytes, stream>>>(p, nsplit);
  return cudaGetLastError();
}

}  // namespace split

namespace wg {

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

// The wgmma instance of the least width that holds hd.
int wgmma_width(int hd) { return hd <= 64 ? 64 : hd <= 80 ? 80 : hd <= 96 ? 96 : hd <= 128 ? 128 : 192; }

template <typename T>
cudaError_t dispatch16(const Params& p, int var, int batch, cudaStream_t stream) {
  if (var == 1) return p.hd == 16 ? mma::launch<T, 16>(p, batch, stream)
                                  : mma::launch<T, 32>(p, batch, stream);
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
  if (var < 0 || var > 3) return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch16<__nv_bfloat16>(p, var, batch, stream);
  if (dtype == 2) return dispatch16<__half>(p, var, batch, stream);
  if (var == 3) return split::launch(p, batch, stream);
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
  if (var < 0 || var > 3) return -1;
  if (var == 3) return (int)split::Plan::bytes(hd);
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

}  // namespace

// Dynamic shared memory of one CTA, in bytes, for (dtype, head_dim) on rows
// 16-byte aligned or not; -1 where no variant takes it or the variant is
// the column-block kernel (flash_attention_cols.cu's flash_attention_cols_smem
// counts its plan's).
extern "C" int flash_attention_smem_bytes(int dtype, int hd, int aligned) {
  return smem_bytes(dtype, hd, aligned);
}

// Which kernel variant takes (dtype, head_dim, rows 16-byte aligned): 0 mma
// kernel with FMAs, 1 mma kernel with mma.sync, 2 wgmma + TMA, 3 split
// kernel (these four launched by flash_attention_fwd), 4 column-block wgmma
// by TMA, 5 column-block wgmma by cp.async (launched by
// flash_attention_cols.cu's flash_attention_cols_fwd); -1 none.
extern "C" int flash_attention_variant(int dtype, int hd, int aligned) {
  return variant(dtype, hd, aligned);
}

// q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), o (B, Sq, Hq, hd), each with a unit
// last stride; strides[12] holds the (batch, seq, head) strides, in elements,
// of q, k, v and o in that order.  dtype: 0 = float32, 1 = bfloat16, 2 =
// float16; hd in 1..512.  Launches variants 0 to 3.  Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue also when
// cuTensorMapEncodeTiled refuses a TMA map, or the call is the column-block
// kernel's).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int batch, int sq, int skv, int hq, int hkv,
                                   int hd, const long long* strides, int causal, int window,
                                   float sm_scale, void* stream) {
  int align;
  const Params p = make_params(q, k, v, o, dtype == 0 ? 4 : 2, batch, sq, skv, hq, hkv, hd,
                               strides, causal, window, sm_scale, &align);
  return (int)dispatch(p, dtype, variant(dtype, hd, align == 16), batch,
                       static_cast<cudaStream_t>(stream));
}
