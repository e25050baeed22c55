// The column-block flash-attention forward for NVIDIA Hopper (sm_90a), with a
// plain C interface: variants 4 and 5 of flash_attention.cu's variant(),
// in bf16 and float16.  It computes the function flash_attention.cu's header
// describes (the Pallas kernel src/repro/kernels/flash_attention.py::
// _attn_kernel with its GQA wrapper), on the calls no instance there takes.
//
//   attn_fwd_wgmma_cols_kernel — every other 16-bit call: head dims that
//     are a multiple of 8 above 192 on 16-byte rows (TMA), and head dims off
//     8 or rows off 16 bytes at any head_dim (cp.async).  It is the wgmma
//     kernel's consumers (two warpgroups of 64 rows taking turns, S = Q K^T
//     as SS wgmma, O += P V as RS wgmma with P_hi + P_lo) over a block of
//     O's columns, fed by a producer warpgroup.  What held the split kernel
//     that took these calls before (6-29x SDPA) back, and what this one
//     does about it:
//     * O above 192 columns does not fit a consumer's registers (at 192 the
//       wgmma kernel already spills 32 bytes in bf16).  O's columns are
//       split over CTAs (grid x runs over q tiles x column blocks): the
//       fewest blocks of at most 192 columns at the least of the widths 128
//       and 192 that holds them (2 x 128 at hd 256, 192 + 128 at 320, 192 +
//       192 + 128 at 512; a last block may be partial, its V columns past
//       hd zero and its O columns past hd not stored).  Each block's CTA
//       recomputes S over the whole head, on the tensor cores; its V tiles
//       and O stores cover the block's columns only.
//     * Q of 128 rows at hd 512 is 128 KB of the card's 227.  The instance
//       is the number of 64-column boxes a Q or K row takes, NB (2, 3, 4,
//       5 or 8; the host's plan takes the least that holds hd, the columns
//       past hd zero): NB 4 runs 64-key K/V tiles in 3 ring stages (209 KB
//       at hd 256), NB 5 and 8 32-key tiles (4 stages at hd 320, 2 at 512:
//       217 KB).  S runs all 4 NB k16 steps: a step count known only at run
//       time made ptxas serialise the wgmmas (C7515, 1.6x the time).  At
//       NB 5, 64-key tiles would fit, but bf16 then spilled with C7512
//       (2.60 ms against 1.86 at hd 320), while float16 ran faster at 64
//       keys (1.68 against 1.90 ms): it gives up those 13% so that one
//       layout per box count serves both dtypes and the host's plan needs
//       no dtype.
//     * Element loads.  By TMA where the rows allow it (the wgmma kernel's
//       maps, V's box at the block's first column).  Where they do not, the
//       producer warpgroup copies with cp.async at the widest width the
//       rows' alignment allows (16, 8 or 4 bytes; eight 2-byte loads and a
//       16-byte store at 2), into the same 128-byte-swizzled layout TMA
//       writes, zero-filled past hd and past S; each thread's copies of a
//       tile complete on the stage's full barriers (128 arrivals) after
//       cp.async.wait_group and fence.proxy.async, which makes them visible
//       to wgmma's async proxy.  The cp.async producer is an instance of its
//       own, with 40 registers (the consumers 232): in one kernel with the
//       TMA producer, and with 24, ptxas spilled 272-572 bytes.  Of the
//       sixteen instances only bf16 at 3 boxes by cp.async still spills
//       (32 bytes, and C7512), as the wgmma kernel's hd-192 instance does.
//     This file is a library of its own, which nvcc builds beside
//     flash_attention.cu.  The host makes the launch plan (boxes, ring
//     stages, the bytes a copy moves: kernels/flash_attention.py::plan);
//     flash_attention_cols_fwd checks it, and the instance of its boxes fixes
//     the O columns a CTA and the keys a tile (ColsLayout).

#include "flash_attention.cuh"

namespace {
namespace wg {

constexpr int MAX_SMEM = 232448;    // dynamic shared memory a CTA may take

// The launch plan of the column-block kernel at one call: the host's stages
// and align, and the column blocks its instance's W makes of hd.
struct Cols {
  int nblk;     // column blocks of O, W columns each (the last may be partial)
  int stages;   // K/V ring depth
  int align;    // the cp.async route's bytes a copy (16, 8, 4 or 2); 0 for TMA
};

// The column-block kernel's instance of NB 64-column boxes a Q or K row
// (hd up to 64 NB; S = Q K^T runs 4 NB k16 steps, the boxes' columns past
// hd zero): O columns a CTA W, K/V tiles of BKT keys, and its shared
// memory: Q (NB boxes of 128 rows), the ring's K tiles (NB boxes of BKT
// rows) and V tiles (W / 64 boxes: the block's columns only), then the
// barriers; 1 KB to align.  Mirrored by kernels/flash_attention.py
// (COLS_BOXES, cols_instance, cols_smem_bytes).
template <int NB>
struct ColsLayout {
  static constexpr int W = NB <= 2 || NB == 4 ? 128 : 192;
  // 32-key tiles from 5 boxes: above 5, two stages of 64-key tiles do not
  // fit beside Q; at 5 they do, but bf16's S, P and 192-column O then
  // spill and ptxas serialises the wgmmas (C7512: 2.60 ms against 1.86 at
  // hd 320, B 4, S 2048, 32 / 8 heads on the H100)
  static constexpr int BKT = NB >= 5 ? 32 : 64;
  static constexpr int NBV = W / 64;
  static constexpr int KVBOX = BKT * 128;
  static constexpr int K_TILE = NB * KVBOX;
  static constexpr int V_TILE = NBV * KVBOX;
  static constexpr int K_OFF = NB * Q_BOX;
  __host__ __device__ static int v_off(int stages) { return K_OFF + stages * K_TILE; }
  __host__ __device__ static int bar_off(int stages) { return v_off(stages) + stages * V_TILE; }
  __host__ __device__ static size_t bytes(int stages) {
    return 1024 + bar_off(stages) + 8 * (1 + 3 * stages);
  }
};

template <int A>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes) {
  if constexpr (A == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(A), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// This thread's generic-proxy writes to shared memory (its cp.async and
// stores) made visible to the async proxy, which wgmma reads through.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) x columns [col0, col0 + 64 nbox) of one head into
// nbox 128-byte-swizzled boxes of ROWS rows at dst, as TMA lays a box out
// (16-byte unit u of row r at r * 128 + (u ^ r % 8) * 16), each thread of
// the producer warpgroup (t) one 16-byte unit at a time: A-byte cp.async
// copies for A = 16, 8 or 4 (source sizes cut short or 0 past hd and past
// `rows`, which cp.async fills with zeros); for A = 2, eight 2-byte loads
// issued together and one 16-byte store.
template <typename T, int A, int ROWS>
__device__ __forceinline__ void copy_rows(uint32_t dst, const T* head, long long rstride,
                                          int row0, int rows, int col0, int nbox, int hd,
                                          int t) {
  const int total = nbox * ROWS * 8;   // 16-byte units
  for (int i = t; i < total; i += 128) {
    const int u = i % 8, r = (i / 8) % ROWS, box = i / (8 * ROWS);
    const int col = col0 + box * 64 + u * 8, g = row0 + r;
    const uint32_t d = dst + box * (ROWS * 128) + r * 128 + ((u ^ (r & 7)) << 4);
    const int n = g < rows ? max(0, min(8, hd - col)) : 0;   // elements to read
    const T* src = head + (long long)min(g, rows - 1) * rstride + col;
    if constexpr (A == 2) {
      const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
      unsigned short x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = e < n ? s16[e] : 0;
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(d), "r"(x[0] | (uint32_t)x[1] << 16), "r"(x[2] | (uint32_t)x[3] << 16),
                      "r"(x[4] | (uint32_t)x[5] << 16), "r"(x[6] | (uint32_t)x[7] << 16)
                   : "memory");
    } else {
#pragma unroll
      for (int e = 0; e < 16 / A; ++e) {
        const int m = max(0, min(A / 2, n - e * (A / 2)));   // elements of this copy
        cp_async<A>(d + e * A, m > 0 ? src + e * (A / 2) : head, 2 * m);
      }
    }
  }
}

template <typename T, int ROWS>
__device__ __forceinline__ void copy_tile(int align, uint32_t dst, const T* head,
                                          long long rstride, int row0, int rows, int col0,
                                          int nbox, int hd, int t) {
  switch (align) {
    case 16: copy_rows<T, 16, ROWS>(dst, head, rstride, row0, rows, col0, nbox, hd, t); break;
    case 8: copy_rows<T, 8, ROWS>(dst, head, rstride, row0, rows, col0, nbox, hd, t); break;
    case 4: copy_rows<T, 4, ROWS>(dst, head, rstride, row0, rows, col0, nbox, hd, t); break;
    default: copy_rows<T, 2, ROWS>(dst, head, rstride, row0, rows, col0, nbox, hd, t); break;
  }
}

// S = Q K^T over NB boxes, four k16 steps each, all issued: a step count
// known only at run time (a loop, or steps skipped past hd) made ptxas
// serialise the wgmmas (C7515), at 1.6x the time; the zero columns of the
// boxes past hd cost their products instead.
template <typename T, int BKT, int NB>
__device__ __forceinline__ void issue_qk_boxes(float (&s)[BKT / 2], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = sw128_desc(q + (kk / 4) * Q_BOX + col, 16, 1024);
    const uint64_t db = sw128_desc(k + (kk / 4) * (BKT * 128) + col, 16, 1024);
    if constexpr (BKT == 64)
      wgmma_ss_n64<T>(s, da, db, kk > 0);
    else
      wgmma_ss_n32<T>(s, da, db, kk > 0);
  }
}

// One CTA: 128 q rows of one head and the W columns of their O from c0 =
// blk * W; grid x runs over (q tile, column block).  The consumers are the
// wgmma kernel's (two warpgroups of 64 rows, turns, P_hi + P_lo), with S
// over the whole head and P V over the block's columns; the producer
// warpgroup fills the ring by TMA (one thread) or, where TMA cannot map the
// rows (CP), by cp.async from all 128 threads (Cols::align bytes a copy).
// The two producers are instances of their own: in one kernel that held
// both, ptxas spilled in every instance.
template <typename T, int NB, bool CP>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_fwd_wgmma_cols_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p, const Cols c,
                           const int q_hin, const int k_hin, const int v_hin) {
  using L = ColsLayout<NB>;
  constexpr int W = L::W, BKT = L::BKT, NBV = L::NBV;
  // S (BKT / 2), P_hi + P_lo (BKT / 2) and O (W / 2) in flight together
  // within ptxas's 168 registers a thread, as the wgmma kernel's Plan::OVERLAP
  constexpr bool OVERLAP = W / 2 + BKT <= 128;
  const int STAGES = c.stages;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar = base + L::bar_off(STAGES);
  const uint32_t v_base = base + L::v_off(STAGES);
  auto k_s = [&](int st) { return base + L::K_OFF + st * L::K_TILE; };
  auto v_s = [&](int st) { return v_base + st * L::V_TILE; };
  const uint32_t q_full = bar;
  auto k_full = [&](int st) { return bar + 8u * (1 + st); };
  auto v_full = [&](int st) { return bar + 8u * (1 + STAGES + st); };
  auto empty = [&](int st) { return bar + 8u * (1 + 2 * STAGES + st); };

  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x / c.nblk) * BQ;   // longest causal rows first
  const int c0 = ((int)blockIdx.x % c.nblk) * W;              // this CTA's O columns
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  const int nk = (p.Skv + BKT - 1) / BKT;
  int j_hi = nk - 1, j_lo = 0;
  if (p.causal) j_hi = min(j_hi, (q0 + BQ - 1) / BKT);
  if (p.window > 0) {
    const int first = q0 - p.window + 2 - BKT;   // least live k0
    j_lo = first <= 0 ? 0 : (first + BKT - 1) / BKT;
  }
  const int ntiles = max(0, j_hi - j_lo + 1);

  if (threadIdx.x == 0) {
    const uint32_t arrivals = CP ? 128 : 1;   // cp.async: every producer thread
    mbar_init(q_full, arrivals);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), arrivals);
      mbar_init(v_full(st), arrivals);
      mbar_init(empty(st), 8);                     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    // (the cp.async producer computes addresses in all 128 threads: 40
    // registers each, the consumers 232, within the SM's 64K)
    if constexpr (CP)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if constexpr (!CP) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(q_full, NB * Q_BOX);
        for (int x = 0; x < NB; ++x)
          tma_load(q_s + x * Q_BOX, &tq, q_full, x * 64, q0, h, b, q_hin);
        for (int n = 0; n < ntiles; ++n) {
          const int st = n % STAGES;
          if (n >= STAGES) mbar_wait(empty(st), ((n / STAGES) & 1) ^ 1);
          const int k0 = (j_lo + n) * BKT;
          mbar_expect_tx(k_full(st), L::K_TILE);
          for (int x = 0; x < NB; ++x)
            tma_load(k_s(st) + x * L::KVBOX, &tk, k_full(st), x * 64, k0, hk, b, k_hin);
          mbar_expect_tx(v_full(st), L::V_TILE);
          for (int x = 0; x < NBV; ++x)
            tma_load(v_s(st) + x * L::KVBOX, &tv, v_full(st), c0 + x * 64, k0, hk, b, v_hin);
        }
      }
    } else {
      // Each thread's copies of a tile are one cp.async group; a full
      // barrier is arrived on once the thread's group has landed (K of tile
      // n while V of tile n is in flight, V of tile n while K of n + 1 is).
      const int t = threadIdx.x;
      const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
      const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
      const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
      copy_tile<T, BQ>(c.align, q_s, qg, p.q_ss, q0, p.Sq, 0, NB, p.hd, t);
      cp_commit();
      cp_wait<0>();
      proxy_fence();
      mbar_arrive(q_full);
      for (int n = 0; n < ntiles; ++n) {
        const int st = n % STAGES;
        if (n >= STAGES) mbar_wait(empty(st), ((n / STAGES) & 1) ^ 1);
        const int k0 = (j_lo + n) * BKT;
        copy_tile<T, BKT>(c.align, k_s(st), kg, p.k_ss, k0, p.Skv, 0, NB, p.hd, t);
        cp_commit();
        if (n > 0) {
          cp_wait<1>();                            // V of tile n - 1
          proxy_fence();
          mbar_arrive(v_full((n - 1) % STAGES));
        }
        copy_tile<T, BKT>(c.align, v_s(st), vg, p.v_ss, k0, p.Skv, c0, NBV, p.hd, t);
        cp_commit();
        cp_wait<1>();                              // K of tile n
        proxy_fence();
        mbar_arrive(k_full(st));
      }
      if (ntiles > 0) {
        cp_wait<0>();
        proxy_fence();
        mbar_arrive(v_full((ntiles - 1) % STAGES));
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  if constexpr (CP)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int group = lane >> 2, tig = lane & 3;
  Rows rows;
  rows.first = q0 + 64 * cw;
  rows.scale = p.sm_scale * 1.4426950408889634f;
  rows.tig = tig;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rows.qpos[hr] = rows.first + warp * 16 + group + 8 * hr;
    rows.klo[hr] = p.window > 0 ? rows.qpos[hr] - p.window + 1 : 0;
    rows.khi[hr] = p.causal ? min(rows.qpos[hr], p.Skv - 1) : p.Skv - 1;
    rows.m[hr] = NEG_INF;
    rows.l[hr] = 0.f;
  }
  const uint32_t q_wg = q_s + 64 * 128 * cw;

  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  float s[BKT / 2], alpha[2];
  uint32_t a_hi[BKT / 16][4], a_lo[BKT / 16][4];

  // the wgmma kernel's schedule (turns, S of tile n with P V of tile n - 1)
  mbar_wait(q_full, 0);
  if (ntiles > 0) {
    if (cw == 1) turn_pass(cw);
    mbar_wait(k_full(0), 0);
    turn_wait(cw);
    wgmma_fence();
    issue_qk_boxes<T, BKT, NB>(s, q_wg, k_s(0));
    wgmma_commit();
    turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(s);
    softmax<BKT>(s, alpha, rows, p, j_lo * BKT);
    to_fragments<T, BKT>(s, a_hi, a_lo);
  }
  for (int n = 1; n < ntiles; ++n) {
    const int st = n % STAGES, prev = (n - 1) % STAGES;
    mbar_wait(k_full(st), (n / STAGES) & 1);
    mbar_wait(v_full(prev), ((n - 1) / STAGES) & 1);
    turn_wait(cw);
    wgmma_fence();
    if constexpr (OVERLAP) {
      issue_qk_boxes<T, BKT, NB>(s, q_wg, k_s(st));
      wgmma_commit();
      issue_pv<T, W, BKT>(o, a_hi, a_lo, v_s(prev));
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<1>();
      fence_regs(s);
      softmax<BKT>(s, alpha, rows, p, (j_lo + n) * BKT);
      wgmma_wait<0>();
      fence_regs(o);
    } else {
      issue_pv<T, W, BKT>(o, a_hi, a_lo, v_s(prev));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      wgmma_fence();
      issue_qk_boxes<T, BKT, NB>(s, q_wg, k_s(st));
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<0>();
      fence_regs(s);
      softmax<BKT>(s, alpha, rows, p, (j_lo + n) * BKT);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(prev));
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    to_fragments<T, BKT>(s, a_hi, a_lo);
  }
  if (ntiles > 0) {
    const int last = (ntiles - 1) % STAGES;
    mbar_wait(v_full(last), ((ntiles - 1) / STAGES) & 1);
    turn_wait(cw);
    wgmma_fence();
    issue_pv<T, W, BKT>(o, a_hi, a_lo, v_s(last));
    wgmma_commit();
    if (cw == 0) turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(o);
  }

  // finalize: acc / max(l, 1e-20), written in T, only the block's columns
  // below hd; an odd hd leaves O's rows on 2 bytes, so it stores one value
  // at a time
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const bool pairs = (p.hd & 1) == 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (rows.qpos[hr] >= p.Sq) continue;
    const float l = fmaxf(rows.l[hr], 1e-20f);
    T* orow = og + rows.qpos[hr] * p.o_ss;
#pragma unroll
    for (int d8 = 0; d8 < W / 8; ++d8) {
      const int col = c0 + d8 * 8 + tig * 2;
      const float x0 = o[4 * d8 + 2 * hr] / l, x1 = o[4 * d8 + 2 * hr + 1] / l;
      if (pairs) {
        if (col < p.hd) store_pair(orow + col, x0, x1);
      } else {
        if (col < p.hd) orow[col] = from_f<T>(x0);
        if (col + 1 < p.hd) orow[col + 1] = from_f<T>(x1);
      }
    }
  }
}

// Shared memory of the column-block kernel's instance of NB boxes at hd, or
// -1 where hd exceeds the boxes, the stages are not 2 to 4, or the layout
// does not fit a CTA.
template <int NB>
int cols_smem_of(int hd, int stages) {
  using L = ColsLayout<NB>;
  if (hd < 1 || hd > 64 * NB || stages < 2 || stages > 4) return -1;
  return L::bytes(stages) <= (size_t)MAX_SMEM ? (int)L::bytes(stages) : -1;
}

template <typename T, int NB, bool CP>
cudaError_t launch_cols(const Params& p, int stages, int align, int batch,
                        cudaStream_t stream) {
  using L = ColsLayout<NB>;
  Cols c;
  c.nblk = (p.hd + L::W - 1) / L::W;
  c.stages = stages;
  c.align = align;
  CUtensorMap tq, tk, tv;
  int q_hin = 0, k_hin = 0, v_hin = 0;
  if (!CP) {
    const CUtensorMapDataType dt =
        kHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!encode(&tq, dt, p.q, p.hd, p.Sq, p.Hq, batch, p.q_ss, p.q_sh, p.q_sb, BQ, &q_hin) ||
        !encode(&tk, dt, p.k, p.hd, p.Skv, p.Hkv, batch, p.k_ss, p.k_sh, p.k_sb, L::BKT,
                &k_hin) ||
        !encode(&tv, dt, p.v, p.hd, p.Skv, p.Hkv, batch, p.v_ss, p.v_sh, p.v_sb, L::BKT,
                &v_hin))
      return cudaErrorInvalidValue;
  } else {   // the cp.async route reads no map
    memset(&tq, 0, sizeof(tq));
    memset(&tk, 0, sizeof(tk));
    memset(&tv, 0, sizeof(tv));
  }
  const size_t bytes = L::bytes(stages);
  const cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_wgmma_cols_kernel<T, NB, CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + BQ - 1) / BQ * c.nblk, p.Hq, batch);
  attn_fwd_wgmma_cols_kernel<T, NB, CP><<<grid, NTHREADS, bytes, stream>>>(
      tq, tk, tv, p, c, q_hin, k_hin, v_hin);
  return cudaGetLastError();
}

}  // namespace wg

// The instances: boxes 4, 5, 8 by TMA (hd 200-256, 264-320, 328-512); 2,
// 3, 4, 5, 8 by cp.async (up to hd 128, 192, 256, 320, 512), each in bf16
// and float16.  Mirrored by kernels/flash_attention.py::COLS_BOXES.
bool cols_instance(int boxes, bool cp) {
  return boxes == 4 || boxes == 5 || boxes == 8 || (cp && (boxes == 2 || boxes == 3));
}

int cols_smem(int hd, int boxes, int stages, bool cp) {
  if (!cols_instance(boxes, cp)) return -1;
  switch (boxes) {
    case 2: return wg::cols_smem_of<2>(hd, stages);
    case 3: return wg::cols_smem_of<3>(hd, stages);
    case 4: return wg::cols_smem_of<4>(hd, stages);
    case 5: return wg::cols_smem_of<5>(hd, stages);
    default: return wg::cols_smem_of<8>(hd, stages);
  }
}

template <typename T, bool CP>
cudaError_t dispatch_boxes(const Params& p, int boxes, int stages, int align, int batch,
                          cudaStream_t stream) {
  switch (boxes) {
    case 4: return wg::launch_cols<T, 4, CP>(p, stages, align, batch, stream);
    case 5: return wg::launch_cols<T, 5, CP>(p, stages, align, batch, stream);
    case 8: return wg::launch_cols<T, 8, CP>(p, stages, align, batch, stream);
  }
  if constexpr (CP) {
    if (boxes == 2) return wg::launch_cols<T, 2, CP>(p, stages, align, batch, stream);
    if (boxes == 3) return wg::launch_cols<T, 3, CP>(p, stages, align, batch, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_cols(const Params& p, int boxes, int stages, int align, int batch,
                          cudaStream_t stream) {
  return align ? dispatch_boxes<T, true>(p, boxes, stages, align, batch, stream)
               : dispatch_boxes<T, false>(p, boxes, stages, align, batch, stream);
}

}  // namespace

// Dynamic shared memory of the column-block kernel's plan (boxes a Q or K
// row, ring stages) at head_dim hd, by TMA (cp 0) or cp.async (cp 1); -1
// where no instance takes it or it does not fit a CTA.
extern "C" int flash_attention_cols_smem(int hd, int boxes, int stages, int cp) {
  return cols_smem(hd, boxes, stages, cp != 0);
}

// Launches the column-block kernel (variants 4 and 5) on flash_attention_fwd's
// arguments (dtype 1 bf16, 2 float16) and the host's plan[3]: boxes a Q or K
// row, ring stages, and the bytes a copy moves (0: TMA; 16, 8, 4 or 2:
// cp.async, on which every row must start).  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue also for a plan the kernel does not take, or
// a call of another variant).
extern "C" int flash_attention_cols_fwd(const void* q, const void* k, const void* v, void* o,
                                        int dtype, int batch, int sq, int skv, int hq, int hkv,
                                        int hd, const long long* strides, int causal,
                                        int window, float sm_scale, const int* plan,
                                        void* stream) {
  int align;
  const Params p = make_params(q, k, v, o, 2, batch, sq, skv, hq, hkv, hd, strides, causal,
                               window, sm_scale, &align);
  const int boxes = plan[0], stages = plan[1], bytes = plan[2];
  const bool cp = bytes != 0;
  if ((dtype != 1 && dtype != 2) || variant(dtype, hd, align == 16) != (cp ? 5 : 4) ||
      cols_smem(hd, boxes, stages, cp) < 0 ||
      (cp && (align % bytes || (bytes != 16 && bytes != 8 && bytes != 4 && bytes != 2))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 2 ? dispatch_cols<__half>(p, boxes, stages, bytes, batch, st)
                          : dispatch_cols<__nv_bfloat16>(p, boxes, stages, bytes, batch, st));
}
