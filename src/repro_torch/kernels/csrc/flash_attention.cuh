// The pieces that csrc/flash_attention.cu and csrc/flash_attention_cols.cu
// share: the launch parameters, 16-bit packing, the wgmma helpers (mbarriers,
// TMA loads, descriptors, the SS and RS products), the consumer warpgroups'
// softmax and P fragments, the TMA map encoder, and the variant dispatch's
// rule (variant, row_align, make_params).  Everything is in an unnamed
// namespace: each library compiles its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

#define WGMMA_SS_N32(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                      \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "   \
               "{"                                                         \
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"  \
               "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                        \
               : ACC8(0), ACC8(8)                                          \
               : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                               int scale_d) {
  if constexpr (kHalf<T>)
    WGMMA_SS_N32("f16");
  else
    WGMMA_SS_N32("bf16");
}
#undef WGMMA_SS_N32

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
// k16 step, each further 64-column box (BKT rows) one leading offset away.
template <typename T, int HD, int BKT = BK>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&a_hi)[BKT / 16][4],
                                         const uint32_t (&a_lo)[BKT / 16][4], uint32_t v) {
#pragma unroll
  for (int kt = 0; kt < BKT / 16; ++kt) {
    const uint64_t db = sw128_desc(v + kt * 16 * 128, BKT * 128, 1024);
    wgmma_rs<T, HD>(o, a_hi[kt], db);
    wgmma_rs<T, HD>(o, a_lo[kt], db);
  }
}

// Online softmax of one BKT-key tile (64 or 32) starting at k0, in place: s
// holds the raw scores and leaves holding P (float32); alpha is the factor
// by which the accumulator must be rescaled.  The mask is applied only where
// one cuts the tile; a row's BKT columns lie in the 4 threads of a quad;
// then p = 2^(s * scale - m) as one FFMA and one ex2.
template <int BKT = BK>
__device__ __forceinline__ void softmax(float (&s)[BKT / 2], float (&alpha)[2], Rows& r,
                                        const Params& p, int k0) {
  static_assert(BKT == 64 || BKT == 32, "a tile is 64 or 32 keys");
  if (k0 + BKT > p.Skv || (p.causal && k0 + BKT - 1 > r.first) ||
      (p.window > 0 && r.first + 63 - k0 >= p.window)) {
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) {
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
  for (int j = 4; j < BKT / 8; ++j)
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
  for (int j = 0; j < BKT / 8; ++j) {
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
template <typename T, int BKT = BK>
__device__ __forceinline__ void to_fragments(const float (&s)[BKT / 2],
                                             uint32_t (&a_hi)[BKT / 16][4],
                                             uint32_t (&a_lo)[BKT / 16][4]) {
#pragma unroll
  for (int kt = 0; kt < BKT / 16; ++kt)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      split2<T>(s[8 * kt + 2 * f], s[8 * kt + 2 * f + 1], a_hi[kt][f], a_lo[kt][f]);
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

}  // namespace wg

// The variant that takes (dtype, head_dim, rows 16-byte aligned): 0
// attn_fwd_mma_kernel with FMAs (float32 at its seven widths), 1
// attn_fwd_mma_kernel with mma.sync (16-bit hd 16 / 32), 2
// attn_fwd_wgmma_kernel (16-bit hd a multiple of 8 up to 192, but 16 and
// 32), 3 attn_fwd_split_kernel (float32, the rest), 4
// attn_fwd_wgmma_cols_kernel by TMA (16-bit hd a multiple of 8 above 192),
// 5 attn_fwd_wgmma_cols_kernel by cp.async (16-bit, every other hd or
// layout); -1 none.  Variants 2 and 4 read the rows by TMA, whose stride
// rule is the wrapper's to hold.  dtype: 0 float32, 1 bf16, 2 float16.
// Mirrored by kernels/flash_attention.py::variant_of.
int variant(int dtype, int hd, int aligned) {
  if (hd < 1 || hd > MAX_HEAD_DIM || dtype < 0 || dtype > 2) return -1;
  if (dtype == 0) {
    const bool inst = hd == 16 || hd == 32 || hd == 64 || hd == 80 || hd == 96 || hd == 128 ||
                      hd == 192;
    return inst && aligned ? 0 : 3;
  }
  if (!aligned || hd % 8) return 5;
  if (hd == 16 || hd == 32) return 1;
  return hd <= 192 ? 2 : 4;
}

// The widest power of two up to 16 bytes on which every walked (b, s, h)
// row of one input starts (a dimension of size 1 is never stepped over).
int row_align(const void* ptr, const long long* st, int b, int s, int h, int esize) {
  uint64_t bits = reinterpret_cast<uintptr_t>(ptr) | 16;
  const int n[3] = {b, s, h};
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1) bits |= (uint64_t)(st[i] * esize);
  return (int)(bits & (~bits + 1));   // the lowest set bit
}

// The launch's parameters and the alignment of q's, k's and v's rows.
Params make_params(const void* q, const void* k, const void* v, void* o, int esize, int batch,
                   int sq, int skv, int hq, int hkv, int hd, const long long* strides,
                   int causal, int window, float sm_scale, int* align) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.Sq = sq; p.Skv = skv; p.Hq = hq; p.Hkv = hkv; p.hd = hd;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.causal = causal; p.window = window; p.sm_scale = sm_scale;
  *align = row_align(q, strides, batch, sq, hq, esize);
  const int ka = row_align(k, strides + 3, batch, skv, hkv, esize);
  const int va = row_align(v, strides + 6, batch, skv, hkv, esize);
  if (ka < *align) *align = ka;
  if (va < *align) *align = va;
  return p;
}

}  // namespace
