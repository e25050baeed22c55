// RWKV6 / Mamba2 chunked linear recurrence for NVIDIA Hopper (sm_90a), with
// the decay precompute and the RWKV6 bonus diagonal fused in; plain C
// interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6.py::_rwkv_kernel
// (launched by rwkv6_chunked_fwd) together with the elementwise work that
// src/repro/kernels/ops.py::rwkv6_mix (:97-123) does around it in XLA.  On
// the model's q, k (B, H, T, K), v (B, H, T, V) and log decay (B, H, T, K),
// in the model's dtype (float32, bf16 or float16) and read through their
// strides, it computes per (b, h) and chunk of C steps, in float32:
//     ld     = clamp(log_decay, LOG_DECAY_MIN, 0),  L = in-chunk cumsum(ld),
//     Lc     = L[C-1],  L_read = L - ld (exclusive) or L (inclusive),
//     center = (max_t L_read + min_t L) / 2,
//     o      = (q·e^L_read) · S + mask((q·e^(L_read-center)) · (k·e^(center-L))ᵀ) · v
//              [+ (Σ_k q·u·k) · v, the bonus diagonal, when exclusive]
//     S     ← diag(e^Lc) · S + (k·e^(Lc-L))ᵀ · v
// and rounds o to the output dtype once, as the reference's
// out.astype(q.dtype) does.  The mask is the strict lower triangle when a
// bonus u (H, K) is given (RWKV6) and the inclusive one otherwise (Mamba2).
// S (K, V) starts from `s0` (zeros when null) and is written out at the end:
// the port's one-pass prefill hands it to decode.  The output is written as
// (B, T, H, V), so that the model's (B, T, H·V) view of it is free.
//
// The four exponentials are computed as the reference writes them: e^(a-b)
// is never factored into e^a · e^-b.  At chunk 64 the cumsum reaches -256
// and e^-256 is below float32's range; the centring exists to avoid that.
// At a chunk where the reference's own exponentials overflow float32
// (RunConfig's 128 on rwkv6-3b's random decays), so do these.
//
// Bound on the H100: q, k, log decay and v read once and o written once in
// their dtype, S written (and s0 read) in float32: 2·(3·T·K + 2·T·V) + 4·K·V
// bytes per b·h in bf16; and the live float32 work: per chunk 2·pairs·(K+V)
// (scores and their product with v) and 4·C·K·V (cross-chunk read, state
// update), the products this kernel runs as 3xTF32 on the tensor cores, so
// at a third of the TF32 rate (495 / 3 TFLOP/s); per chunk K·V (decay of S)
// and 3·K + 2·V a row for the bonus, at the float32 rate of 67 TFLOP/s.  At
// the serving path's shape (B·H 160, T 2048, K = V = 64, C 16, bf16) that
// is 212 MB (0.0634 ms at 3.35 TB/s) against 0.0392 ms of operations: bytes
// bound it (chip_smoke.py::rwkv6_bound).  Priced all at 67 TFLOP/s, as when
// the products ran on the FMA pipes, the 6.19 GFLOP would take 0.0923 ms.
//
// Design (stages A, B and C of the redesign):
//  * A: the state's V columns are independent, so one CTA owns (b·h, a block
//    of VB columns): grid (B·H, ceil(V/VB)); the last block may hold fewer
//    than VB columns, the rest zero-filled in shared memory and never
//    stored.  Each CTA recomputes the chunk's decay precompute and its
//    scores; VB trades that redundancy against CTAs in flight.  The launch
//    plan (kernels/rwkv6.py::plan) picks VB: 32 unless the caller names one
//    (PERF.md has the times of VB 16, 32 and 64).  S for the column block
//    lives in shared memory, double-buffered so that the state update and
//    the scores share one phase.  A chunk is three phases between barriers:
//    (1) the scaled tiles, each thread owning a K column and a block of rows
//    (the column's cumsum run sequentially, as the plain version runs it);
//    (2) the scores and the next state; (3) the output rows.
//  * B: the next chunk's raw q, k, log decay and v tiles are copied by
//    cp.async into a 2-deep ring while the current chunk computes.  Inputs
//    whose rows are not 16-byte aligned (K or V rows of a width that is not
//    a multiple of 16 bytes among them), or shapes whose ring would not fit
//    in shared memory (K 128 at chunk 64 in float32), read them from device
//    memory instead, in the same loop.
//  * C: the three products (scores, k_outᵀ·v, [q_in | scores]·[S ; v]) run
//    on the tensor cores as mma.sync m16n8k8 TF32 with a 3xTF32 split, at
//    float32 accuracy (plain TF32 would not hold 1e-4).  wgmma's 64-row
//    tiles do not fit chunk 16.
//  * Any K and V from 1 to 256: the tiles, S and v are laid out at K padded
//    to a multiple of 8 (an mma k step) and at VB columns, and the padding
//    is zero: where there is any, the whole of shared memory is cleared
//    once, and no phase writes past K or the block's columns, so the
//    padded k steps add zeros.
//  * A chunk above 64 rows, or one whose tiles do not fit (K 256), runs in
//    sub-blocks of CS rows (the plan's "cs").  Each chunk keeps the
//    reference's per-chunk quantities: a first pass over the chunk's log
//    decay (from device memory) gives each column's centre, Lc and e^Lc,
//    and the sub-blocks then continue one sequential cumsum, so every L,
//    and so every exponential, is the one the chunk's own scan gives.  The
//    state S is read at the chunk's start by every sub-block.  A sub-block's
//    rows score against the earlier sub-blocks of its chunk through the same
//    centred exponentials, applied as q_intra · P with P = Σ k_intraᵀ · v
//    over those sub-blocks (the products of the reference's scores · v,
//    summed in another order); the next state sums each sub-block's
//    k_outᵀ · v.  P is double-buffered as S is.
// Each phase is a function whose shared-memory operands are __restrict__, so
// that loads are not held behind stores the compiler cannot disambiguate.
// The serving path's shape (bf16, K 64, chunk 16, a bonus, the ring) runs an
// instance with those values, VB (16, 32 or 64) and the threads fixed at
// compile time, its k loops unrolled, so that the VBs compare like with like;
// every other shape (and VB 8) runs the instance that takes them at run
// time.  What still separates the kernel from its bound is latency: per
// chunk a CTA runs short dependent chains between barriers with few warps
// per SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float LOG_DECAY_MIN = -4.0f;
constexpr int MAX_DIM = 256;      // K and V
constexpr int MAX_SUB = 64;       // rows of a sub-block
constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a CTA can have
constexpr int RING = 2;
constexpr int RWKV6_NO_SMEM = -2;

struct Strides {
  long long q[3], k[3], v[3], ld[3];  // (b, h, t) strides in elements
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int pad8(int x) { return (x + 7) & ~7; }

// Byte offsets of the shared-memory regions of one CTA.
struct Layout {
  int ring, tiles, vf, sc, s, vec, total;
};

// Row strides of the float32 tiles (at K padded to 8), padded so that the
// mma.sync fragment loads of a warp hit 32 distinct banks.
__host__ __device__ inline int tile_stride(int Kp) { return Kp + 4; }   // q_in, q_intra, k_intra
__host__ __device__ inline int kout_stride(int Kp) { return Kp + 8; }   // k_out (read transposed)
__host__ __device__ inline int col_stride(int VB) { return VB + 8; }    // v, S, P
__host__ __device__ inline int sc_stride(int C) { return ((C + 7) & ~7) + 4; }

// `multi`: a chunk runs in more than one sub-block of CS rows, which adds
// P and its next buffer and the per-chunk vectors.  Mirrored by
// kernels/rwkv6.py::layout_bytes.
__host__ __device__ inline Layout layout(int K, int VB, int CS, int esize, int stages,
                                         bool multi) {
  const int Kp = pad8(K);
  Layout L;
  int off = 0;
  L.ring = off;   // stages x [q | k | ld (CS, K) | v (CS, VB)] in the input dtype
  off += align16(stages * CS * (3 * K + VB) * esize);
  L.tiles = off;  // q_in | q_intra | k_intra (CS, tile_stride) | k_out (CS, kout_stride)
  off += align16((3 * tile_stride(Kp) + kout_stride(Kp)) * CS * 4);
  L.vf = off;     // v, float32 (CS, col_stride)
  off += align16(CS * col_stride(VB) * 4);
  L.sc = off;     // masked scores (CS, sc_stride)
  off += align16(CS * sc_stride(CS) * 4);
  L.s = off;      // S and the next S [, P and the next P], (Kp, col_stride) each
  off += align16((multi ? 4 : 2) * Kp * col_stride(VB) * 4);
  L.vec = off;    // exp(Lc) (K) | bonus diagonal (CS) [| centre | Lc | L carried x 2 (K each)]
  off += align16((K + CS + (multi ? 4 * K : 0)) * 4);
  L.total = off;
  return L;
}

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_f(__half x) { return __half2float(x); }

__device__ inline void store1(float* dst, float x) { *dst = x; }
__device__ inline void store1(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }
__device__ inline void store1(__half* dst, float x) { *dst = __float2half_rn(x); }
__device__ inline void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
__device__ inline void store2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}
__device__ inline void store2(__half* dst, float x, float y) {
  *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(x, y);
}

__device__ inline float warp_sum(float x) {
  for (int o = 1; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ inline void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Copy rows t0 .. t0 + rows - 1 of q, k, ld (K wide) and v (the block's
// vcols columns) into one ring stage laid out for CS rows, 16 bytes per
// cp.async (the plan takes the ring only where K and V rows are whole
// 16-byte units).
template <typename T>
__device__ inline void issue_rows(T* stage, const T* qb, const T* kb, const T* lb, const T* vb,
                                  const Strides& sd, int t0, int rows, int CS, int K, int VB,
                                  int vcols, int nt) {
  constexpr int E = 16 / sizeof(T);  // elements per copy
  const int pk = K / E, pv = vcols / E;
  const int nk = rows * pk;
  for (int i = threadIdx.x; i < 3 * nk + rows * pv; i += nt) {
    if (i < 3 * nk) {
      const int a = i / nk, r = i % nk, t = r / pk, p = r % pk;
      const T* base = a == 0 ? qb : a == 1 ? kb : lb;
      const long long st = a == 0 ? sd.q[2] : a == 1 ? sd.k[2] : sd.ld[2];
      cp_async16(stage + a * CS * K + t * K + p * E, base + (t0 + t) * st + p * E);
    } else {
      const int r = i - 3 * nk, t = r / pv, p = r % pv;
      cp_async16(stage + 3 * CS * K + t * VB + p * E, vb + (t0 + t) * sd.v[2] + p * E);
    }
  }
}

__device__ inline float clamp_ld(float x) { return fminf(fmaxf(x, LOG_DECAY_MIN), 0.f); }

// 0. (a chunk of several sub-blocks) each column's centre, Lc and e^Lc over
//    the whole chunk, from the log decay in device memory: one thread a
//    column, its cumsum run sequentially.
template <typename T>
__device__ __forceinline__ void chunk_phase(const T* __restrict__ sl, long long stl,
                                            float* __restrict__ cen, float* __restrict__ lc,
                                            float* __restrict__ dec, int C, int K, bool excl,
                                            int nt) {
  for (int col = threadIdx.x; col < K; col += nt) {
    float acc = 0.f, mx = -__int_as_float(0x7f800000), mn = __int_as_float(0x7f800000);
#pragma unroll 8
    for (int t = 0; t < C; ++t) {
      const float l = clamp_ld(to_f(sl[t * stl + col]));
      acc += l;
      mx = fmaxf(mx, excl ? acc - l : acc);
      mn = fminf(mn, acc);
    }
    cen[col] = 0.5f * (mx + mn);
    lc[col] = acc;
    dec[col] = expf(acc);
  }
}

// 1. the four scaled tiles, each exponential as the reference writes it,
//    and exp(Lc); v to float32.  Column col and a block of rows belong to
//    one thread (several columns a thread where K exceeds the threads).  In
//    a chunk of one sub-block the thread runs the column's cumsum once over
//    the chunk for the centre and Lc, then again up to its block, so every
//    L is the same sequential sum; in a chunk of several, the centre and Lc
//    come from chunk_phase, L continues from the sum carried out of the
//    previous sub-block (lrun, double-buffered), and the thread of part 0
//    carries this sub-block's sum on.
template <typename T>
__device__ __forceinline__ void tiles_phase(const T* __restrict__ sq, long long stq,
                                            const T* __restrict__ sk, long long stk,
                                            const T* __restrict__ sl, long long stl,
                                            const T* __restrict__ sv, long long stv,
                                            float* __restrict__ qin, float* __restrict__ qa,
                                            float* __restrict__ ka, float* __restrict__ ko,
                                            float* __restrict__ vf, float* __restrict__ dec,
                                            const float* __restrict__ cen,
                                            const float* __restrict__ lcv,
                                            float* __restrict__ lrun, int sub, bool multi,
                                            bool whole, int C, int K, int Kp, int VB, int vcols,
                                            bool excl, int nt) {
  const int tid = threadIdx.x;
  const int kp = tile_stride(Kp), kop = kout_stride(Kp), vp = col_stride(VB);
  const int parts = nt >= K ? nt / K : 1;
  const int rpt = (C + parts - 1) / parts;
  // one (column, block of rows) unit: its cumsum, centre and four tiles
  auto unit = [&](const int col, const int part) {
    const int r_lo = part * rpt, r_hi = min(C, r_lo + rpt);
    float c, e, L = 0.f;
    if (multi) {
      c = cen[col];
      e = lcv[col];
      L = sub ? lrun[(sub & 1) * K + col] : 0.f;
      if (part == 0) {
        float acc = L;
        for (int t = 0; t < C; ++t) acc += clamp_ld(to_f(sl[t * stl + col]));
        lrun[((sub + 1) & 1) * K + col] = acc;
      }
    } else {
      float acc = 0.f, mx = -__int_as_float(0x7f800000), mn = __int_as_float(0x7f800000);
#pragma unroll 8
      for (int t = 0; t < C; ++t) {
        const float l = clamp_ld(to_f(sl[t * stl + col]));
        acc += l;
        mx = fmaxf(mx, excl ? acc - l : acc);
        mn = fminf(mn, acc);
      }
      c = 0.5f * (mx + mn);
      e = acc;
      if (part == 0) dec[col] = expf(e);
    }
    for (int t = 0; t < r_lo && t < C; ++t) L += clamp_ld(to_f(sl[t * stl + col]));
#pragma unroll 4
    for (int t = r_lo; t < r_hi; ++t) {
      const float l = clamp_ld(to_f(sl[t * stl + col]));
      L += l;
      const float lr = excl ? L - l : L;
      const float qv = to_f(sq[t * stq + col]), kv = to_f(sk[t * stk + col]);
      qin[t * kp + col] = qv * expf(lr);
      qa[t * kp + col] = qv * expf(lr - c);
      ka[t * kp + col] = kv * expf(c - L);
      ko[t * kop + col] = kv * expf(e - L);
    }
  };
  // `whole`: one unit a thread, K dividing the threads (the serving path);
  // else a loop over the units
  if (whole) {
    unit(tid % K, tid / K);
  } else {
    for (int u = tid; u < K * parts; u += nt) unit(u % K, u / K);
  }
  const int vs = __ffs(VB) - 1;  // VB is a power of two
#pragma unroll 4
  for (int i = tid; i < C * VB; i += nt) {
    const int t = i >> vs, cc = i & (VB - 1);
    vf[t * vp + cc] = cc < vcols ? to_f(sv[t * stv + cc]) : 0.f;
  }
}

// 2b. the bonus diagonal Σ_k q·u·k, one warp per row.
template <typename T>
__device__ __forceinline__ void diag_phase(const T* __restrict__ sq, long long stq,
                                           const T* __restrict__ sk, long long stk,
                                           const float* __restrict__ u, float* __restrict__ diag,
                                           int C, int K, int nw) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < C; t += nw) {
    float s = 0.f;
    for (int kk = lane; kk < K; kk += 32)
      s = fmaf(to_f(sq[t * stq + kk]) * u[kk], to_f(sk[t * stk + kk]), s);
    s = warp_sum(s);
    if (lane == 0) diag[t] = s;
  }
}

// Products on the tensor cores at float32 accuracy: mma.sync m16n8k8 in
// TF32 with each operand split into a TF32 high part and a TF32 remainder
// (3xTF32: lo·hi + hi·lo + hi·hi, the lo·lo term below float32's rounding).
// Fragments of a warp (lane = 4·g + t): A (16 x 8, row-major) a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) b0 (t, g),
// b1 (t + 4, g); D (16 x 8) d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t),
// d3 (g + 8, 2t + 1).
__device__ inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ inline void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A fragment split once, reused against several B fragments.
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ inline void set(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
  }
};

// An accumulator as two chains: the hi·hi products and the small terms.
struct Acc {
  float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
  __device__ inline void mma3(const AFrag& a, float b0, float b1) {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b0, bh0, bl0);
    split_tf32(b1, bh1, bl1);
    mma_tf32(small, a.lo[0], a.lo[1], a.lo[2], a.lo[3], bh0, bh1);
    mma_tf32(small, a.hi[0], a.hi[1], a.hi[2], a.hi[3], bl0, bl1);
    mma_tf32(big, a.hi[0], a.hi[1], a.hi[2], a.hi[3], bh0, bh1);
  }
  __device__ inline float get(int e) const { return big[e] + small[e]; }
};

// 2. the scores q_intra · k_intraᵀ (C x C), masked entries 0; one 16 x 8
//    tile per warp, taken from the last warp down; even and odd k steps in
//    separate accumulators.  Kp: K padded to 8, zero past K.
__device__ __forceinline__ void scores_phase(const float* __restrict__ qa,
                                             const float* __restrict__ ka,
                                             float* __restrict__ sc, int C, int Kp, bool excl,
                                             int nw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kp = tile_stride(Kp), scp = sc_stride(C);
  const int nn = (C + 7) / 8, items = ((C + 15) / 16) * nn;
  for (int it = nw - 1 - (threadIdx.x >> 5); it < items; it += nw) {
    const int m0 = (it / nn) * 16, n0 = (it % nn) * 8;
    const int r0 = m0 + g, r1 = m0 + g + 8, j = n0 + g;
    const bool v0 = r0 < C, v1 = r1 < C, vj = j < C;
    Acc d0, d1;
    if (n0 <= m0 + 15) {  // a tile above the diagonal is all masked
#pragma unroll
      for (int k0 = 0; k0 < Kp; k0 += 16) {
        AFrag a;
        a.set({v0 ? qa[r0 * kp + k0 + t] : 0.f, v1 ? qa[r1 * kp + k0 + t] : 0.f,
               v0 ? qa[r0 * kp + k0 + t + 4] : 0.f, v1 ? qa[r1 * kp + k0 + t + 4] : 0.f});
        d0.mma3(a, vj ? ka[j * kp + k0 + t] : 0.f, vj ? ka[j * kp + k0 + t + 4] : 0.f);
        if (k0 + 8 < Kp) {
          const int k1 = k0 + 8;
          AFrag a1;
          a1.set({v0 ? qa[r0 * kp + k1 + t] : 0.f, v1 ? qa[r1 * kp + k1 + t] : 0.f,
                  v0 ? qa[r0 * kp + k1 + t + 4] : 0.f, v1 ? qa[r1 * kp + k1 + t + 4] : 0.f});
          d1.mma3(a1, vj ? ka[j * kp + k1 + t] : 0.f, vj ? ka[j * kp + k1 + t + 4] : 0.f);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1, cc = n0 + 2 * t + (e & 1);
      if (r < C && cc < C)
        sc[r * scp + cc] = (excl ? cc < r : cc <= r) ? d0.get(e) + d1.get(e) : 0.f;
    }
  }
}

// 2b. dst = aᵀ · v (K x VB) plus, by MODE: DECAY dec·base (the next state
//     exp(Lc)·S + k_outᵀ · v), ADD dst itself (a later sub-block's share of
//     it), BASE base (P with this sub-block) or NONE; a (C, K) at row
//     stride `as`.  One 16 x 32 tile (four 16 x 8 accumulators sharing each
//     A fragment) per warp.
enum AccumMode { DECAY, ADD, BASE, NONE };

template <int MODE>
__device__ __forceinline__ void accum_phase(const float* __restrict__ a, int as,
                                            const float* __restrict__ vf,
                                            const float* __restrict__ base,
                                            const float* __restrict__ dec, float* __restrict__ dst,
                                            int C, int K, int VB, int nw) {
  constexpr int NS = 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int vp = col_stride(VB);
  const int ns = min(NS, VB / 8), nn = VB / (8 * ns), items = ((K + 15) / 16) * nn;
  for (int it = threadIdx.x >> 5; it < items; it += nw) {
    const int m0 = (it / nn) * 16, n0 = (it % nn) * 8 * ns;
    const int m = m0 + g;
    const bool vm0 = m < K, vm1 = m + 8 < K;
    Acc d[NS];
    for (int j0 = 0; j0 < C; j0 += 8) {
      const int ja = j0 + t, jb = j0 + t + 4;
      const bool va = ja < C, vb = jb < C;
      AFrag f;
      f.set({va && vm0 ? a[ja * as + m] : 0.f, va && vm1 ? a[ja * as + m + 8] : 0.f,
             vb && vm0 ? a[jb * as + m] : 0.f, vb && vm1 ? a[jb * as + m + 8] : 0.f});
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (s < ns) {
          const int n = n0 + 8 * s + g;
          d[s].mma3(f, va ? vf[ja * vp + n] : 0.f, vb ? vf[jb * vp + n] : 0.f);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s < ns) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? m : m + 8, cc = n0 + 8 * s + 2 * t + (e & 1);
          if (r < K) {
            const int i = r * vp + cc;
            if constexpr (MODE == DECAY)
              dst[i] = fmaf(dec[r], base[i], d[s].get(e));
            else if constexpr (MODE == ADD)
              dst[i] += d[s].get(e);
            else if constexpr (MODE == BASE)
              dst[i] = base[i] + d[s].get(e);
            else
              dst[i] = d[s].get(e);
          }
        }
      }
    }
  }
}

// d0 / d1 += rows r0 and r1 of A (at row stride kp) times column n of B (at
// row stride vp) over Kp, even and odd k steps in separate accumulators.
__device__ __forceinline__ void rows_product(Acc& d0, Acc& d1, const float* __restrict__ A,
                                             const float* __restrict__ B, int r0, int r1,
                                             bool v0, bool v1, int n, int t, int Kp, int kp,
                                             int vp) {
#pragma unroll
  for (int k0 = 0; k0 < Kp; k0 += 16) {
    AFrag a;
    a.set({v0 ? A[r0 * kp + k0 + t] : 0.f, v1 ? A[r1 * kp + k0 + t] : 0.f,
           v0 ? A[r0 * kp + k0 + t + 4] : 0.f, v1 ? A[r1 * kp + k0 + t + 4] : 0.f});
    d0.mma3(a, B[(k0 + t) * vp + n], B[(k0 + t + 4) * vp + n]);
    if (k0 + 8 < Kp) {
      const int k1 = k0 + 8;
      AFrag a1;
      a1.set({v0 ? A[r0 * kp + k1 + t] : 0.f, v1 ? A[r1 * kp + k1 + t] : 0.f,
              v0 ? A[r0 * kp + k1 + t + 4] : 0.f, v1 ? A[r1 * kp + k1 + t + 4] : 0.f});
      d1.mma3(a1, B[(k1 + t) * vp + n], B[(k1 + t + 4) * vp + n]);
    }
  }
}

// 3. output rows: q_in · S [+ q_intra · P] + scores · v (+ diag · v), one
//    16 x 8 tile per warp, as one product of [q_in | q_intra | scores] and
//    [S ; P ; v], even and odd k steps in separate accumulators; row r goes
//    to o + r·ostride, columns past the block's vcols are not stored.
template <typename T>
__device__ __forceinline__ void output_phase(const float* __restrict__ qin,
                                             const float* __restrict__ S,
                                             const float* __restrict__ qa,
                                             const float* __restrict__ P,
                                             const float* __restrict__ sc,
                                             const float* __restrict__ vf,
                                             const float* __restrict__ diag, T* __restrict__ o,
                                             long long ostride, int C, int Kp, int VB, int vcols,
                                             bool pairs, bool excl, int nw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kp = tile_stride(Kp), vp = col_stride(VB), scp = sc_stride(C);
  const int nn = VB / 8, items = ((C + 15) / 16) * nn;
  for (int it = threadIdx.x >> 5; it < items; it += nw) {
    const int m0 = (it / nn) * 16, n0 = (it % nn) * 8;
    const int r0 = m0 + g, r1 = m0 + g + 8, n = n0 + g;
    const bool v0 = r0 < C, v1 = r1 < C;
    Acc d0, d1;
    rows_product(d0, d1, qin, S, r0, r1, v0, v1, n, t, Kp, kp, vp);
    if (P != nullptr) rows_product(d0, d1, qa, P, r0, r1, v0, v1, n, t, Kp, kp, vp);
    const int live = min(C, m0 + 16);  // scores beyond are masked
    for (int j0 = 0; j0 < live; j0 += 8) {
      const int ja = j0 + t, jb = j0 + t + 4;
      const bool va = ja < C, vb = jb < C;
      AFrag a;
      a.set({v0 && va ? sc[r0 * scp + ja] : 0.f, v1 && va ? sc[r1 * scp + ja] : 0.f,
             v0 && vb ? sc[r0 * scp + jb] : 0.f, v1 && vb ? sc[r1 * scp + jb] : 0.f});
      const float b0 = va ? vf[ja * vp + n] : 0.f, b1 = vb ? vf[jb * vp + n] : 0.f;
      if (j0 & 8)
        d1.mma3(a, b0, b1);
      else
        d0.mma3(a, b0, b1);
    }
    const int cc = n0 + 2 * t;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = h2 ? r1 : r0;
      if (r < C && cc < vcols) {
        float x = d0.get(2 * h2) + d1.get(2 * h2), y = d0.get(2 * h2 + 1) + d1.get(2 * h2 + 1);
        if (excl) {
          x = fmaf(diag[r], vf[r * vp + cc], x);
          y = fmaf(diag[r], vf[r * vp + cc + 1], y);
        }
        T* dst = o + r * ostride + cc;
        if (pairs && cc + 1 < vcols) {
          store2(dst, x, y);
        } else {
          store1(dst, x);
          if (cc + 1 < vcols) store1(dst + 1, y);
        }
      }
    }
  }
}

// MULTI: a chunk runs in several sub-blocks (an instance of its own, so
// that a chunk of one sub-block runs none of their code).  TAIL: K is not a
// multiple of 8, V leaves a last column block narrower than VB, or K does
// not divide the threads (an instance of its own, so that the shapes
// without runs none of the tails' predicates).  KC, CC, VBC,
// NTC: K, the chunk, VB and the threads fixed at compile time (on the
// serving path, whose chunk is one sub-block and whose V is whole column
// blocks), or 0 to take them from the arguments; EXC 1 when a bonus is sure
// to be given (the exclusive mask), 0 to test for one.
template <typename T, bool USE_RING, bool MULTI, bool TAIL, int KC, int CC, int VBC, int NTC,
          int EXC>
__global__ void __launch_bounds__(MAX_THREADS)
rwkv6_chunked_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ ldec,
                           const float* __restrict__ bonus, const float* __restrict__ s0,
                           T* __restrict__ out, float* __restrict__ s_out, Strides sd, int H,
                           int T_len, int K_arg, int V, int C_arg, int VB_arg, int CS_arg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = KC ? KC : K_arg, C = CC ? CC : C_arg, VB = VBC ? VBC : VB_arg;
  const int CS = CC ? CC : MULTI ? CS_arg : C;   // rows of a sub-block
  constexpr bool multi = MULTI;
  const int Kp = TAIL ? pad8(K) : K;
  const int nt = NTC ? NTC : blockDim.x, nw = nt >> 5, tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int vb0 = blockIdx.y * VB, vcols = TAIL ? min(VB, V - vb0) : VB;
  const bool pairs = !TAIL || (V & 1) == 0;   // two output columns a store stay aligned
  const bool whole = !TAIL || nt % K == 0;
  const bool excl = EXC || bonus != nullptr;
  const int nsub = MULTI ? (C + CS - 1) / CS : 1, total = (T_len / C) * nsub;
  const int vp = col_stride(VB);
  const Layout ly = layout(K, VB, CS, sizeof(T), USE_RING ? RING : 0, multi);
  T* ring = reinterpret_cast<T*>(smem + ly.ring);
  float* qin = reinterpret_cast<float*>(smem + ly.tiles);
  float* qa = qin + CS * tile_stride(Kp);
  float* ka = qa + CS * tile_stride(Kp);
  float* ko = ka + CS * tile_stride(Kp);  // rows of kout_stride(Kp)
  float* vf = reinterpret_cast<float*>(smem + ly.vf);
  float* sc = reinterpret_cast<float*>(smem + ly.sc);
  float* S = reinterpret_cast<float*>(smem + ly.s);  // the state this chunk reads
  float* Sn = S + Kp * vp;                            // and the one it writes
  float* P = Sn + Kp * vp;                            // multi: Σ k_intraᵀ·v so far
  float* Pn = P + Kp * vp;                            // and with this sub-block
  float* dec = reinterpret_cast<float*>(smem + ly.vec);
  float* diag = dec + K;
  float* cen = diag + CS;                             // multi only: centre, Lc,
  float* lcv = cen + K;                               // the carried L
  float* lrun = lcv + K;
  const int stage_elems = CS * (3 * K + VB);

  const T* qb = q + b * sd.q[0] + h * sd.q[1];
  const T* kb = k + b * sd.k[0] + h * sd.k[1];
  const T* lb = ldec + b * sd.ld[0] + h * sd.ld[1];
  const T* vb = v + b * sd.v[0] + h * sd.v[1] + vb0;

  // where K is not a multiple of 8 or V leaves a last block narrower than
  // VB, zero the whole of shared memory once: the padding past K and past
  // the block's columns is read by the products and must stay zero
  if (TAIL && ((K & 7) || V % VB)) {
    for (int i = tid; i < ly.total / 16; i += nt)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  for (int i = tid; i < K * VB; i += nt) {
    const int r = i / VB, c = i % VB;
    S[r * vp + c] = s0 && c < vcols ? s0[((long long)bh * K + r) * V + vb0 + c] : 0.f;
  }
  if constexpr (USE_RING) {
    issue_rows(ring, qb, kb, lb, vb, sd, 0, min(CS, C), CS, K, VB, vcols, nt);
    cp_async_commit();
  }

#pragma unroll 1
  for (int g = 0; g < total; ++g) {
    const int c = g / nsub, sub = g - c * nsub;
    const int t0 = c * C + sub * CS, cs = min(CS, C - sub * CS);
    const T *sq, *sk, *sl, *sv;
    long long stq, stk, stl, stv;
    if constexpr (USE_RING) {
      if (g + 1 < total) {  // the other stage was last read before the previous sub-block's syncs
        const int c1 = (g + 1) / nsub, s1 = g + 1 - c1 * nsub;
        issue_rows(ring + ((g + 1) & 1) * stage_elems, qb, kb, lb, vb, sd, c1 * C + s1 * CS,
                   min(CS, C - s1 * CS), CS, K, VB, vcols, nt);
      }
      cp_async_commit();
      cp_async_wait1();
      const T* st = ring + (g & 1) * stage_elems;
      sq = st;
      sk = st + CS * K;
      sl = st + 2 * CS * K;
      sv = st + 3 * CS * K;
      stq = stk = stl = K;
      stv = VB;
    } else {
      sq = qb + t0 * sd.q[2];
      sk = kb + t0 * sd.k[2];
      sl = lb + t0 * sd.ld[2];
      sv = vb + t0 * sd.v[2];
      stq = sd.q[2];
      stk = sd.k[2];
      stl = sd.ld[2];
      stv = sd.v[2];
    }
    // the chunk's centre, Lc and e^Lc before its first sub-block (the
    // previous sub-block's output phase reads none of them)
    if (multi && sub == 0)
      chunk_phase(lb + (long long)c * C * sd.ld[2], sd.ld[2], cen, lcv, dec, C, K, excl, nt);
    __syncthreads();

    // 1. the scaled tiles, exp(Lc), v in float32 and the bonus diagonal
    tiles_phase(sq, stq, sk, stk, sl, stl, sv, stv, qin, qa, ka, ko, vf, dec, cen, lcv, lrun,
                sub, multi, whole, cs, K, Kp, VB, vcols, excl, nt);
    if (excl) diag_phase(sq, stq, sk, stk, bonus + (long long)h * K, diag, cs, K, nw);
    __syncthreads();

    // 2. the live scores, the next state into the other buffer, and P with
    //    this sub-block for the next one
    scores_phase(qa, ka, sc, cs, Kp, excl, nw);
    if (sub == 0)
      accum_phase<DECAY>(ko, kout_stride(Kp), vf, S, dec, Sn, cs, K, VB, nw);
    else
      accum_phase<ADD>(ko, kout_stride(Kp), vf, nullptr, nullptr, Sn, cs, K, VB, nw);
    if (MULTI && sub + 1 < nsub) {
      if (sub)
        accum_phase<BASE>(ka, tile_stride(Kp), vf, P, nullptr, Pn, cs, K, VB, nw);
      else
        accum_phase<NONE>(ka, tile_stride(Kp), vf, nullptr, nullptr, Pn, cs, K, VB, nw);
    }
    __syncthreads();

    // 3. output rows from the state the chunk read and the earlier
    //    sub-blocks' P
    output_phase(qin, S, qa, multi && sub ? P : nullptr, sc, vf, diag,
                 out + (((long long)b * T_len + t0) * H + h) * V + vb0, (long long)H * V, cs, Kp,
                 VB, vcols, pairs, excl, nw);
    if (sub == nsub - 1) {  // the next chunk reads the new state
      float* const sw = S;
      S = Sn;
      Sn = sw;
    }
    if (multi) {
      float* const pw = P;
      P = Pn;
      Pn = pw;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * VB; i += nt) {
    const int r = i / VB, c = i % VB;
    if (c < vcols) s_out[((long long)bh * K + r) * V + vb0 + c] = S[r * vp + c];
  }
}

// Whether every (b, h, t) row starts on 16 bytes (cp.async copies 16 bytes);
// the stride of a dimension of size 1 never moves a row.  Mirrored by
// kernels/rwkv6.py::rows_aligned.
inline bool aligned16(const void* p, const long long* st, const int* dims, int esize) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (dims[i] > 1 && (st[i] * esize) % 16) return false;
  return true;
}

template <typename T, bool USE_RING, bool MULTI, bool TAIL, int KC = 0, int CC = 0,
          int VBC = 0, int NTC = 0, int EXC = 0>
int launch(const void* q, const void* k, const void* v, const void* ld, const void* bonus,
           const void* s0, void* out, void* s_out, const Strides& sd, int B, int H, int t_len,
           int K, int V, int C, int VB, int CS, int threads, int smem, cudaStream_t stream) {
  auto kern = rwkv6_chunked_fused_kernel<T, USE_RING, MULTI, TAIL, KC, CC, VBC, NTC, EXC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)(B * H), (unsigned)((V + VB - 1) / VB));
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ld), static_cast<const float*>(bonus), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(s_out), sd, H, t_len, K, V, C, VB, CS);
  return (int)cudaGetLastError();
}

// The generic instances: a chunk of one sub-block with or without tails, a
// chunk of several (tails or not), each with the ring or direct loads.
template <typename T>
int launch_any(bool ring, bool multi, bool tail, const void* q, const void* k, const void* v,
               const void* ld, const void* bonus, const void* s0, void* out, void* s_out,
               const Strides& sd, int B, int H, int t_len, int K, int V, int C, int VB, int CS,
               int threads, int smem, cudaStream_t st) {
#define RWKV6_LAUNCH(RING, MULTI, TAIL)                                                        \
  launch<T, RING, MULTI, TAIL>(q, k, v, ld, bonus, s0, out, s_out, sd, B, H, t_len, K, V, C, VB, \
                               CS, threads, smem, st)
  if (multi) return ring ? RWKV6_LAUNCH(true, true, true) : RWKV6_LAUNCH(false, true, true);
  if (tail) return ring ? RWKV6_LAUNCH(true, false, true) : RWKV6_LAUNCH(false, false, true);
  return ring ? RWKV6_LAUNCH(true, false, false) : RWKV6_LAUNCH(false, false, false);
#undef RWKV6_LAUNCH
}

}  // namespace

// q, k, ld (B, H, T, K) and v (B, H, T, V), float32 (`dtype` 0), bf16 (1) or
// float16 (2), at the element strides `strides` ((b, h, t) of q, k, v, ld;
// innermost stride 1); bonus (H, K) float32 or null (null: inclusive mask);
// s0 (B·H, K, V) float32 or null for zeros; out (B, T, H, V) in the inputs'
// dtype; s_out (B·H, K, V) float32.  Contiguous outputs on the inputs'
// device.  K and V are each in 1..256; `chunk` divides T.
//
// The launch plan comes from the caller (kernels/rwkv6.py::plan): VB (8,
// 16, 32 or 64), cs the rows of a sub-block (1..64, at most the chunk; a
// chunk of several runs as sub-blocks), the cp.async ring or direct loads,
// 128 or 256 threads.  The ring needs every row of every input 16-byte
// aligned and K and V rows whole 16-byte units.  Writes the plan's
// shared-memory bytes to *smem and launches on `stream`; returns the
// cudaError_t of the launch (0 on success), cudaErrorInvalidValue for an
// argument or plan it does not take, or RWKV6_NO_SMEM when the plan does
// not fit in a CTA's shared memory.
extern "C" int rwkv6_fused_launch(const void* q, const void* k, const void* v, const void* ld,
                                  const void* bonus, const void* s0, void* out, void* s_out,
                                  int dtype, int B, int H, int T, int K, int V, int chunk,
                                  const long long* strides, int vb, int cs, int ring,
                                  int threads, void* stream, int* smem) {
  const long long bh = (long long)B * H;
  const int esize = dtype == 0 ? 4 : 2;
  if (B <= 0 || H <= 0 || bh > 0x7fffffffLL || T <= 0 || K < 1 || K > MAX_DIM || V < 1 ||
      V > MAX_DIM || chunk < 1 || T % chunk || dtype < 0 || dtype > 2 ||
      !(vb == 8 || vb == 16 || vb == 32 || vb == 64) || cs < 1 || cs > MAX_SUB || cs > chunk ||
      !(threads == 128 || threads == 256))
    return (int)cudaErrorInvalidValue;
  Strides sd;
  memcpy(sd.q, strides, 3 * sizeof(long long));
  memcpy(sd.k, strides + 3, 3 * sizeof(long long));
  memcpy(sd.v, strides + 6, 3 * sizeof(long long));
  memcpy(sd.ld, strides + 9, 3 * sizeof(long long));
  const int dims[3] = {B, H, T};
  if (ring && !((K * esize) % 16 == 0 && (V * esize) % 16 == 0 &&
                aligned16(q, sd.q, dims, esize) && aligned16(k, sd.k, dims, esize) &&
                aligned16(v, sd.v, dims, esize) && aligned16(ld, sd.ld, dims, esize)))
    return (int)cudaErrorInvalidValue;
  *smem = layout(K, vb, cs, esize, ring ? RING : 0, cs < chunk).total;
  if (*smem > MAX_SMEM) return RWKV6_NO_SMEM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm = *smem;
  if (dtype == 1 && ring && bonus && K == 64 && chunk == 16 && cs == 16 &&
      V % vb == 0) {  // the serving path
    switch (vb) {
      case 16:
        if (threads == 128)
          return launch<__nv_bfloat16, true, false, false, 64, 16, 16, 128, 1>(
              q, k, v, ld, bonus, s0, out, s_out, sd, B, H, T, K, V, chunk, vb, cs, threads, sm,
              st);
        break;
      case 32:
        if (threads == 128)
          return launch<__nv_bfloat16, true, false, false, 64, 16, 32, 128, 1>(
              q, k, v, ld, bonus, s0, out, s_out, sd, B, H, T, K, V, chunk, vb, cs, threads, sm,
              st);
        break;
      case 64:
        if (threads == 256)
          return launch<__nv_bfloat16, true, false, false, 64, 16, 64, 256, 1>(
              q, k, v, ld, bonus, s0, out, s_out, sd, B, H, T, K, V, chunk, vb, cs, threads, sm,
              st);
        break;
    }
  }
  const bool multi = cs < chunk, tail = (K & 7) || V % vb || threads % K;
  if (dtype == 1)
    return launch_any<__nv_bfloat16>(ring, multi, tail, q, k, v, ld, bonus, s0, out, s_out, sd,
                                     B, H, T, K, V, chunk, vb, cs, threads, sm, st);
  if (dtype == 2)
    return launch_any<__half>(ring, multi, tail, q, k, v, ld, bonus, s0, out, s_out, sd, B, H,
                              T, K, V, chunk, vb, cs, threads, sm, st);
  return launch_any<float>(ring, multi, tail, q, k, v, ld, bonus, s0, out, s_out, sd, B, H, T,
                           K, V, chunk, vb, cs, threads, sm, st);
}
