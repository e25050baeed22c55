// RWKV6 / Mamba2 chunked linear recurrence for NVIDIA Hopper (sm_90a), with
// the decay precompute and the RWKV6 bonus diagonal fused in; plain C
// interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6.py::_rwkv_kernel
// (launched by rwkv6_chunked_fwd) together with the elementwise work that
// src/repro/kernels/ops.py::rwkv6_mix (:97-123) does around it in XLA.  On
// the model's q, k (B, H, T, K), v (B, H, T, V) and log decay (B, H, T, K),
// in the model's dtype (bf16 or float32) and read through their strides, it
// computes per (b, h) and chunk of C steps, in float32:
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
//    of VB columns): grid (B·H, V/VB).  Each CTA recomputes the chunk's
//    decay precompute and its C x C scores; VB trades that redundancy
//    against CTAs in flight.  rwkv6_fused_launch makes the plan: VB 32
//    unless the caller names one (PERF.md has the times of VB 16, 32 and
//    64).  S for the column block lives in shared memory, double-buffered
//    so that the state update and the scores share one phase.  A chunk is
//    three phases between barriers: (1) the scaled tiles, each thread
//    owning a K column and a block of rows (the column's cumsum run
//    sequentially, as the plain version runs it); (2) the scores and the
//    next state; (3) the output rows.
//  * B: the next chunk's raw q, k, log decay and v tiles are copied by
//    cp.async into a 2-deep ring while the current chunk computes.  Inputs
//    whose rows are not 16-byte aligned, or shapes whose ring would not fit
//    in shared memory (K 128 at chunk 64 in float32), read them from device
//    memory instead, in the same loop.
//  * C: the three products (scores, k_outᵀ·v, [q_in | scores]·[S ; v]) run
//    on the tensor cores as mma.sync m16n8k8 TF32 with a 3xTF32 split, at
//    float32 accuracy (plain TF32 would not hold 1e-4).  wgmma's 64-row
//    tiles do not fit chunk 16.
// Each phase is a function whose shared-memory operands are __restrict__, so
// that loads are not held behind stores the compiler cannot disambiguate.
// The serving path's shape (bf16, K 64, chunk 16, a bonus, the ring) runs an
// instance with those values, VB (16, 32 or 64) and the threads fixed at
// compile time, its k loops unrolled, so that the VBs compare like with like;
// every other shape (and VB 8) runs the instance that takes them at run
// time.  What still separates the kernel from its bound is latency: per
// chunk a CTA runs short dependent chains between barriers with few warps
// per SM.
// K and V are each one of 8, 16, 32, 64, 128; C is any of 1..64 dividing T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float LOG_DECAY_MIN = -4.0f;
constexpr int MAX_CHUNK = 64;
constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a CTA can have
constexpr int RING = 2;
constexpr int DEFAULT_VB = 32;    // the fastest column block on the serving path (PERF.md)
constexpr int RWKV6_NO_SMEM = -2;

struct Strides {
  long long q[3], k[3], v[3], ld[3];  // (b, h, t) strides in elements
};

__host__ __device__ inline bool dim_ok(int d) {
  return d == 8 || d == 16 || d == 32 || d == 64 || d == 128;
}

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Byte offsets of the shared-memory regions of one CTA.
struct Layout {
  int ring, tiles, vf, sc, s, vec, total;
};

// Row strides of the float32 tiles, padded so that the mma.sync fragment
// loads of a warp hit 32 distinct banks.
__host__ __device__ inline int tile_stride(int K) { return K + 4; }   // q_in, q_intra, k_intra
__host__ __device__ inline int kout_stride(int K) { return K + 8; }   // k_out (read transposed)
__host__ __device__ inline int col_stride(int VB) { return VB + 8; }  // v, S
__host__ __device__ inline int sc_stride(int C) { return ((C + 7) & ~7) + 4; }

__host__ __device__ inline Layout layout(int K, int VB, int C, int esize, int stages) {
  Layout L;
  int off = 0;
  L.ring = off;   // stages x [q | k | ld (C, K) | v (C, VB)] in the input dtype
  off += align16(stages * C * (3 * K + VB) * esize);
  L.tiles = off;  // q_in | q_intra | k_intra (C, tile_stride) | k_out (C, kout_stride)
  off += align16((3 * tile_stride(K) + kout_stride(K)) * C * 4);
  L.vf = off;     // v, float32 (C, col_stride)
  off += align16(C * col_stride(VB) * 4);
  L.sc = off;     // masked scores (C, sc_stride)
  off += align16(C * sc_stride(C) * 4);
  L.s = off;      // S and the next S, (K, col_stride) each
  off += align16(2 * K * col_stride(VB) * 4);
  L.vec = off;    // exp(Lc) (K) | bonus diagonal (C)
  off += align16((K + C) * 4);
  L.total = off;
  return L;
}

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ inline void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
__device__ inline void store2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
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

// Copy chunk rows t0 .. t0 + C - 1 of q, k, ld (K wide) and v (VB wide) into
// one ring stage, 16 bytes per cp.async.
template <typename T>
__device__ inline void issue_chunk(T* stage, const T* qb, const T* kb, const T* lb, const T* vb,
                                   const Strides& sd, int t0, int C, int K, int VB, int nt) {
  constexpr int E = 16 / sizeof(T);  // elements per copy
  const int pk = K / E, pv = VB / E;
  const int nk = C * pk;
  for (int i = threadIdx.x; i < 3 * nk + C * pv; i += nt) {
    if (i < 3 * nk) {
      const int a = i / nk, r = i % nk, t = r / pk, p = r % pk;
      const T* base = a == 0 ? qb : a == 1 ? kb : lb;
      const long long st = a == 0 ? sd.q[2] : a == 1 ? sd.k[2] : sd.ld[2];
      cp_async16(stage + a * C * K + t * K + p * E, base + (t0 + t) * st + p * E);
    } else {
      const int r = i - 3 * nk, t = r / pv, p = r % pv;
      cp_async16(stage + 3 * C * K + t * VB + p * E, vb + (t0 + t) * sd.v[2] + p * E);
    }
  }
}

__device__ inline float clamp_ld(float x) { return fminf(fmaxf(x, LOG_DECAY_MIN), 0.f); }

// 1. the four scaled tiles, each exponential as the reference writes it,
//    and exp(Lc); v to float32.  Thread tid owns column tid % K and the
//    rows of block tid / K: it runs the column's cumsum once over the whole
//    chunk for the centre and Lc, then again up to its block, so every L is
//    the same sequential sum.
template <typename T>
__device__ __forceinline__ void tiles_phase(const T* __restrict__ sq, long long stq,
                                            const T* __restrict__ sk, long long stk,
                                            const T* __restrict__ sl, long long stl,
                                            const T* __restrict__ sv, long long stv,
                                            float* __restrict__ qin, float* __restrict__ qa,
                                            float* __restrict__ ka, float* __restrict__ ko,
                                            float* __restrict__ vf, float* __restrict__ dec, int C,
                                            int K, int VB, bool excl, int nt) {
  const int tid = threadIdx.x;
  const int kp = tile_stride(K), kop = kout_stride(K), vp = col_stride(VB);
  const int col = tid % K, part = tid / K, parts = nt / K;
  const int rpt = (C + parts - 1) / parts, r_lo = part * rpt, r_hi = min(C, r_lo + rpt);
  float acc = 0.f, mx = -__int_as_float(0x7f800000), mn = __int_as_float(0x7f800000);
#pragma unroll 8
  for (int t = 0; t < C; ++t) {
    const float l = clamp_ld(to_f(sl[t * stl + col]));
    acc += l;
    mx = fmaxf(mx, excl ? acc - l : acc);
    mn = fminf(mn, acc);
  }
  const float c = 0.5f * (mx + mn), e = acc;
  if (part == 0) dec[col] = expf(e);
  float L = 0.f;
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
  const int vs = __ffs(VB) - 1;  // VB is a power of two
#pragma unroll 4
  for (int i = tid; i < C * VB; i += nt) {
    const int t = i >> vs, cc = i & (VB - 1);
    vf[t * vp + cc] = to_f(sv[t * stv + cc]);
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
//    separate accumulators.
__device__ __forceinline__ void scores_phase(const float* __restrict__ qa,
                                             const float* __restrict__ ka,
                                             float* __restrict__ sc, int C, int K, bool excl,
                                             int nw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kp = tile_stride(K), scp = sc_stride(C);
  const int nn = (C + 7) / 8, items = ((C + 15) / 16) * nn;
  for (int it = nw - 1 - (threadIdx.x >> 5); it < items; it += nw) {
    const int m0 = (it / nn) * 16, n0 = (it % nn) * 8;
    const int r0 = m0 + g, r1 = m0 + g + 8, j = n0 + g;
    const bool v0 = r0 < C, v1 = r1 < C, vj = j < C;
    Acc d0, d1;
    if (n0 <= m0 + 15) {  // a tile above the diagonal is all masked
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        AFrag a;
        a.set({v0 ? qa[r0 * kp + k0 + t] : 0.f, v1 ? qa[r1 * kp + k0 + t] : 0.f,
               v0 ? qa[r0 * kp + k0 + t + 4] : 0.f, v1 ? qa[r1 * kp + k0 + t + 4] : 0.f});
        d0.mma3(a, vj ? ka[j * kp + k0 + t] : 0.f, vj ? ka[j * kp + k0 + t + 4] : 0.f);
        if (k0 + 8 < K) {
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

// 2b. the next state S' = exp(Lc)·S + k_outᵀ · v (K x VB); one 16 x 32 tile
//     (four 16 x 8 accumulators sharing each A fragment) per warp.
__device__ __forceinline__ void state_phase(const float* __restrict__ ko,
                                            const float* __restrict__ vf,
                                            const float* __restrict__ S,
                                            const float* __restrict__ dec,
                                            float* __restrict__ Sn, int C, int K, int VB, int nw) {
  constexpr int NS = 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kop = kout_stride(K), vp = col_stride(VB);
  const int ns = min(NS, VB / 8), nn = VB / (8 * ns), items = ((K + 15) / 16) * nn;
  for (int it = threadIdx.x >> 5; it < items; it += nw) {
    const int m0 = (it / nn) * 16, n0 = (it % nn) * 8 * ns;
    const int m = m0 + g;
    const bool vm0 = m < K, vm1 = m + 8 < K;
    Acc d[NS];
    for (int j0 = 0; j0 < C; j0 += 8) {
      const int ja = j0 + t, jb = j0 + t + 4;
      const bool va = ja < C, vb = jb < C;
      AFrag a;
      a.set({va && vm0 ? ko[ja * kop + m] : 0.f, va && vm1 ? ko[ja * kop + m + 8] : 0.f,
             vb && vm0 ? ko[jb * kop + m] : 0.f, vb && vm1 ? ko[jb * kop + m + 8] : 0.f});
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (s < ns) {
          const int n = n0 + 8 * s + g;
          d[s].mma3(a, va ? vf[ja * vp + n] : 0.f, vb ? vf[jb * vp + n] : 0.f);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s < ns) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? m : m + 8, cc = n0 + 8 * s + 2 * t + (e & 1);
          if (r < K) Sn[r * vp + cc] = fmaf(dec[r], S[r * vp + cc], d[s].get(e));
        }
      }
    }
  }
}

// 3. output rows: q_in · S + scores · v (+ diag · v), one 16 x 8 tile per
//    warp, as one product of [q_in | scores] and [S ; v], even and odd k
//    steps in separate accumulators; row r goes to o + r·ostride.
template <typename T>
__device__ __forceinline__ void output_phase(const float* __restrict__ qin,
                                             const float* __restrict__ S,
                                             const float* __restrict__ sc,
                                             const float* __restrict__ vf,
                                             const float* __restrict__ diag, T* __restrict__ o,
                                             long long ostride, int C, int K, int VB, bool excl,
                                             int nw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kp = tile_stride(K), vp = col_stride(VB), scp = sc_stride(C);
  const int nn = VB / 8, items = ((C + 15) / 16) * nn;
  for (int it = threadIdx.x >> 5; it < items; it += nw) {
    const int m0 = (it / nn) * 16, n0 = (it % nn) * 8;
    const int r0 = m0 + g, r1 = m0 + g + 8, n = n0 + g;
    const bool v0 = r0 < C, v1 = r1 < C;
    Acc d0, d1;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      AFrag a;
      a.set({v0 ? qin[r0 * kp + k0 + t] : 0.f, v1 ? qin[r1 * kp + k0 + t] : 0.f,
             v0 ? qin[r0 * kp + k0 + t + 4] : 0.f, v1 ? qin[r1 * kp + k0 + t + 4] : 0.f});
      d0.mma3(a, S[(k0 + t) * vp + n], S[(k0 + t + 4) * vp + n]);
      if (k0 + 8 < K) {
        const int k1 = k0 + 8;
        AFrag a1;
        a1.set({v0 ? qin[r0 * kp + k1 + t] : 0.f, v1 ? qin[r1 * kp + k1 + t] : 0.f,
                v0 ? qin[r0 * kp + k1 + t + 4] : 0.f, v1 ? qin[r1 * kp + k1 + t + 4] : 0.f});
        d1.mma3(a1, S[(k1 + t) * vp + n], S[(k1 + t + 4) * vp + n]);
      }
    }
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
      if (r < C) {
        float x = d0.get(2 * h2) + d1.get(2 * h2), y = d0.get(2 * h2 + 1) + d1.get(2 * h2 + 1);
        if (excl) {
          x = fmaf(diag[r], vf[r * vp + cc], x);
          y = fmaf(diag[r], vf[r * vp + cc + 1], y);
        }
        store2(o + r * ostride + cc, x, y);
      }
    }
  }
}

// KC, CC, VBC, NTC: K, the chunk, VB and the threads fixed at compile time
// (on the serving path), or 0 to take them from the arguments; EXC 1 when a
// bonus is sure to be given (the exclusive mask), 0 to test for one.
template <typename T, bool USE_RING, int KC, int CC, int VBC, int NTC, int EXC>
__global__ void __launch_bounds__(MAX_THREADS)
rwkv6_chunked_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ ldec,
                           const float* __restrict__ bonus, const float* __restrict__ s0,
                           T* __restrict__ out, float* __restrict__ s_out, Strides sd, int H,
                           int T_len, int K_arg, int V, int C_arg, int VB_arg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = KC ? KC : K_arg, C = CC ? CC : C_arg, VB = VBC ? VBC : VB_arg;
  const int nt = NTC ? NTC : blockDim.x, nw = nt >> 5, tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int vb0 = blockIdx.y * VB;
  const bool excl = EXC || bonus != nullptr;
  const int nc = T_len / C;
  const int kp = tile_stride(K), vp = col_stride(VB);
  const Layout ly = layout(K, VB, C, sizeof(T), USE_RING ? RING : 0);
  T* ring = reinterpret_cast<T*>(smem + ly.ring);
  float* qin = reinterpret_cast<float*>(smem + ly.tiles);
  float* qa = qin + C * kp;
  float* ka = qa + C * kp;
  float* ko = ka + C * kp;  // rows of kout_stride(K)
  float* vf = reinterpret_cast<float*>(smem + ly.vf);
  float* sc = reinterpret_cast<float*>(smem + ly.sc);
  float* S = reinterpret_cast<float*>(smem + ly.s);  // the state this chunk reads
  float* Sn = S + K * vp;                             // and the one it writes
  float* dec = reinterpret_cast<float*>(smem + ly.vec);
  float* diag = dec + K;
  const int stage_elems = C * (3 * K + VB);

  const T* qb = q + b * sd.q[0] + h * sd.q[1];
  const T* kb = k + b * sd.k[0] + h * sd.k[1];
  const T* lb = ldec + b * sd.ld[0] + h * sd.ld[1];
  const T* vb = v + b * sd.v[0] + h * sd.v[1] + vb0;

  for (int i = tid; i < K * VB; i += nt) {
    const int r = i / VB, c = i % VB;
    S[r * vp + c] = s0 ? s0[((long long)bh * K + r) * V + vb0 + c] : 0.f;
  }
  if constexpr (USE_RING) {
    issue_chunk(ring, qb, kb, lb, vb, sd, 0, C, K, VB, nt);
    cp_async_commit();
  }

#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * C;
    const T *sq, *sk, *sl, *sv;
    long long stq, stk, stl, stv;
    if constexpr (USE_RING) {
      if (c + 1 < nc)  // the other stage was last read before the previous chunk's syncs
        issue_chunk(ring + ((c + 1) & 1) * stage_elems, qb, kb, lb, vb, sd, t0 + C, C, K, VB,
                    nt);
      cp_async_commit();
      cp_async_wait1();
      const T* st = ring + (c & 1) * stage_elems;
      sq = st;
      sk = st + C * K;
      sl = st + 2 * C * K;
      sv = st + 3 * C * K;
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
    __syncthreads();

    // 1. the scaled tiles, exp(Lc), v in float32 and the bonus diagonal
    tiles_phase(sq, stq, sk, stk, sl, stl, sv, stv, qin, qa, ka, ko, vf, dec, C, K, VB, excl,
                nt);
    if (excl) diag_phase(sq, stq, sk, stk, bonus + (long long)h * K, diag, C, K, nw);
    __syncthreads();

    // 2. the live scores, and the next state into the other buffer
    scores_phase(qa, ka, sc, C, K, excl, nw);
    state_phase(ko, vf, S, dec, Sn, C, K, VB, nw);
    __syncthreads();

    // 3. output rows from the state this chunk read
    output_phase(qin, S, sc, vf, diag, out + (((long long)b * T_len + t0) * H + h) * V + vb0,
                 (long long)H * V, C, K, VB, excl, nw);
    float* const sw = S;  // the next chunk reads the new state
    S = Sn;
    Sn = sw;
  }
  __syncthreads();
  for (int i = tid; i < K * VB; i += nt) {
    const int r = i / VB, c = i % VB;
    s_out[((long long)bh * K + r) * V + vb0 + c] = S[r * vp + c];
  }
}

// Whether every (b, h, t) row starts on 16 bytes (cp.async copies 16 bytes);
// the stride of a dimension of size 1 never moves a row.
inline bool aligned16(const void* p, const long long* st, const int* dims, int esize) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (dims[i] > 1 && (st[i] * esize) % 16) return false;
  return true;
}

template <typename T, bool USE_RING, int KC = 0, int CC = 0, int VBC = 0, int NTC = 0,
          int EXC = 0>
int launch(const void* q, const void* k, const void* v, const void* ld, const void* bonus,
           const void* s0, void* out, void* s_out, const Strides& sd, int B, int H, int t_len,
           int K, int V, int C, int VB, int threads, int smem, cudaStream_t stream) {
  auto kern = rwkv6_chunked_fused_kernel<T, USE_RING, KC, CC, VBC, NTC, EXC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)(B * H), (unsigned)(V / VB));
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ld), static_cast<const float*>(bonus), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(s_out), sd, H, t_len, K, V, C, VB);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, ld (B, H, T, K) and v (B, H, T, V), bf16 (`bf16` 1) or float32, at
// the element strides `strides` ((b, h, t) of q, k, v, ld; innermost stride
// 1); bonus (H, K) float32 or null (null: inclusive mask); s0 (B·H, K, V)
// float32 or null for zeros; out (B, T, H, V) in the inputs' dtype; s_out
// (B·H, K, V) float32.  Contiguous outputs on the inputs' device.
//
// The launch plan is made here and written to plan[4] = {VB, threads, ring,
// shared-memory bytes}: VB is `vb` when it is not 0 (one of 8, 16, 32, 64,
// dividing V), else DEFAULT_VB (V when V is narrower), halved until a CTA
// with direct loads fits; 128 threads, 256 at VB 64; the cp.async ring when
// every row of every input is 16-byte aligned and the ring fits, else direct
// loads.  Launches on `stream` and returns the cudaError_t of the launch (0
// on success), or RWKV6_NO_SMEM when an explicit VB does not fit.
extern "C" int rwkv6_fused_launch(const void* q, const void* k, const void* v, const void* ld,
                                  const void* bonus, const void* s0, void* out, void* s_out,
                                  int bf16, int B, int H, int T, int K, int V, int chunk,
                                  const long long* strides, int vb, void* stream, int* plan) {
  const long long bh = (long long)B * H;
  if (B <= 0 || H <= 0 || bh > 0x7fffffffLL || T <= 0 || !dim_ok(K) || !dim_ok(V) ||
      chunk < 1 || chunk > MAX_CHUNK || T % chunk ||
      !(vb == 0 || vb == 8 || vb == 16 || vb == 32 || vb == 64) || vb > V || (vb && V % vb))
    return (int)cudaErrorInvalidValue;
  Strides sd;
  memcpy(sd.q, strides, 3 * sizeof(long long));
  memcpy(sd.k, strides + 3, 3 * sizeof(long long));
  memcpy(sd.v, strides + 6, 3 * sizeof(long long));
  memcpy(sd.ld, strides + 9, 3 * sizeof(long long));
  const int esize = bf16 ? 2 : 4;
  if (vb == 0) {
    vb = V < DEFAULT_VB ? V : DEFAULT_VB;
    while (vb > 8 && layout(K, vb, chunk, esize, 0).total > MAX_SMEM) vb /= 2;
  }
  const int threads = vb == 64 ? 256 : 128;
  const int dims[3] = {B, H, T};
  const bool ring = aligned16(q, sd.q, dims, esize) && aligned16(k, sd.k, dims, esize) &&
                    aligned16(v, sd.v, dims, esize) && aligned16(ld, sd.ld, dims, esize) &&
                    layout(K, vb, chunk, esize, RING).total <= MAX_SMEM;
  const int smem = layout(K, vb, chunk, esize, ring ? RING : 0).total;
  plan[0] = vb;
  plan[1] = threads;
  plan[2] = ring;
  plan[3] = smem;
  if (smem > MAX_SMEM) return RWKV6_NO_SMEM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16 && ring && bonus && K == 64 && chunk == 16) {  // the serving path
    switch (vb) {
      case 16:
        return launch<__nv_bfloat16, true, 64, 16, 16, 128, 1>(
            q, k, v, ld, bonus, s0, out, s_out, sd, B, H, T, K, V, chunk, vb, threads, smem, st);
      case 32:
        return launch<__nv_bfloat16, true, 64, 16, 32, 128, 1>(
            q, k, v, ld, bonus, s0, out, s_out, sd, B, H, T, K, V, chunk, vb, threads, smem, st);
      case 64:
        return launch<__nv_bfloat16, true, 64, 16, 64, 256, 1>(
            q, k, v, ld, bonus, s0, out, s_out, sd, B, H, T, K, V, chunk, vb, threads, smem, st);
    }
  }
  if (bf16)
    return ring ? launch<__nv_bfloat16, true>(q, k, v, ld, bonus, s0, out, s_out, sd, B, H, T, K,
                                              V, chunk, vb, threads, smem, st)
                : launch<__nv_bfloat16, false>(q, k, v, ld, bonus, s0, out, s_out, sd, B, H, T,
                                               K, V, chunk, vb, threads, smem, st);
  return ring ? launch<float, true>(q, k, v, ld, bonus, s0, out, s_out, sd, B, H, T, K, V, chunk,
                                    vb, threads, smem, st)
              : launch<float, false>(q, k, v, ld, bonus, s0, out, s_out, sd, B, H, T, K, V, chunk,
                                     vb, threads, smem, st);
}
