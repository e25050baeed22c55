// RWKV6 / Mamba2 chunked linear recurrence for NVIDIA Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6.py::_rwkv_kernel
// (launched by rwkv6_chunked_fwd from kernels/ops.py::rwkv6_mix).  On the
// same precomputed float32 inputs it computes, per (batch·head) and chunk of
// C steps,
//     o_chunk = q_in · S + mask(q_intra · k_intraᵀ) · v
//     S      ← diag(decay_chunk) · S + k_outᵀ · v
// where the mask is the strict lower triangle when `exclusive` (RWKV6, whose
// bonus diagonal the wrapper adds) and the inclusive one otherwise.  S is a
// (K, V) float32 state carried across the chunks; it starts from `s0` (zeros
// when null) and, unlike the TPU kernel, is written out at the end, since the
// port's one-pass prefill hands it to decode.
//
// Design.  The TPU grid is (B·H, chunks) with the chunk axis run in order and
// S kept in VMEM scratch between grid steps.  Blocks on the card run in no
// order, so one CTA owns one b·h and loops over its chunks itself, with S in
// shared memory (16 KB at K = V = 64).  Each chunk: stage q_intra, k_intra
// (rows padded by one float against bank conflicts) and v; compute the live
// scores; stage q_in over q_intra; write the output rows; stage k_out over
// q_in; update S.  Every product is float32 FMA on the CUDA cores (no TF32):
// the kernel is held against float32 references.  K and V are each one of
// 8, 16, 32, 64, 128; C is any of 1..64 that divides T.
//
// Bound on the H100: each input is read once and the output and S written
// once, 4 · (4·T·K + 2·T·V + (T/C)·K + K·V) bytes per b·h, over 3.35 TB/s;
// the live products are 2·(pairs·(K + V) + 2·C·K·V) flops per chunk over
// 67 TFLOP/s of float32.  At the serving path's shape (B·H 160, T 2048,
// K = V = 64, C 16) the bytes bound it.  This version is simple, not fast:
// one CTA per b·h gives 160 CTAs on 132 SMs, the chunk loop is serial with
// its loads not overlapped, and no product uses the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHUNK = 64;

__host__ __device__ inline bool dim_ok(int d) {
  return d == 8 || d == 16 || d == 32 || d == 64 || d == 128;
}

__host__ __device__ inline int smem_floats(int k, int v, int c) {
  // S (K·V) | qa: q_intra, then q_in, then k_out (C·K) | kb: k_intra (C·(K+1))
  // | vv (C·V) | sc: scores (C·C)
  return k * v + c * k + c * (k + 1) + c * v + c * c;
}

__global__ void __launch_bounds__(THREADS)
rwkv6_chunked_kernel(const float* __restrict__ q_in, const float* __restrict__ q_intra,
                     const float* __restrict__ k_intra, const float* __restrict__ k_out,
                     const float* __restrict__ v, const float* __restrict__ decay,
                     const float* __restrict__ s0, float* __restrict__ out,
                     float* __restrict__ s_out, int T, int K, int V, int C, int exclusive) {
  extern __shared__ float smem[];
  float* S = smem;
  float* qa = S + K * V;
  float* kb = qa + C * K;
  float* vv = kb + C * (K + 1);
  float* sc = vv + C * V;
  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const int nc = T / C;
  const int kp = K + 1;

  for (int i = tid; i < K * V; i += THREADS) S[i] = s0 ? s0[bh * K * V + i] : 0.f;

  for (int c = 0; c < nc; ++c) {
    const long long rk = (bh * T + (long long)c * C) * K;   // this chunk's (C, K) rows
    const long long rv = (bh * T + (long long)c * C) * V;   // and its (C, V) rows
    for (int i = tid; i < C * K; i += THREADS) {
      qa[i] = q_intra[rk + i];
      kb[(i / K) * kp + i % K] = k_intra[rk + i];
    }
    for (int i = tid; i < C * V; i += THREADS) vv[i] = v[rv + i];
    __syncthreads();

    // masked scores: only the live pairs are computed, the rest are 0
    for (int i = tid; i < C * C; i += THREADS) {
      const int r = i / C, col = i % C;
      float s = 0.f;
      if (exclusive ? col < r : col <= r) {
        const float* a = qa + r * K;
        const float* b = kb + col * kp;
        for (int k = 0; k < K; ++k) s = fmaf(a[k], b[k], s);
      }
      sc[i] = s;
    }
    __syncthreads();
    for (int i = tid; i < C * K; i += THREADS) qa[i] = q_in[rk + i];
    __syncthreads();

    // output rows: cross-chunk read of S, then the masked intra-chunk part
    for (int i = tid; i < C * V; i += THREADS) {
      const int r = i / V, col = i % V;
      const float* a = qa + r * K;
      float o = 0.f;
      for (int k = 0; k < K; ++k) o = fmaf(a[k], S[k * V + col], o);
      const int live = exclusive ? r : r + 1;
      const float* srow = sc + r * C;
      for (int j = 0; j < live; ++j) o = fmaf(srow[j], vv[j * V + col], o);
      out[rv + i] = o;
    }
    __syncthreads();
    for (int i = tid; i < C * K; i += THREADS) qa[i] = k_out[rk + i];
    __syncthreads();

    // state update: each thread owns its elements of S
    const float* dec = decay + (bh * nc + c) * K;
    for (int i = tid; i < K * V; i += THREADS) {
      const int k = i / V, col = i % V;
      float s = dec[k] * S[i];
      for (int j = 0; j < C; ++j) s = fmaf(qa[j * K + k], vv[j * V + col], s);
      S[i] = s;
    }
    __syncthreads();
  }
  for (int i = tid; i < K * V; i += THREADS) s_out[bh * K * V + i] = S[i];
}

}  // namespace

// Dynamic shared memory of one CTA, in bytes.
extern "C" int rwkv6_smem_bytes(int k, int v, int chunk) {
  return (int)sizeof(float) * smem_floats(k, v, chunk);
}

// q_in, q_intra, k_intra, k_out (bh, t, k); v and out (bh, t, v); decay
// (bh, t / chunk, k); s0 (bh, k, v) or null for zeros; s_out (bh, k, v).  All
// float32, contiguous, on one device.  Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int rwkv6_chunked_launch(const void* q_in, const void* q_intra, const void* k_intra,
                                    const void* k_out, const void* v, const void* decay,
                                    const void* s0, void* out, void* s_out, long long bh, int t,
                                    int k, int v_dim, int chunk, int exclusive, void* stream) {
  if (bh <= 0 || bh > 0x7fffffffLL || t <= 0 || !dim_ok(k) || !dim_ok(v_dim) || chunk < 1 ||
      chunk > MAX_CHUNK || t % chunk)
    return (int)cudaErrorInvalidValue;
  const int smem = rwkv6_smem_bytes(k, v_dim, chunk);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  rwkv6_chunked_kernel<<<(unsigned)bh, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_in), static_cast<const float*>(q_intra),
      static_cast<const float*>(k_intra), static_cast<const float*>(k_out),
      static_cast<const float*>(v), static_cast<const float*>(decay),
      static_cast<const float*>(s0), static_cast<float*>(out), static_cast<float*>(s_out), t, k,
      v_dim, chunk, exclusive);
  return (int)cudaGetLastError();
}
