// Flash-attention forward for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_attn_kernel
// together with its wrapper src/repro/kernels/ops.py::flash_attention: blocked
// online-softmax attention with float32 running max / sum / accumulator, causal
// and sliding-window masks, fully masked tiles skipped with the reference's
// liveness tests, ragged sequence ends masked by kpos < Skv, masked scores set
// to -1e30 (not -inf) and the finalize acc / max(l, 1e-20).
//
// Design.  One CTA of 4 warps per (batch, q head, 64-row q tile); each warp owns
// 16 q rows.  A loop over 64-row K/V tiles staged in shared memory takes the
// place of the TPU grid's sequential kv axis.  GQA reads kv head
// h / (Hq / Hkv) directly instead of repeating K/V (kv-major grouping, as
// src/repro/models/attention.py:119).  Inputs are read in their (B, S, H, hd)
// layout through strides: no transpose or pad copy.
//   bf16: both products on the tensor cores with mma.sync m16n8k16 (bf16 in,
//         f32 accumulate).  The Pallas kernel keeps P in f32 for the PV
//         product (it upcasts V), so P is split into P_hi = bf16(P) and
//         P_lo = bf16(P - P_hi) and both halves go through mma.sync into the
//         same f32 accumulator: P keeps ~16 mantissa bits, V is exact, and
//         the output agrees with the f32-P plain version to its own bf16
//         rounding.  This doubles the PV products and keeps P in registers.
//   fp32: both products as plain f32 FMAs (no TF32), P through shared memory.
//
// Bound on the H100 at the serving path's shape (B=4, S=2048, Hq=32, Hkv=4,
// hd=64, causal, bf16): ~69 GFLOP of products against ~75 MB of q/k/v/o, so it
// is bound by the tensor cores (~70 us at 989 TFLOP/s), not by memory (~22 us
// at 3.35 TB/s).  This kernel uses mma.sync with synchronous loads, no wgmma,
// no TMA and no load/compute overlap, so it runs well below that bound.
// Making it fast (wgmma, TMA, a ring of K/V stages, warp specialisation) is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;              // q rows per CTA
constexpr int BK = 64;              // kv rows per tile
constexpr int NWARPS = BQ / 16;     // one warp per 16 q rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;   // the reference's sentinel, never -inf

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, Hq, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal;
  int window;                       // <= 0: no window
  float sm_scale;
};

// Shared-memory plan.  Rows are padded by 16 bytes: keeps 16-byte stores
// aligned and spreads the fragment reads of one warp over distinct banks.
template <typename T, int HD>
struct Plan {
  static constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int KSTR = HD + PAD;        // K rows; Q and V rows too for fp32
  static constexpr int VTSTR = BK + PAD;       // bf16: V stored transposed, (hd, BK)
  static constexpr int PSTR = BK + 4;          // fp32: per-warp P rows
  static constexpr int K_ELEMS = BK * KSTR;    // bf16 stages the Q tile here first
  static constexpr int V_ELEMS = kBF16 ? HD * VTSTR : BK * KSTR;
  static constexpr int Q_ELEMS = kBF16 ? 0 : BQ * KSTR;
  static constexpr int P_FLOATS = kBF16 ? 0 : NWARPS * 16 * PSTR;
  static constexpr size_t kBytes =
      (size_t)(K_ELEMS + V_ELEMS + Q_ELEMS) * sizeof(T) + (size_t)P_FLOATS * sizeof(float);
};

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as two packed bf16 pairs, hi = bf16(x) and lo = bf16(x - hi), so
// that hi + lo carries x to ~16 mantissa bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// D += A(16x16, row) * B(16x8, col), bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// bf16 V tile stored transposed, vt[d][j], so that the PV product's B
// fragments are 32-bit reads along j.
template <int HD, int VTSTR>
__device__ __forceinline__ void load_tile_transposed(__nv_bfloat16* vt,
                                                     const __nv_bfloat16* src,
                                                     long long row_stride, int row0,
                                                     int rows) {
  constexpr int CPR = HD / 8;
  for (int c = threadIdx.x; c < 64 * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int g = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < rows) val = *reinterpret_cast<const uint4*>(src + g * row_stride + col);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) vt[(col + i) * VTSTR + r] = e[i];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) attn_fwd_kernel(const Params p) {
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

  uint32_t qa[HD / 16][4];   // bf16: Q as mma A fragments, kept in registers
  if constexpr (P::kBF16) {
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
    if constexpr (P::kBF16) {
      load_tile_transposed<HD, P::VTSTR>(v_s, vg, p.v_ss, k0, p.Skv);
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
    if constexpr (P::kBF16) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const T* kb = k_s + (nt * 8 + group) * P::KSTR + kk * 16 + tig * 2;
          mma_bf16(s[nt], qa[kk], ld_pair(kb), ld_pair(kb + 8));
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

    // scale, mask, online softmax (row statistics reduced over the 4 lanes
    // of a quad, which together hold one row's 64 columns)
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
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
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      alpha[hr] = expf(m_i[hr] - mx[hr]);
      m_i[hr] = mx[hr];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
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
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o_acc[dt][i] *= alpha[i >> 1];

    // O += P V
    if constexpr (P::kBF16) {
      // the accumulator layout of two adjacent n-tiles is the A-fragment
      // layout of one 16-wide k step: P never leaves registers.  P goes in
      // as P_hi + P_lo (two products into one accumulator), keeping its f32
      // precision as the Pallas kernel does
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        uint32_t a_hi[4], a_lo[4];
        split_bf16(s[2 * t][0], s[2 * t][1], a_hi[0], a_lo[0]);
        split_bf16(s[2 * t][2], s[2 * t][3], a_hi[1], a_lo[1]);
        split_bf16(s[2 * t + 1][0], s[2 * t + 1][1], a_hi[2], a_lo[2]);
        split_bf16(s[2 * t + 1][2], s[2 * t + 1][3], a_hi[3], a_lo[3]);
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          const T* vb = v_s + (dt * 8 + group) * P::VTSTR + t * 16 + tig * 2;
          const uint32_t b0 = ld_pair(vb), b1 = ld_pair(vb + 8);
          mma_bf16(o_acc[dt], a_hi, b0, b1);
          mma_bf16(o_acc[dt], a_lo, b0, b1);
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
    for (int dt = 0; dt < HD / 8; ++dt) {
      const float x0 = o_acc[dt][2 * hr] / l, x1 = o_acc[dt][2 * hr + 1] / l;
      const int col = dt * 8 + tig * 2;
      if constexpr (P::kBF16) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t bytes = Plan<T, HD>::kBytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, batch);
  attn_fwd_kernel<T, HD><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, int batch, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int smem_bytes(int hd) {
  switch (hd) {
    case 16: return (int)Plan<T, 16>::kBytes;
    case 32: return (int)Plan<T, 32>::kBytes;
    case 64: return (int)Plan<T, 64>::kBytes;
    case 128: return (int)Plan<T, 128>::kBytes;
    default: return -1;
  }
}

}  // namespace

// Dynamic shared memory of one CTA, in bytes (-1: not a supported variant).
extern "C" int flash_attention_smem_bytes(int dtype, int hd) {
  if (dtype == 0) return smem_bytes<float>(hd);
  if (dtype == 1) return smem_bytes<__nv_bfloat16>(hd);
  return -1;
}

// q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), o (B, Sq, Hq, hd), each with a unit
// last stride; strides[12] holds the (batch, seq, head) strides, in elements,
// of q, k, v and o in that order.  dtype: 0 = float32, 1 = bfloat16.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int batch, int sq, int skv, int hq, int hkv,
                                   int hd, const long long* strides, int causal, int window,
                                   float sm_scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.Sq = sq; p.Skv = skv; p.Hq = hq; p.Hkv = hkv;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.causal = causal; p.window = window; p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_hd<float>(p, hd, batch, s);
  if (dtype == 1) return (int)dispatch_hd<__nv_bfloat16>(p, hd, batch, s);
  return (int)cudaErrorInvalidValue;
}
