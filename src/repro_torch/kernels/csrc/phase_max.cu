// CSR segment max for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/phase_max.py::_row_max_kernel
// together with its wrapper phase_worst_pallas: the per-phase worst link load
// of the simulator's rate resolution,
//     out[i] = max(vals[ptr[i] : ptr[i + 1]]),   0 for an empty segment,
// with int64 values, pointers and results (the engines' link loads are int64).
// The Pallas wrapper first gathers the ragged CSR on the host into a dense
// int32 tile padded with INT32_MIN; this kernel reads the CSR directly, so
// there is no host densification and no int32 narrowing.
//
// Design.  One warp per segment, 8 warps per CTA.  The lanes stride the
// segment with coalesced 8-byte loads (four loads in flight per lane in the
// main loop), each keeping a running max that starts at INT64_MIN; a
// __shfl_xor_sync butterfly reduces the 32 partial maxima (64-bit shuffles);
// lane 0 writes the max, or 0 when the segment is empty.  Integer max is
// exact and order-free, so the result is bit-identical to numpy's.
//
// Bound on the H100: the kernel must read every value once and the pointer
// array once and write one int64 per segment, (8 nvals + 16 nseg) bytes at
// 3.35 TB/s.  At the simulator's sizes (a few thousand to ~24k values per
// call) that is a few nanoseconds to ~60 ns, far below the launch latency
// (several microseconds), which is what sets the floor of one call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // segments per CTA
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;                // loads in flight per lane
constexpr long long I64_MIN = (long long)(-9223372036854775807LL - 1);

__device__ __forceinline__ long long max64(long long a, long long b) {
  return a > b ? a : b;
}

__global__ void __launch_bounds__(THREADS)
segment_max_kernel(const long long* __restrict__ vals, const long long* __restrict__ ptr,
                   long long* __restrict__ out, long long nseg, long long nvals) {
  const long long seg = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (seg >= nseg) return;               // whole warps leave together
  // the host checks the pointer (0 first, nvals last, monotone); clamping
  // here only guarantees that a malformed one never reads out of bounds
  const long long lo = max64(ptr[seg], 0);
  const long long hi = ptr[seg + 1] < nvals ? ptr[seg + 1] : nvals;

  long long m = I64_MIN;
  long long i = lo + lane;
  for (; i + (UNROLL - 1) * 32 < hi; i += UNROLL * 32) {
    long long v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(vals + i + u * 32);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) m = max64(m, v[u]);
  }
  for (; i < hi; i += 32) m = max64(m, __ldg(vals + i));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max64(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[seg] = hi > lo ? m : 0;
}

}  // namespace

// vals (nvals,), ptr (nseg + 1,), out (nseg,): int64 device arrays.  Launches
// on `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int phase_max_launch(const void* vals, const void* ptr, void* out, long long nseg,
                                long long nvals, void* stream) {
  if (nseg <= 0) return 0;
  const long long blocks = (nseg + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_max_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(vals), static_cast<const long long*>(ptr),
      static_cast<long long*>(out), nseg, nvals);
  return (int)cudaGetLastError();
}
