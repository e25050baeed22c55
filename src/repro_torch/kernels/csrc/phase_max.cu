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
// segment with coalesced 8-byte loads in rounds of 256 values (eight loads
// in flight per lane, predicated at the segment's end, so a short segment
// or a ragged tail costs one round trip and not one per 32 values), each
// lane keeping a running max that starts at INT64_MIN; a
// __shfl_xor_sync butterfly reduces the 32 partial maxima (64-bit shuffles);
// lane 0 writes the max, or 0 when the segment is empty.  Integer max is
// exact and order-free, so the result is bit-identical to numpy's.
//
// The call.  The engines hold their CSR in host numpy arrays and want a numpy
// result, a few thousand to ~24k values per solve.  The wrapper packs
// [ptr | vals] into one page-locked buffer and the kernel reads it there, in
// place, through the address phase_max_mapped_address reports for it (under
// unified addressing, page-locked memory is device-accessible at its host
// address), and writes out into a page-locked output buffer; phase_max_solve
// launches, records an event on the stream and waits for it: one launch and
// one wait per solve, no copy.  Over the host link a load takes microseconds,
// so what matters is round trips, not bytes: the pointer's, then one per 256
// values of the widest segment (the simulator's are at most ~512 wide), all
// warps at once.  phase_max_launch runs the same kernel on device-resident
// arrays.
//
// Bound on the H100: the kernel must read every value once and the pointer
// array once and write one int64 per segment, (8 nvals + 16 nseg) bytes at
// 3.35 TB/s.  At the simulator's sizes (a few thousand to ~24k values per
// call) that is a few nanoseconds to ~60 ns, far below the launch latency
// (several microseconds), which is what sets the floor of one call.  On the
// engines' route the same bytes cross the host link (PCIe Gen5 x16, 64 GB/s
// each way: 0.6-3 us at those sizes), still below its round trips' latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // segments per CTA
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 8;                // loads in flight per lane
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

  // rounds of UNROLL * 32 values, every load of a round issued before any
  // is used (predicated at the segment's end): a segment of up to 256
  // values costs one round trip to memory after the pointer's
  long long m = I64_MIN;
  for (long long i = lo + lane; i < hi; i += UNROLL * 32) {
    long long v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = i + u * 32 < hi ? __ldg(vals + i + u * 32) : I64_MIN;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) m = max64(m, v[u]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max64(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[seg] = hi > lo ? m : 0;
}

// Launches on `stream` of `device`, which is made current for the launch
// only; returns the cudaError_t of the launch.
cudaError_t launch(const void* vals, const void* ptr, void* out, long long nseg, long long nvals,
                   cudaStream_t stream, int device) {
  const long long blocks = (nseg + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  segment_max_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const long long*>(vals), static_cast<const long long*>(ptr),
      static_cast<long long*>(out), nseg, nvals);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return err;
}

}  // namespace

// vals (nvals,), ptr (nseg + 1,), out (nseg,): int64 device arrays.  Launches
// on `stream` of `device` and returns the cudaError_t of the launch (0 on
// success); does not wait.
extern "C" int phase_max_launch(const void* vals, const void* ptr, void* out, long long nseg,
                                long long nvals, void* stream, int device) {
  if (nseg <= 0) return 0;
  return (int)launch(vals, ptr, out, nseg, nvals, static_cast<cudaStream_t>(stream), device);
}

// The engines' solve: the same launch on arrays in page-locked host memory,
// at the addresses phase_max_mapped_address reports (vals and ptr packed in
// one buffer, out in another), then `event` recorded on `stream` and waited
// for, so out holds the result when this returns 0.  Returns the first
// cudaError_t of launch, record or wait.
extern "C" int phase_max_solve(const void* vals, const void* ptr, void* out, long long nseg,
                               long long nvals, void* stream, int device, void* event) {
  if (nseg <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaEvent_t e = static_cast<cudaEvent_t>(event);
  cudaError_t err = launch(vals, ptr, out, nseg, nvals, s, device);
  if (err == cudaSuccess) err = cudaEventRecord(e, s);
  if (err == cudaSuccess) err = cudaEventSynchronize(e);
  return (int)err;
}

// The address at which kernels reach the host memory at `host`: 0 and the
// address in *device_address when `host` lies in page-locked host memory the
// card can access, else a cudaError_t (cudaErrorInvalidValue for memory that
// is not page-locked or not mapped).
extern "C" int phase_max_mapped_address(const void* host, void** device_address) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, host);
  if (err != cudaSuccess) return (int)err;
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return (int)cudaErrorInvalidValue;
  *device_address = attr.devicePointer;
  return 0;
}
