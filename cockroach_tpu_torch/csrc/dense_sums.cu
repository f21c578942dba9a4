// Grouped exact int64 sums over a dense key space (K1).
//
// Replaces the TPU kernel cockroach_tpu/ops/pallas_kernels.py
// dense_limb_matmul_sums (driven by dense_sums_via_pallas). That kernel
// splits every int64 into eight byte limbs held as float32 so that the
// TPU's f32 matrix unit sums them exactly, then recombines the limbs with
// wrapping adds. None of that is needed here: Hopper adds 64-bit integers
// natively, so this kernel sums the int64 values themselves.
//
// Contract (the same as the TPU kernel's):
//   packed (N,) int32 group codes; a code outside [0, D) is a dead row and
//   counts nowhere. For each column c, values[c] is (N,) int64 or null
//   (null means the constant 1, so a row count reads no memory); live[c]
//   is (N,) bool or null (null means every row is live). out (K, D) int64
//   receives, for each column and lane, the sum of the live values whose
//   code is that lane. The caller zeroes out before the launch.
//
// Exactness: the adds are unsigned 64-bit, which wrap mod 2^64. That is
// two's-complement int64 wrap-around summation, and it does not depend on
// the order in which the atomics land, so the result is deterministic and
// bit-identical to the TPU kernel's limb recombination, with no row cap.
//
// Bound: memory. At Q1's shape (K = 6: a row count and five int64 sums, no
// live masks) a row moves 4 B of code and 5 x 8 B of values, 44 B/row; a
// 2^20-row chunk is 46 MB, about 14 us at 3.35 TB/s. The design reads each
// input byte once, coalesced, in a grid-stride loop over rows with about
// two blocks per SM; it keeps the K x D partial sums in shared memory, so
// the only writes to device memory are K x D atomics per block at the end.
// Known slow spot: Q1 has only four live groups, so the shared-memory
// atomics of a warp contend on a few addresses. Warp-aggregated atomics
// are the planned fix.

#include <cuda_runtime.h>

#define DS_MAX_COLS 32
#define DS_MAX_LANES 256
#define DS_THREADS 256

struct DenseCols {
  const long long* values[DS_MAX_COLS];
  const unsigned char* live[DS_MAX_COLS];
};

__global__ void __launch_bounds__(DS_THREADS)
dense_sums_kernel(const int* __restrict__ packed, long long n, DenseCols cols,
                  int k, int d, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long acc[];
  const int kd = k * d;
  for (int i = threadIdx.x; i < kd; i += blockDim.x) acc[i] = 0ull;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int code = packed[r];
    if (code < 0 || code >= d) continue;
    for (int c = 0; c < k; ++c) {
      const unsigned char* lv = cols.live[c];
      if (lv != nullptr && lv[r] == 0) continue;
      const long long* vp = cols.values[c];
      const unsigned long long v =
          vp != nullptr ? (unsigned long long)vp[r] : 1ull;
      atomicAdd(&acc[c * d + code], v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kd; i += blockDim.x) {
    const unsigned long long v = acc[i];
    if (v != 0ull) atomicAdd(&out[i], v);
  }
}

// values, live: host arrays of k device pointers (entries may be null).
// Columns go in groups of DS_MAX_COLS, one launch per group, all on
// `stream`. Returns 0, or the CUDA error of the first launch that failed.
extern "C" int dense_sums_launch(const void* packed, long long n,
                                 const void* values, const void* live, int k,
                                 int d, void* out, void* stream) {
  if (n < 0 || k <= 0 || d <= 0 || d > DS_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n + DS_THREADS - 1) / DS_THREADS;
  if (blocks > 2LL * sms) blocks = 2LL * sms;
  if (blocks < 1) blocks = 1;
  const void* const* vals = (const void* const*)values;
  const void* const* lives = (const void* const*)live;
  for (int c0 = 0; c0 < k; c0 += DS_MAX_COLS) {
    const int kk = (k - c0) < DS_MAX_COLS ? (k - c0) : DS_MAX_COLS;
    DenseCols cols;
    for (int c = 0; c < DS_MAX_COLS; ++c) {
      cols.values[c] = c < kk ? (const long long*)vals[c0 + c] : nullptr;
      cols.live[c] = c < kk ? (const unsigned char*)lives[c0 + c] : nullptr;
    }
    const size_t smem = (size_t)kk * d * sizeof(unsigned long long);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(dense_sums_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    dense_sums_kernel<<<(int)blocks, DS_THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)packed, n, cols, kk, d,
        (unsigned long long*)out + (size_t)c0 * d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
