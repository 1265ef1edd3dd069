// Row gather of several buffers in one launch, Hopper (sm_90a):
//   dst_j[i] = src_j[perm[i]]   for every buffer j and row i.
//
// Replaces the TPU kernel `_copy_kernel` of audio_transformers_tpu/ops/
// permute.py (`permute_rows_pallas`), beam search's per-step parent
// reorder of every per-beam buffer (self K/V, their int8 scales, the seen
// mask, the token rows).
//
// Bound on the H100: device-memory bytes. It is a pure copy (no
// arithmetic, bit exact for every dtype), so the least time is twice the
// bytes of the rows over the HBM bandwidth.
//
// Design. The Pallas kernel ran one grid step per row, with the
// scalar-prefetched `perm` feeding the input block's index map. Here each
// block owns one (row i, buffer j) pair, loads its own perm[i] and copies
// that row's bytes: threads stride over 16-byte words (uint4), four loads in
// flight per thread before their stores. A row whose source and destination
// share their offset modulo 16 is copied as a byte head up to the 16-byte
// boundary, the 16-byte body and a byte tail; any other row byte by byte
// (the test config's rows, e.g. a 37-byte bool row). The buffers ride in a
// fixed-size table of (src, dst, row_bytes) passed by value as a kernel
// parameter (1.5 KB, below the 4 KB limit); longer lists are split over
// several launches by the caller. Rows repeat in `perm` (branching
// parents), so the copy must be out of place: the caller guarantees that
// no destination overlaps a source, and that 0 <= perm[i] < rows.

#include <cuda_runtime.h>
#include <stdint.h>

#define K5_MAX_ENTRIES 64  // must match ops/permute.py
#define K5_THREADS 256

struct PermuteEntry {
  const unsigned char* src;
  unsigned char* dst;
  long long row_bytes;
};

struct PermuteTable {
  PermuteEntry e[K5_MAX_ENTRIES];
};

__device__ __forceinline__ void copy_bytes(const unsigned char* s,
                                           unsigned char* d, long long lo,
                                           long long hi) {
  for (long long t = lo + threadIdx.x; t < hi; t += blockDim.x) d[t] = s[t];
}

__global__ void __launch_bounds__(K5_THREADS)
permute_rows_kernel(const __grid_constant__ PermuteTable tab,
                    const long long* __restrict__ perm) {
  // __grid_constant__: the table is indexed by blockIdx.y and read in
  // place, not copied into each thread's local memory
  const long long i = blockIdx.x;
  const PermuteEntry en = tab.e[blockIdx.y];
  const long long n = en.row_bytes;
  const unsigned char* s = en.src + perm[i] * n;
  unsigned char* d = en.dst + i * n;

  if ((((uintptr_t)s ^ (uintptr_t)d) & 15) != 0) {
    copy_bytes(s, d, 0, n);
    return;
  }
  long long head = (16 - ((uintptr_t)s & 15)) & 15;
  if (head > n) head = n;
  copy_bytes(s, d, 0, head);
  const uint4* s4 = reinterpret_cast<const uint4*>(s + head);
  uint4* d4 = reinterpret_cast<uint4*>(d + head);
  const long long n4 = (n - head) >> 4;
  const long long step = blockDim.x;
  long long t = threadIdx.x;
  for (; t + 3 * step < n4; t += 4 * step) {
    const uint4 a = s4[t], b = s4[t + step], c = s4[t + 2 * step],
                e = s4[t + 3 * step];
    d4[t] = a;
    d4[t + step] = b;
    d4[t + 2 * step] = c;
    d4[t + 3 * step] = e;
  }
  for (; t < n4; t += step) d4[t] = s4[t];
  copy_bytes(s, d, head + (n4 << 4), n);
}

// srcs, dsts and row_bytes are host arrays of n entries (n <= 64); perm is
// a device array of `rows` int64 indices. Returns cudaGetLastError().
extern "C" int permute_rows(const void* const* srcs, void* const* dsts,
                            const long long* row_bytes, int n,
                            const void* perm, int rows, void* stream) {
  if (n < 0 || n > K5_MAX_ENTRIES || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || rows == 0) return 0;
  PermuteTable tab;
  for (int j = 0; j < n; ++j) {
    tab.e[j].src = static_cast<const unsigned char*>(srcs[j]);
    tab.e[j].dst = static_cast<unsigned char*>(dsts[j]);
    tab.e[j].row_bytes = row_bytes[j];
  }
  for (int j = n; j < K5_MAX_ENTRIES; ++j) tab.e[j] = PermuteEntry{};
  permute_rows_kernel<<<dim3(rows, n), K5_THREADS, 0,
                        (cudaStream_t)stream>>>(
      tab, static_cast<const long long*>(perm));
  return (int)cudaGetLastError();
}
