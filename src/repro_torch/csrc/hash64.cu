// xxHash64 placement hash with the modulo fused in: H_i and H_t (paper §3.4.1).
//
// Replaces the Pallas TPU kernel `xxh64` (src/repro/kernels/hash64/hash64.py,
// body `_kernel`, wrapper `ops.py::xxh64_mod`). The TPU version splits every
// 64-bit value into uint32 limbs and every 32x32 product into 16-bit digits,
// because the TPU's vector lanes are 32-bit. Hopper multiplies 64-bit
// integers natively, so one thread hashes one key in a chain of five 64-bit
// multiplies, rotates and xors, and reduces it mod n_edges in the same thread.
//
// The modulo, exact without a division. A runtime 64-bit `%` has no Hopper
// instruction: nvcc calls a 58-instruction subroutine (I2F, MUFU.RCP, wide
// multiplies and corrections). With n = n_edges in [1, 65535] known on the
// host, the wrapper passes m = ceil(2^64 / n) mod 2^64 and r = 2^32 mod n.
// For h = A 2^32 + B (A, B < 2^32) the kernel forms x = A r + B, congruent
// to h mod n and at most (2^32 - 1) n. Then x mod n = floor(((m x) mod 2^64)
// n / 2^64), Lemire's fastmod. Why it is exact: write x = q n + s with
// 0 <= s < n, so q < 2^32, and c = ceil(2^64 / n) = (2^64 + e) / n with
// 0 <= e < n. Then c x = q 2^64 + q e + s c, so c x mod 2^64 = q e + s c if
// that is below 2^64: q e < 2^32 n and s c <= 2^64 + e - (2^64 + e) / n,
// whose sum is below 2^64 because 2^32 n^2 + e n < 2^64 + e for n <= 65535.
// Times n over 2^64: (q e n + s (2^64 + e)) / 2^64 = s + (q e n + s e) / 2^64
// with q e n + s e < 2^32 n^2 + n^2 < 2^64, so the floor is s. For n = 1, c
// = 2^64 is 0 mod 2^64 and the result is 0, as it must be. The high half of
// the last product is written as two 32-bit products (n < 2^32: the low
// word's high product, then the high word's product plus it, whose high word
// is the floor). tests/test_torch_hashing.py replays this arithmetic for
// every n in [1, 65535] against h % n.
//
// What bounds it on this card: the launch and one load's latency, not bytes.
// A key reads 4 bytes in the H_t form (its high word is zero) and 8 in the
// H_i form and writes 4: 6,400 H_t keys are 51 KB, 0.015 µs at 3.35 TB/s,
// far below a launch. Compile-time probes at 6,400 keys (H100 80GB HBM3,
// 700 W; PERF.md §6): an empty kernel with this grid 0.83 µs, the loads
// and the store alone 1.08, the hash without the modulo 1.14, with this
// modulo 1.16, with `%` 1.31 (the first port of this kernel 1.36). Two or
// four keys a thread with 8- or 16-byte loads were slower (1.34; 1.40-1.59):
// a longer chain a thread costs more than the loads it saves. 128 threads a
// block read 0.005-0.04 µs below 256. Neighbouring threads take neighbouring
// keys, so loads and stores are coalesced at any 4-byte offset; there is
// nothing to share, so no shared memory.
//
// C entries: hash64_mod_launch(hi or NULL, lo, out, n, n_edges, m, r, stream)
// launches on `stream` and returns cudaGetLastError(); hash64_empty_launch(n,
// stream) launches an empty kernel on the same grid, a yardstick of the
// launch that no path of the port calls.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t P3 = 0x165667B19E3779F9ull;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ull;
constexpr int kThreads = 128;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t xxh64_word(uint64_t key) {
  uint64_t h = P5 + 8ull;                 // seed 0, 8-byte input
  uint64_t k1 = rotl64(key * P2, 31) * P1;
  h ^= k1;
  h = rotl64(h, 27) * P1 + P4;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// h mod n, given m = ceil(2^64 / n) mod 2^64 and r = 2^32 mod n (see above).
__device__ __forceinline__ uint32_t mod_n(uint64_t h, uint64_t m, uint32_t n,
                                          uint32_t r) {
  uint64_t x = (uint64_t)(uint32_t)(h >> 32) * r + (uint32_t)h;
  uint64_t y = m * x;
  uint64_t u = (uint64_t)(uint32_t)(y >> 32) * n + __umulhi((uint32_t)y, n);
  return (uint32_t)(u >> 32);
}

__global__ void __launch_bounds__(kThreads) hash64_mod_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
    int32_t* __restrict__ out, int n, uint32_t n_edges, uint64_t m,
    uint32_t r) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint64_t h32 = hi == nullptr ? 0ull : (uint64_t)(uint32_t)hi[i];
  uint64_t key = (h32 << 32) | (uint32_t)lo[i];
  out[i] = (int32_t)mod_n(xxh64_word(key), m, n_edges, r);
}

__global__ void hash64_empty_kernel() {}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int hash64_mod_launch(const void* hi, const void* lo, void* out,
                                 int n, unsigned n_edges,
                                 unsigned long long m, unsigned r,
                                 void* stream) {
  hash64_mod_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hi, (const int32_t*)lo, (int32_t*)out, n, n_edges, m, r);
  return (int)cudaGetLastError();
}

extern "C" int hash64_empty_launch(int n, void* stream) {
  hash64_empty_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
