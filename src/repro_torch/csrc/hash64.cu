// xxHash64 placement hash with the modulo fused in: H_i and H_t (paper §3.4.1).
//
// Replaces the Pallas TPU kernel `xxh64` (src/repro/kernels/hash64/hash64.py,
// body `_kernel`, wrapper `ops.py::xxh64_mod`). The TPU version splits every
// 64-bit value into uint32 limbs and every 32x32 product into 16-bit digits,
// because the TPU's vector lanes are 32-bit. Hopper has native 64-bit integer
// multiply, shift and rotate, so each thread hashes one key in a handful of
// instructions and reduces it mod n_edges in the same thread: h % n on the
// 64-bit value equals the reference's limb reduction `mod_u64` exactly.
//
// Bound: bytes. A key reads 8 bytes (4 for the H_t form, whose high word is
// zero) and writes a 4-byte edge id; the ~20 integer operations a key costs
// are far below what the card issues in the time those bytes take. One thread
// per key with neighbouring threads on neighbouring keys keeps every load and
// store coalesced; there is nothing to share, so no shared memory.
//
// C entry: hash64_mod_launch(hi or NULL, lo, out, n, n_edges, stream) launches
// on `stream` and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t P3 = 0x165667B19E3779F9ull;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ull;

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

__global__ void hash64_mod_kernel(const int32_t* __restrict__ hi,
                                  const int32_t* __restrict__ lo,
                                  int32_t* __restrict__ out, int n,
                                  unsigned n_edges) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t h32 = hi == nullptr ? 0ull : (uint64_t)(uint32_t)hi[i];
  uint64_t key = (h32 << 32) | (uint64_t)(uint32_t)lo[i];
  out[i] = (int32_t)(xxh64_word(key) % (uint64_t)n_edges);
}

}  // namespace

extern "C" int hash64_mod_launch(const void* hi, const void* lo, void* out,
                                 int n, int n_edges, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  hash64_mod_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hi, (const int32_t*)lo, (int32_t*)out, n,
      (unsigned)n_edges);
  return (int)cudaGetLastError();
}
