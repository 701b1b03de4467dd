// FlashAttention-2 backward for Hopper (sm_90a): bf16, head dims (q/k, v)
// of (128, 128) and (192, 128).
//
// Replaces no Pallas kernel. The JAX package has no Pallas backward: it
// takes the attention gradient by autodiff of its jnp chunked path
// (src/repro/models/attention.py:52). On the card the gradient of the
// port's forward kernels is a hand-written kernel, called from
// `FlashAttentionFn.backward` through `flash_attention_bwd_cuda`
// (kernels/flash_attention/ops.py), which sends here every bf16 call with
// (d_qk, d_v) = (128, 128) (internlm2-1.8b's training calls) or (192, 128)
// (deepseek-v2-236b's: MLA's q/k of nope 128 + rope 64 and v 128) and at
// least 64 query rows and 64 keys; csrc/flash_attention_bwd.cu keeps every
// other shape (fp32, d 32, 64 and 160, (48, 32), shorter calls). It
// computes what `ref.py::flash_attention_bwd_ref` computes:
//   LSE = logsumexp over the keys a row may see of s = (q . k^T) * d_qk^-0.5,
//   D = rowsum(dO * O) in fp32, with O as the forward stored it,
//   P = exp(s - LSE), dV = P^T dO, dP = dO V^T, dS = P * (dP - D),
//   dQ = scale * dS K, dK = scale * dS^T Q,
// dK and dV summed over the GQA group's query heads (head h reads kv head
// h / (H / KV)), masked keys (causal, q_offset + row < key) contributing 0.
// P and dS are rounded to bf16 before the products that take them.
//
// Bound: the operations. The gradient's five products of size Sq x Skv
// (S, dQ and dK over d_qk, dP and dV over d_v) are 2.5 x the forward's two
// at equal dims; at the training shape (B 4, S 4096, H 16 over 8, d 128,
// causal) 6.87e11 FLOP = 0.695 ms at the H100's 989 TFLOP/s bf16 peak,
// against 0.14 GB of q, k, v, o, dO and the three gradients; at
// deepseek-v2-236b's (B 1, S 4096, H 128 over 128, (192, 128), causal)
// 1.787e12 FLOP = 1.807 ms. This design does seven products (S and dP are
// formed once in each launch: 4 over d_qk, 3 over d_v), all on the tensor
// cores at the warpgroup rate:
// - two launches, one block per output tile, so nothing is summed across
//   blocks: no atomics, and two runs give the same bits;
// - every product is a warpgroup MMA (wgmma.mma_async, fp32 accumulators)
//   on operands that arrive by TMA (cp.async.bulk.tensor, 128B swizzle,
//   zero fill past Sq and Skv) in 64-column slabs, as in
//   flash_attention_sm90.cu: a product over a head dim reads both operands
//   K-major from shared memory; a product over keys or query rows takes its
//   A from registers (an accumulator rounded to bf16 pairs is already the A
//   fragment) and its B MN-major (transpose bit), so no thread transposes
//   anything;
// - streamed tiles go through a ring of "full" and "empty" mbarriers; one
//   thread keeps the tiles two ahead of the one computed in flight, so a
//   load has a tile's products to land in.
//
// 1. dq: one block per (b * H + h, 128 query rows), two warpgroups of 64
//    rows. Q and dO arrive once; each thread forms D for its two rows from
//    dO and O in global memory while they land. 64-key K and V tiles
//    stream through the ring. S = Q K^T and dP = dO V^T (both operands in
//    shared memory), then dQ' += exp(s - m) (dP - D) K with K as an
//    MN-major B: the running max m and sum l of the forward's online
//    softmax, dQ' rescaled when m moves, so no separate walk forms LSE
//    first (D is known before the walk starts, which is what makes this
//    work). dQ = scale * dQ' / l. The block writes LSE (log2 units, m +
//    log2 l) and D for all its 128 rows into scratch rows padded to 128.
//    Causal blocks stop at the tile holding key q_offset + their last row
//    and run longest first; a warpgroup skips tiles wholly past its rows.
// 2. dkdv: one block per (b * KV + kv head, 128 keys), two warpgroups of
//    64 keys, each holding its dK and dV accumulators over the whole walk.
//    K and V arrive once; the block walks the group's query heads and, for
//    each, the query tiles (QT rows: 64, or 32 at (192, 128)) that can see
//    its keys (causal: from the tile holding row k0 - q_offset), Q and dO
//    tiles streaming through the ring with their rows' LSE and D beside
//    them (cp.async.bulk). S^T = K Q^T and dP^T = V dO^T (both in shared
//    memory), P^T = exp2(s^T - LSE), dS^T = P^T (dP^T - D), then dV +=
//    P^T dO and dK += dS^T Q with dO and Q as MN-major Bs. Blocks of the
//    first keys (the most query tiles under a causal mask) run first; a
//    warpgroup skips tiles wholly before its keys; keys no row sees get
//    zeros. dK (times scale) and dV are written once.
//
// Instances: templated on <DK, DV> (`Layout`), as the forward in
// flash_attention_sm90.cu. Q and K are DK / 64 slabs a row, V and dO
// DV / 64. Both launches hold a pair of 128-row operands, one DK and one
// DV wide (Q and dO; K and V), and stream pairs of tiles likewise (64-key
// K and V; QT-row Q and dO). S and S^T contract over DK (DK / 16
// k-steps), dP and dP^T over DV; dQ += dS K and dK += dS^T Q are m64n(DK)
// products, dV += P^T dO m64n(DV). One block an SM in both.
// - (128, 128): 64 KB held + four 32 KB stages = 192 KB; QT 64; the dkdv
//   accumulators 64 + 64 fp32 registers a thread.
// - (192, 128): 80 KB held + three 40 KB stages = 200 KB (four would be
//   240 KB, past the 227 KB a block may take). dQ and dK are m64n192 (96
//   registers a thread), so the dkdv block holds dK 96 + dV 64 over its
//   walk. With 64-row query tiles S^T and dP^T add 32 + 32: ptxas (CUDA
//   12.8, sm_90a) gave that dkdv 255 registers and 8 bytes of spills. So
//   QT is 32 there: S^T and dP^T are m64n32 (16 + 16), dV and dK take two
//   k-steps a tile, and the dkdv launch needs 220 registers, no spills
//   (dq: 193, no spills; at (128, 128) dq 157 and dkdv 228, as before).
//
// Not done yet: warp-specialised producers with setmaxnreg; persistent
// blocks; a TMA-store epilogue; overlap of one tile's products with the
// previous tile's elementwise work inside a warpgroup; head dim 160.
// The mbarrier, TMA and wgmma helpers repeat flash_attention_sm90.cu's;
// that source is left as it is, so the forward keeps the bits it is held
// to.
//
// C entry: flash_attention_bwd_sm90_launch(q, k, v, o, dout, dq, dk, dv,
// lse, dsum, geo, causal, q_offset, sq_pad, scale, stream). `geo` holds 43
// host int64: for each of q, k, v and dout the tensor map's dims (d, seq,
// heads, batch) and byte strides (seq, heads, batch), then the element
// strides (batch, seq, head) of o, dout, dq, dk and dv. The head dims are
// read from it: q's and k's (geo[0], geo[7]) must agree, as v's and dout's
// (geo[14], geo[21]). `lse` and `dsum` are fp32 scratch of B * H * sq_pad,
// sq_pad = Sq rounded up to 128. Launches on `stream` and returns
// cudaGetLastError() (10000 + the CUresult of a failed
// cuTensorMapEncodeTiled; cudaErrorInvalidValue for head dims other than
// (128, 128) and (192, 128) or a shorter sq_pad).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLAB = 64;                  // bf16 columns in one 128-byte swizzled row
constexpr int THREADS = 256;              // two warpgroups
constexpr int BLOCK_ROWS = 128;           // dq: query rows a block; dkdv: keys a block
constexpr int TILE = 64;                  // dq: keys a streamed tile
constexpr int AHEAD = 2;                  // tiles in flight ahead of the one computed
constexpr uint32_t ROW_BYTES = 128;       // one slab row
constexpr uint32_t ATOM_BYTES = 8 * ROW_BYTES;       // 8 rows: one swizzle atom
constexpr uint32_t SLAB_BIG = BLOCK_ROWS * ROW_BYTES;  // 16 KB
constexpr uint32_t SLAB_TILE = TILE * ROW_BYTES;       // 8 KB
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ENCODE_ERROR = 10000;
constexpr long long WAIT_LIMIT_CYCLES = 1ll << 34;

// The layout of one pair of head dims, q and k's DK and v and dO's DV:
// slabs a row of each, stages of the ring, the dkdv launch's query rows a
// streamed tile, and the shared memory a block takes (the held pair, then
// the ring; a stage holds a DK-wide tile, then a DV-wide one).
template <int DK, int DV>
struct Layout {
  static_assert((DK == 128 || DK == 192) && DV == 128, "head dims (128, 128) and (192, 128)");
  static constexpr int K_SLABS = DK / SLAB;                          // Q and K: 2 or 3
  static constexpr int V_SLABS = DV / SLAB;                          // V and dO: 2
  static constexpr int STAGES = DK == 128 ? 4 : 3;
  static constexpr int QT = DK == 128 ? 64 : 32;                     // dkdv: query rows a tile
  static constexpr uint32_t STATS_BYTES = 2 * QT * sizeof(float);    // LSE and D of a tile's rows
  static constexpr uint32_t HELD_BYTES = (K_SLABS + V_SLABS) * SLAB_BIG;    // 64 or 80 KB
  static constexpr uint32_t STAGE_BYTES = (K_SLABS + V_SLABS) * SLAB_TILE;  // 32 or 40 KB
  static constexpr size_t SMEM_BYTES = HELD_BYTES + STAGES * STAGE_BYTES + 1024;  // + alignment
};

static_assert(AHEAD < Layout<192, 128>::STAGES, "a stage is refilled only after its tile is done");
template <typename L>
constexpr size_t block_smem() { return L::SMEM_BYTES + L::STAGES * L::STATS_BYTES; }
static_assert(block_smem<Layout<128, 128>>() <= 232448 && block_smem<Layout<192, 128>>() <= 232448,
              "a block takes at most 227 KB of shared memory");

struct Geo {
  int H, KVH, Sq, Skv, causal, q_offset, sq_pad;
  long long os[3], dos[3], dqs[3], dks[3], dvs[3];   // element strides (batch, seq, head)
  float scale, scale_log2;                           // d_qk^-0.5, and times log2(e)
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* lse;                             // (B * H, sq_pad): m + log2(l), log2 units
  float* dsum;                            // (B * H, sq_pad): D = rowsum(dO * O)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// wait that cannot end (a lost transaction) traps after about ten seconds
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
  }
}

// One box {64 columns, rows, 1, 1} of a 4-D map at coordinates
// (column, row, head, batch), completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes from global memory, 16-byte
// aligned at both ends, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// --- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, 128B swizzle: start address, leading and
// stride byte offsets (16-byte units), layout type 1 in bits 62-63. Every
// operand base here is 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving register reads or writes across a wgmma
// issue or wait (the hardware reads and writes these registers
// asynchronously in between).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define WG_D16                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                               \
  "%8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                               \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                          \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                        \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_D64                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                               \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                          \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                        \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                        \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                        \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                        \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                        \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_D96                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                               \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                          \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                        \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                        \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                        \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                        \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                        \
  "%56, %57, %58, %59, %60, %61, %62, %63, "                        \
  "%64, %65, %66, %67, %68, %69, %70, %71, "                        \
  "%72, %73, %74, %75, %76, %77, %78, %79, "                        \
  "%80, %81, %82, %83, %84, %85, %86, %87, "                        \
  "%88, %89, %90, %91, %92, %93, %94, %95}"
#define WG_OUT16(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_OUT32(d)                                                           \
  WG_OUT16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),            \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),            \
  "+f"(d[30]), "+f"(d[31])
#define WG_OUT64(d)                                                           \
  WG_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),           \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),            \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),            \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),            \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),            \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),            \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WG_OUT96(d)                                                           \
  WG_OUT64(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),           \
  "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),            \
  "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),            \
  "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]),            \
  "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),            \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]),            \
  "+f"(d[93]), "+f"(d[94]), "+f"(d[95])

// d (64 x N) = [d +] A B, A and B both from shared memory, both K-major;
// N = 64 (32 fp32 a thread) or 32 (16), chosen by the accumulator's size.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
      ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) += A B, A (64 x 16) from registers, B from shared memory,
// MN-major (transpose bit set); N = 128 (64 fp32 a thread) or 192 (96),
// chosen by the accumulator's size.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : WG_OUT64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " WG_D96
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : WG_OUT96(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// acc (64 x N) = A B^T over KSTEPS k-steps of 16 columns: A 64 rows at `a`
// (slab i at + i * a_slab), B N rows at `b` (slab i at + i * b_slab), both
// K-major (the head dim contiguous): a k-step 32 bytes inside a slab's
// rows, 8-row atoms 1024 bytes apart (SBO). Issued only: the caller
// fences, commits and waits.
template <int KSTEPS, int N2>
__device__ __forceinline__ void ss_product(float (&acc)[N2], uint32_t a, uint32_t a_slab,
                                           uint32_t b, uint32_t b_slab) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(acc, sw128_desc(a + (kk / 4) * a_slab + col, 16, ATOM_BYTES),
             sw128_desc(b + (kk / 4) * b_slab + col, 16, ATOM_BYTES), kk > 0);
  }
}

// acc (64 x N) += A (64 x 16 KSTEPS, bf16 pairs in registers: a[4kk ..
// 4kk+3] the fragment of k-step kk) B, B a streamed tile whose rows are the
// k dimension and whose N columns are contiguous: MN-major, a k-step two
// 8-row atoms (SBO 1024 bytes apart), each further 64 columns the next
// slab (LBO b_slab). Issued only.
template <int KSTEPS, int N2>
__device__ __forceinline__ void rs_product(float (&acc)[N2], const uint32_t (&a)[4 * KSTEPS],
                                           uint32_t b, uint32_t b_slab) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    wgmma_rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
             sw128_desc(b + kk * 2 * ATOM_BYTES, b_slab, ATOM_BYTES));
  }
}

// Two floats rounded to bf16; the lower column goes to the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator element i of a thread (lane l of warp w in the warpgroup)
// sits at row 16w + l/4 + 8*((i >> 1) & 1), column 8*(i >> 2) + 2*(l % 4)
// + (i & 1): the mma.m16n8 layout repeated over N/8 eight-column chunks.
// Packing elements (2j, 2j+1) into a[j] makes a[4kk .. 4kk+3] the A
// fragment of the 16 columns of k-step kk.

// The two 128-row operands of a block (the DK-wide one's slabs, then the
// DV-wide one's) on one barrier.
template <typename L>
__device__ __forceinline__ void load_held(const CUtensorMap* m0, const CUtensorMap* m1,
                                          uint32_t dst, uint32_t bar, int row, int head,
                                          int batch) {
  mbar_expect_tx(bar, L::HELD_BYTES);
#pragma unroll
  for (int sl = 0; sl < L::K_SLABS; ++sl)
    tma_load(dst + sl * SLAB_BIG, m0, bar, sl * SLAB, row, head, batch);
#pragma unroll
  for (int sl = 0; sl < L::V_SLABS; ++sl)
    tma_load(dst + (L::K_SLABS + sl) * SLAB_BIG, m1, bar, sl * SLAB, row, head, batch);
}

// Streamed tile t (rows `row` ... row + ROWS - 1 of a DK-wide and a
// DV-wide operand, slabs ROWS * 128 bytes apart) into ring stage t %
// STAGES, completing on the stage's "full" barrier, which also expects
// `extra` bytes the caller copies in after this returns. Returns the
// barrier.
template <typename L, int ROWS>
__device__ __forceinline__ uint32_t load_tile(const CUtensorMap* m0, const CUtensorMap* m1,
                                              uint32_t ring, uint32_t full0, int t, int row,
                                              int head, int batch, uint32_t extra = 0) {
  constexpr uint32_t SLAB_ROWS = ROWS * ROW_BYTES;
  const int s = t % L::STAGES;
  const uint32_t dst = ring + s * L::STAGE_BYTES, bar = full0 + 8 * s;
  mbar_expect_tx(bar, (L::K_SLABS + L::V_SLABS) * SLAB_ROWS + extra);
#pragma unroll
  for (int sl = 0; sl < L::K_SLABS; ++sl)
    tma_load(dst + sl * SLAB_ROWS, m0, bar, sl * SLAB, row, head, batch);
#pragma unroll
  for (int sl = 0; sl < L::V_SLABS; ++sl)
    tma_load(dst + (L::K_SLABS + sl) * SLAB_ROWS, m1, bar, sl * SLAB, row, head, batch);
  return bar;
}

template <int STAGES>
__device__ __forceinline__ void init_barriers(uint32_t held_bar, uint32_t full0,
                                              uint32_t empty0) {
  mbar_init(held_bar, 1);
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(full0 + 8 * s, 1);
    mbar_init(empty0 + 8 * s, THREADS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Before computing tile j, thread 0 refills the stage of tile j + AHEAD
// once every thread is done with the tile that used it last.
template <int STAGES>
__device__ __forceinline__ bool refill(int j, int n_tiles, uint32_t empty0) {
  const int t = j + AHEAD;
  if (t >= n_tiles) return false;
  if (t >= STAGES) mbar_wait(empty0 + 8 * (t % STAGES), (t / STAGES - 1) & 1);
  return true;
}

// One thread's two accumulator rows (64 x N layout) written as bf16, each
// row times its factor; rows at or past `n` are not written.
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long row_stride,
                                           int row0, int n, int t4, const float (&acc)[N / 2],
                                           const float (&f)[2]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (row >= n) continue;
    __nv_bfloat16* orow = out + (long long)row * row_stride + 2 * t4;
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      *reinterpret_cast<uint32_t*>(orow + 8 * c) =
          pack_bf16(acc[4 * c + 2 * hr] * f[hr], acc[4 * c + 2 * hr + 1] * f[hr]);
    }
  }
}

// --- 1. dq -------------------------------------------------------------------

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap domap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const Geo g) {
  using L = Layout<DK, DV>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * L::STAGES];   // held, full[], empty[]
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + L::K_SLABS * SLAB_BIG, ring = base + L::HELD_BYTES;
  const uint32_t held_bar = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]), empty0 = smem_u32(&bars[1 + L::STAGES]);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int t4 = lane & 3;
  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int kvh = h / (g.H / g.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_ROWS;   // longest causal rows first
  const int end = g.causal ? min(g.Skv, g.q_offset + min(q0 + BLOCK_ROWS, g.Sq)) : g.Skv;
  const int n_tiles = (end + TILE - 1) / TILE;

  if (tid == 0) init_barriers<L::STAGES>(held_bar, full0, empty0);
  __syncthreads();
  if (tid == 0) {
    load_held<L>(&qmap, &domap, q_s, held_bar, q0, h, b);
    for (int t = 0; t < AHEAD && t < n_tiles; ++t)
      load_tile<L, TILE>(&kmap, &vmap, ring, full0, t, t * TILE, kvh, b);
  }

  // D = rowsum(dO * O) in fp32 for this thread's rows row0 and row0 + 8:
  // the quad's four threads take DV / 4 columns each, from global memory.
  const int row0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
  float dsum[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    float part = 0.f;
    if (row < g.Sq) {
      const __nv_bfloat16* orow =
          g.o + b * g.os[0] + row * g.os[1] + h * g.os[2] + (DV / 4) * t4;
      const __nv_bfloat16* drow =
          g.dout + b * g.dos[0] + row * g.dos[1] + h * g.dos[2] + (DV / 4) * t4;
#pragma unroll
      for (int c = 0; c < DV / 32; ++c) {
        const uint4 x = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 y = *reinterpret_cast<const uint4*>(drow + 8 * c);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(xp[e]), yf = __bfloat1622float2(yp[e]);
          part = fmaf(xf.x, yf.x, part);
          part = fmaf(xf.y, yf.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dsum[hr] = part;
  }

  const int pos0 = g.q_offset + row0;
  const int wg_first = g.q_offset + q0 + 64 * wg;            // positions of the
  const int wg_last = wg_first + 63;                          // warpgroup's rows
  const uint32_t q_wg = q_s + 64 * wg * ROW_BYTES, do_wg = do_s + 64 * wg * ROW_BYTES;

  float acc[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  mbar_wait(held_bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::STAGES;
    if (tid == 0 && refill<L::STAGES>(j, n_tiles, empty0))
      load_tile<L, TILE>(&kmap, &vmap, ring, full0, j + AHEAD, (j + AHEAD) * TILE, kvh, b);
    __syncwarp();
    mbar_wait(full0 + 8 * s, (j / L::STAGES) & 1);
    const int kv0 = j * TILE;
    const uint32_t k_s = ring + s * L::STAGE_BYTES, v_s = k_s + L::K_SLABS * SLAB_TILE;
    // A tile past the warpgroup's last causal row would add exactly 0.
    if (!g.causal || kv0 <= wg_last) {
      float sc[32], dp[32];
      fence_regs(sc);
      fence_regs(dp);
      wg_fence();
      ss_product<DK / 16>(sc, q_wg, SLAB_BIG, k_s, SLAB_TILE);
      ss_product<DV / 16>(dp, do_wg, SLAB_BIG, v_s, SLAB_TILE);
      wg_commit();
      wg_wait0();
      fence_regs(sc);
      fence_regs(dp);

      // Mask only tiles that cross the diagonal or the Skv edge; the row
      // max on the raw scores, m in log2 units (as the forward).
      const bool edge = kv0 + TILE > g.Skv || (g.causal && kv0 + TILE - 1 > wg_first);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (edge) {
          const int col = kv0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (col >= g.Skv || (g.causal && pos0 + 8 * ((i >> 1) & 1) < col)) sc[i] = NEG_INF;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float m_new = fmaxf(m[hr], mx[hr] * g.scale_log2);
        corr[hr] = exp2f(m[hr] - m_new);
        m[hr] = m_new;
      }
      // dS' = exp2(s - m) (dP - D) as bf16 pairs: the A fragment of dQ' +=
      // dS' K; a masked entry's exp2 is 0.
      uint32_t ds[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int hr = (i >> 1) & 1;
        const float p0 = exp2f(fmaf(sc[i], g.scale_log2, -m[hr]));
        const float p1 = exp2f(fmaf(sc[i + 1], g.scale_log2, -m[hr]));
        rs[hr] += p0 + p1;
        ds[i >> 1] = pack_bf16(p0 * (dp[i] - dsum[hr]), p1 * (dp[i + 1] - dsum[hr]));
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
        rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
        l[hr] = l[hr] * corr[hr] + rs[hr];
      }
#pragma unroll
      for (int i = 0; i < DK / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      fence_regs(acc);
      fence_regs(ds);
      wg_fence();
      rs_product<TILE / 16>(acc, ds, k_s, SLAB_TILE);
      wg_commit();
      wg_wait0();
      fence_regs(acc);
      fence_regs(ds);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  // LSE and D of every row of the block (the scratch rows are padded to
  // 128, so the dkdv launch reads whole tiles), then dQ = scale * dQ' / l.
  float f[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (t4 == 0) {
      g.lse[(long long)bh * g.sq_pad + row] = m[hr] + log2f(l[hr]);
      g.dsum[(long long)bh * g.sq_pad + row] = row < g.Sq ? dsum[hr] : 0.f;
    }
    f[hr] = g.scale / l[hr];
  }
  store_rows<DK>(g.dq + b * g.dqs[0] + h * g.dqs[2], g.dqs[1], row0, g.Sq, t4, acc, f);
}

// --- 2. dk and dv ------------------------------------------------------------

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap domap, const Geo g) {
  using L = Layout<DK, DV>;
  constexpr int QT = L::QT;
  constexpr uint32_t SLAB_QT = QT * ROW_BYTES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * L::STAGES];   // held, full[], empty[]
  __shared__ __align__(16) float stats[L::STAGES][2][QT];    // LSE and D of a tile's rows
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + L::K_SLABS * SLAB_BIG, ring = base + L::HELD_BYTES;
  const uint32_t held_bar = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]), empty0 = smem_u32(&bars[1 + L::STAGES]);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int t4 = lane & 3;
  const int b = blockIdx.x / g.KVH, kvh = blockIdx.x % g.KVH;
  const int group = g.H / g.KVH;
  const int k0 = blockIdx.y * BLOCK_ROWS;                    // first keys first
  // Query tiles a head: causal, from the one holding row k0 - q_offset.
  const int qt0 = g.causal ? max(0, k0 - g.q_offset) / QT : 0;
  const int per_head = max(0, (g.Sq + QT - 1) / QT - qt0);
  const int n_tiles = group * per_head;

  // Tile t: Q and dO rows of head gi = t / per_head, with the rows' LSE
  // and D from the scratch rows into `stats`.
  auto load = [&](int t) {
    const int h = kvh * group + t / per_head, row = (qt0 + t % per_head) * QT;
    const long long at = ((long long)b * g.H + h) * g.sq_pad + row;
    const uint32_t bar =
        load_tile<L, QT>(&qmap, &domap, ring, full0, t, row, h, b, L::STATS_BYTES);
    const uint32_t dst = smem_u32(&stats[t % L::STAGES][0][0]);
    bulk_load(dst, g.lse + at, L::STATS_BYTES / 2, bar);
    bulk_load(dst + L::STATS_BYTES / 2, g.dsum + at, L::STATS_BYTES / 2, bar);
  };
  if (tid == 0) init_barriers<L::STAGES>(held_bar, full0, empty0);
  __syncthreads();
  if (tid == 0) {
    load_held<L>(&kmap, &vmap, k_s, held_bar, k0, kvh, b);
    for (int t = 0; t < AHEAD && t < n_tiles; ++t) load(t);
  }

  const int kw = k0 + 64 * wg;                                 // the warpgroup's keys
  const int key0 = kw + 16 * warp + (lane >> 2);               // this thread's: key0, key0 + 8
  const uint32_t k_wg = k_s + 64 * wg * ROW_BYTES, v_wg = v_s + 64 * wg * ROW_BYTES;
  float dk[DK / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
  mbar_wait(held_bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::STAGES;
    if (tid == 0 && refill<L::STAGES>(j, n_tiles, empty0)) load(j + AHEAD);
    __syncwarp();
    mbar_wait(full0 + 8 * s, (j / L::STAGES) & 1);
    const int r0 = (qt0 + j % per_head) * QT;                   // the tile's first row
    const int pos_first = g.q_offset + r0;
    const uint32_t q_t = ring + s * L::STAGE_BYTES, do_t = q_t + L::K_SLABS * SLAB_QT;
    // A tile whose last row comes before the warpgroup's first key adds 0.
    if (!g.causal || pos_first + QT - 1 >= kw) {
      float st[QT / 2], dpt[QT / 2];
      fence_regs(st);
      fence_regs(dpt);
      wg_fence();
      ss_product<DK / 16>(st, k_wg, SLAB_BIG, q_t, SLAB_QT);
      ss_product<DV / 16>(dpt, v_wg, SLAB_BIG, do_t, SLAB_QT);
      wg_commit();
      wg_wait0();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T as bf16 pairs; element i is key key0 + 8*((i >> 1) & 1),
      // tile row c = 8*(i >> 2) + 2*t4 + (i & 1). Mask only tiles that
      // cross the diagonal or the Sq edge (select, not multiply: an
      // exponent past a masked entry may be inf).
      const bool edge = r0 + QT > g.Sq || (g.causal && pos_first < kw + 63);
      const float* lse = stats[s][0];
      const float* dd = stats[s][1];
      uint32_t pf[QT / 4], dsf[QT / 4];
#pragma unroll
      for (int i = 0; i < QT / 2; i += 2) {
        const int c = 8 * (i >> 2) + 2 * t4;
        const float2 lv = *reinterpret_cast<const float2*>(lse + c);
        const float2 dv2 = *reinterpret_cast<const float2*>(dd + c);
        float p0 = exp2f(fmaf(st[i], g.scale_log2, -lv.x));
        float p1 = exp2f(fmaf(st[i + 1], g.scale_log2, -lv.y));
        if (edge) {
          const int key = key0 + 8 * ((i >> 1) & 1);
          if (r0 + c >= g.Sq || (g.causal && pos_first + c < key)) p0 = 0.f;
          if (r0 + c + 1 >= g.Sq || (g.causal && pos_first + c + 1 < key)) p1 = 0.f;
        }
        pf[i >> 1] = pack_bf16(p0, p1);
        dsf[i >> 1] = pack_bf16(p0 * (dpt[i] - dv2.x), p1 * (dpt[i + 1] - dv2.y));
      }
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(dsf);
      wg_fence();
      rs_product<QT / 16>(dv, pf, do_t, SLAB_QT);
      rs_product<QT / 16>(dk, dsf, q_t, SLAB_QT);
      wg_commit();
      wg_wait0();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(dsf);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  const float fk[2] = {g.scale, g.scale}, fv[2] = {1.f, 1.f};
  store_rows<DK>(g.dk + b * g.dks[0] + kvh * g.dks[2], g.dks[1], key0, g.Skv, t4, dk, fk);
  store_rows<DV>(g.dv + b * g.dvs[0] + kvh * g.dvs[2], g.dvs[1], key0, g.Skv, t4, dv, fv);
}

// --- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime's entry-point
// query, so the library needs no -lcuda.
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D bf16 map over (d, seq, heads, batch) with byte strides (seq, heads,
// batch) from `g` (7 values), boxes of {64, rows, 1, 1}, 128B swizzle, zero
// fill out of bounds (past Sq and Skv).
int encode_map(CUtensorMap* map, const void* ptr, const long long* g, int rows) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1], (cuuint64_t)g[2],
                              (cuuint64_t)g[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5], (cuuint64_t)g[6]};
  const cuuint32_t box[4] = {(cuuint32_t)SLAB, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                        dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

template <typename Kernel>
int opt_in_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

// Both launches of the <DK, DV> instance.
template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* dsum, const long long* geo,
           int causal, int q_offset, int sq_pad, float scale, cudaStream_t st) {
  using L = Layout<DK, DV>;
  CUtensorMap qm, dom, km, vm;           // dq launch: 128-row q, dO; 64-row k, v
  CUtensorMap qt, dot, kb, vb;           // dkdv launch: QT-row q, dO; 128-row k, v
  int err = encode_map(&qm, q, geo, BLOCK_ROWS);
  if (err == 0) err = encode_map(&dom, dout, geo + 21, BLOCK_ROWS);
  if (err == 0) err = encode_map(&km, k, geo + 7, TILE);
  if (err == 0) err = encode_map(&vm, v, geo + 14, TILE);
  if (err == 0) err = encode_map(&qt, q, geo, L::QT);
  if (err == 0) err = encode_map(&dot, dout, geo + 21, L::QT);
  if (err == 0) err = encode_map(&kb, k, geo + 7, BLOCK_ROWS);
  if (err == 0) err = encode_map(&vb, v, geo + 14, BLOCK_ROWS);
  if (err != 0) return err;
  static bool dq_set = false, kv_set = false;   // one pair for each instance
  err = opt_in_smem(flash_bwd_dq_sm90<DK, DV>, L::SMEM_BYTES, dq_set);
  if (err == 0) err = opt_in_smem(flash_bwd_dkdv_sm90<DK, DV>, L::SMEM_BYTES, kv_set);
  if (err != 0) return err;

  Geo g;
  g.Sq = (int)geo[1];
  g.H = (int)geo[2];
  g.Skv = (int)geo[8];
  g.KVH = (int)geo[9];
  g.causal = causal;
  g.q_offset = q_offset;
  g.sq_pad = sq_pad;
  for (int i = 0; i < 3; ++i) {
    g.os[i] = geo[28 + i];
    g.dos[i] = geo[31 + i];
    g.dqs[i] = geo[34 + i];
    g.dks[i] = geo[37 + i];
    g.dvs[i] = geo[40 + i];
  }
  g.scale = scale;
  g.scale_log2 = scale * LOG2E;
  g.o = static_cast<const __nv_bfloat16*>(o);
  g.dout = static_cast<const __nv_bfloat16*>(dout);
  g.dq = static_cast<__nv_bfloat16*>(dq);
  g.dk = static_cast<__nv_bfloat16*>(dk);
  g.dv = static_cast<__nv_bfloat16*>(dv);
  g.lse = lse;
  g.dsum = dsum;
  const unsigned batch = (unsigned)geo[3];
  flash_bwd_dq_sm90<DK, DV><<<dim3(batch * g.H, (g.Sq + BLOCK_ROWS - 1) / BLOCK_ROWS),
                              THREADS, L::SMEM_BYTES, st>>>(qm, dom, km, vm, g);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  flash_bwd_dkdv_sm90<DK, DV><<<dim3(batch * g.KVH, (g.Skv + BLOCK_ROWS - 1) / BLOCK_ROWS),
                                THREADS, L::SMEM_BYTES, st>>>(kb, vb, qt, dot, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    void* dq, void* dk, void* dv, float* lse, float* dsum, const long long* geo,
    int causal, int q_offset, int sq_pad, float scale, void* stream) {
  if (geo[7] != geo[0] || geo[21] != geo[14] || sq_pad % BLOCK_ROWS != 0 || sq_pad < geo[1])
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (geo[0] == 128 && geo[14] == 128)
    return launch<128, 128>(q, k, v, o, dout, dq, dk, dv, lse, dsum, geo, causal, q_offset,
                            sq_pad, scale, st);
  if (geo[0] == 192 && geo[14] == 128)
    return launch<192, 128>(q, k, v, o, dout, dq, dk, dv, lse, dsum, geo, causal, q_offset,
                            sq_pad, scale, st);
  return (int)cudaErrorInvalidValue;
}
