// FlashAttention-2 forward for Hopper (sm_90a): the bf16 prefill, d 64, 128
// and 160, and MLA's q/k 192 with v 128.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py:66) for bf16
// inputs with d = 64, 128 or 160, or q/k heads of 192 and v heads of 128
// (deepseek-v2-236b's MLA prefill, which reaches the JAX package's jnp
// flash_attention with dv != dh: src/repro/models/attention.py:69), and
// at least 64 query rows; csrc/flash_attention.cu keeps every other shape
// (fp32, d 32, bf16 with 1 < Sq < 64, MLA's smoke (48, 32)) and
// csrc/flash_attention_decode.cu the decode rows. It computes the same
// function: s = (q . k^T) * d^-0.5 in fp32 (d: q and k's head dim);
// s = -1e30 where causal and q_offset + row < col, and where col >= Skv; a running
// max m and sum l in fp32; p cast to bf16 before the PV product; out = acc
// / max(l, 1e-30) cast to bf16. Query head h reads kv head h / (H / KV).
// The scores are kept in the log2 domain (scale * log2(e) folded in,
// exp2f), which moves the result by rounding only.
//
// Bound: the operations, 4*B*H*d*S(S+1)/2 FLOP for a causal S x S call
// (d 128 at B 8, H 16, S 2048: 1.37e11, 0.139 ms at the card's 989 TFLOP/s
// bf16 peak, against 0.2 GB of q, k, v and o; d 160 at B 8, H 32: 3.44e11,
// 0.348 ms; d 64 at B 8, H 32 (zamba2-1.2b's shared block): 1.37e11, 0.139
// ms; (192, 128) at B 8, H 128: 2*B*H*(192 + 128)*S(S+1)/2 = 1.375e12,
// 1.390 ms). The design spends its effort on the tensor cores:
// - both products are warpgroup MMAs (wgmma.mma_async, fp32 accumulators):
//   S = Q K^T reads Q and K from shared memory through K-major 128B-swizzle
//   descriptors; O += P V takes P from registers (the S accumulator
//   converted to bf16 pairs is already the A fragment) and V as an
//   MN-major operand (transpose bit), so no thread transposes V;
// - K and V arrive by TMA (cp.async.bulk.tensor, 128B swizzle, zero fill
//   past Sq and Skv) into a three-stage ring (two at d 64, where a second
//   block on the SM takes the third stage's part): one thread issues tile j+1's
//   loads on a "full" mbarrier before its warpgroup computes tile j, and an
//   "empty" mbarrier (all 256 threads arrive) guards the reuse of a stage.
//   With two stages that thread waits, before tile j, for the other
//   warpgroup to finish tile j-1, which holds the two in step (both in
//   softmax while the tensor cores idle); the third stage lets them drift
//   up to a tile apart, so one's softmax overlaps the other's products;
// - a block is two warpgroups over 128 query rows of one (b, h), so each
//   K/V tile in shared memory feeds 128 rows; the heaviest causal tiles
//   are scheduled first and a causal block stops at the tile holding key
//   q_offset + its last row (later tiles would add exactly 0).
//
// The head dims are template parameters (`Layout<DK, DV>`: q and k's, v's);
// each row of Q, K and V lies in slabs of 64 columns, one 128-byte swizzled
// row a slab:
// - d 64: one slab. QK^T runs d/16 = 4 k-steps, PV one n64 product (the
//   building block of d 160's third slab); O is 32 fp32 a thread. A slab
//   is half d 128's bytes, so the tile and stages are a choice, not forced:
//   D64_BK below records the one timing chose (128-key tiles, two stages,
//   two blocks an SM: 80 KB each) and what it was chosen from.
// - d 128: two slabs, 128-key tiles. Shared memory: Q 32 KB + 3 x (K 32 KB
//   + V 32 KB) = 224 KB, one block an SM. S is m64n128 (64 fp32 a thread),
//   O one m64n128 accumulator (64).
// - d 160: 160 columns are 2.5 slabs. The third slab is a whole 64-column
//   box at column 128: TMA fills columns 160-191, which lie outside the
//   tensor, with zeros (as it does past Sq and Skv), so every slab keeps
//   the one layout, tensor map and descriptor form that d 128 uses. QK^T
//   runs d/16 = 10 k-steps (the zero columns are never read); PV runs an
//   n128 product over slabs 0-1 and an n64 product over slab 2, whose 32
//   zero columns are dropped at the store. A 64-column slab cannot be cut
//   to 32: a box's inner extent is the swizzle span, and an MN-major
//   128B-swizzle V operand comes in whole 64-column atoms. With three
//   slabs a 128-key stage would be 96 KB and Q 48 KB, over the 227 KB a
//   block may take at two stages, so the tile drops to 64 keys: Q 48 KB +
//   3 x (K 24 KB + V 24 KB) = 192 KB, three stages as at d 128. S is
//   m64n64 (32 fp32 a thread), O 64 + 32. The other layout that fits (a
//   32-column third slab with 64B swizzle, its own tensor maps and
//   descriptors, 128-key tiles at two stages) needs a second swizzle mode
//   in every operand path; this one adds only the n64 product and costs
//   the 20 % of PV's tensor work spent on zeros.
// - (192, 128), MLA: Q and K rows are three whole slabs, V rows two. QK^T
//   runs 192/16 = 12 k-steps over the three slabs; PV and O are d 128's
//   (one n128 product, 64 fp32 a thread). A 128-key stage is K 48 KB + V
//   32 KB, so two stages and Q's 48 KB fit (209 KB with the alignment pad,
//   one block an SM); S is m64n128 as at d 128. v may be a strided view
//   (MLA's v is the second half of each head's 256 columns of the K/V
//   expansion): its tensor map takes the view's own strides.
// No atomics: two runs give the same bits. Not done yet: a producer warp
// with setmaxnreg, overlap of softmax with the next product inside a
// warpgroup, persistent blocks, a TMA-store epilogue.
//
// C entries (each launches on `stream` and returns a cudaError_t code, or
// 10000 + the CUresult of a failed cuTensorMapEncodeTiled;
// cudaErrorInvalidValue for head dims other than 64, 128, 160 and (192, 128)):
//   flash_attention_sm90_launch(q, k, v, o, geo, causal, q_offset, scale,
//       stream): `geo` holds 24 host int64: for each of q, k and v the
//       tensor map's dims (d, seq, heads, batch) and byte strides (seq,
//       heads, batch), then o's element strides (batch, seq, head).
//   flash_attention_sm90_probe(q, k, v, s_out, o_out, geo, stream): one
//       warpgroup computes S = Q K^T (64 x BK, fp32) and O = bf16(S) V
//       (64 x d_v, fp32) through the same TMA maps and descriptors, for a
//       64-row q and BK-row k and v (BK: the head dims' tile, 128 or 64;
//       `geo`: the first 21 values above).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLAB = 64;                  // bf16 columns in one 128-byte swizzled row
constexpr int BQ = 128;                   // query rows a block (two warpgroups x 64)
constexpr int THREADS = 256;
constexpr uint32_t ROW_BYTES = 128;       // one slab row
constexpr uint32_t ATOM_BYTES = 8 * ROW_BYTES;   // 8 rows: one swizzle atom
constexpr uint32_t SLAB_Q = BQ * ROW_BYTES;      // 16 KB
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ENCODE_ERROR = 10000;
constexpr long long WAIT_LIMIT_CYCLES = 1ll << 34;

// d 64's key tile, ring stages and blocks an SM (the register cap
// __launch_bounds__ asks for): 128 keys, 2 stages, 2 blocks an SM, Q 16 KB
// + 2 x 32 KB = 80 KB a block. Chosen by timing four candidates at
// zamba2-1.2b's prefill (8 x 2048, 32 heads over 32, causal; device ms a
// launch on an H100 80GB HBM3 at 700 W, median of 4 in turns; registers a
// thread from ptxas, no spills in any):
//   128 keys, 3 stages, 1 block an SM: Q 16 KB + 3 x 32 KB = 112 KB;
//      0.600 ms, 149 registers;
//   128 keys, 2 stages, 2 blocks: 16 + 2 x 32 = 80 KB a block;
//      0.491 ms, 127 registers: the one kept;
//   64 keys, 4 stages, 2 blocks: 16 + 4 x 16 = 80 KB; 0.546 ms, 102;
//   64 keys, 3 stages, 2 blocks: 16 + 3 x 16 = 64 KB; 0.548 ms, 100.
// Two blocks an SM let one block's softmax overlap the other's products,
// which a third stage within one block did less well. (128 keys at 3
// stages and 2 blocks would need 2 x 113 KB with the alignment pad and the
// runtime's 1 KB a block: 112 bytes over the SM's 228 KB.)
constexpr int D64_BK = 128, D64_STAGES = 2, D64_MIN_BLOCKS = 2;

// The layout of one pair of head dims (q and k's DK, v's DV): 64-column
// slabs a row of Q and K and of V, keys a K/V tile, stages of the K/V
// ring, blocks an SM.
template <int DK, int DV>
struct Layout {
  static_assert((DK == DV && (DK == 64 || DK == 128 || DK == 160)) ||
                    (DK == 192 && DV == 128),
                "head dims 64, 128, 160 and (192, 128)");
  static constexpr bool MLA = DK != DV;
  static constexpr int K_SLABS = DK == 64 ? 1 : DK == 128 ? 2 : 3;
  static constexpr int V_SLABS = DV == 64 ? 1 : DV == 128 ? 2 : 3;
  static constexpr int BK = DK == 64 ? D64_BK : DK == 160 ? 64 : 128;
  static constexpr int STAGES = DK == 64 ? D64_STAGES : MLA ? 2 : 3;
  static constexpr int MIN_BLOCKS = DK == 64 ? D64_MIN_BLOCKS : 1;
  static constexpr uint32_t SLAB_KV = BK * ROW_BYTES;          // 16 KB or 8 KB
  static constexpr uint32_t Q_BYTES = K_SLABS * SLAB_Q;
  static constexpr uint32_t STAGE_BYTES = (K_SLABS + V_SLABS) * SLAB_KV; // K slabs, then V slabs
  static constexpr size_t SMEM_BYTES = Q_BYTES + STAGES * STAGE_BYTES + 1024;  // + alignment
  static constexpr int O_COLS = DV < 128 ? DV : 128;  // the main PV product's n: 64 or 128
  static constexpr int HI_COLS = DV > 128 ? DV - 128 : 0;  // columns past it: 0 or 32
};

static_assert(Layout<64, 64>::SMEM_BYTES * Layout<64, 64>::MIN_BLOCKS <= 232448 &&
              Layout<128, 128>::SMEM_BYTES <= 232448 &&
              Layout<160, 160>::SMEM_BYTES <= 232448 &&
              Layout<192, 128>::SMEM_BYTES <= 232448,
              "a block takes at most 227 KB of shared memory");

struct Geo {
  int H, KVH, Sq, Skv, causal, q_offset;
  long long os[3];                        // o's (batch, seq, head) element strides
  float scale_log2;                       // d^-0.5 * log2(e)
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
#define WG_OUT32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_OUT64(d)                                                           \
  WG_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),           \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),            \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),            \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),            \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),            \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),            \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x N) = [d +] A B, A and B both from shared memory, both K-major;
// N = 128 (64 fp32 a thread) or 64 (32), chosen by the accumulator's size.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

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

// d (64 x N) += A B, A (64 x 16) from registers, B from shared memory,
// MN-major (transpose bit set); N = 128 or 64 as above.
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

__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_OUT32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// S (64 rows x BK keys) = Q K^T over DK: DK/16 k-steps of 16 columns. `q`:
// this warpgroup's first row in Q slab 0 (slab i at + i * q_slab); `k`: K
// slab 0 (slab i at + i * SLAB_KV). Rows are 128 bytes and 8-row atoms 1024
// bytes apart (SBO); a k-step moves 32 bytes inside a slab. At d 160 the
// last two k-steps read the first 32 columns of slab 2.
template <int DK, int DV>
__device__ __forceinline__ void qk_product(float (&s)[Layout<DK, DV>::BK / 2], uint32_t q,
                                           uint32_t q_slab, uint32_t k) {
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = sw128_desc(q + (kk / 4) * q_slab + col, 16, ATOM_BYTES);
    const uint64_t db = sw128_desc(k + (kk / 4) * Layout<DK, DV>::SLAB_KV + col, 16, ATOM_BYTES);
    wgmma_ss(s, da, db, kk > 0);
  }
  wg_commit();
  wg_wait0();
  fence_regs(s);
}

// O (64 rows x DV) += P (64 x BK keys, bf16 pairs in registers) V. V's
// tile is MN-major: DV is contiguous, 64 columns a slab. A k-step is 16
// keys = two 8-row atoms (SBO 1024 bytes apart); columns 64-127 are the
// next slab (LBO = SLAB_KV). `o` takes columns 0-127 (0-63 at d 64); at
// d 160 `hi` takes slab 2's 64 (128-191, of which 160-191 are TMA's zeros).
template <int DK, int DV>
__device__ __forceinline__ void pv_product(float (&o)[Layout<DK, DV>::O_COLS / 2], float (&hi)[32],
                                           uint32_t (&p)[Layout<DK, DV>::BK / 4],
                                           uint32_t v) {
  using L = Layout<DK, DV>;
  fence_regs(o);
  if constexpr (L::HI_COLS > 0) fence_regs(hi);
  fence_regs(p);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < L::BK / 16; ++kk) {
    const uint64_t db = sw128_desc(v + kk * 2 * ATOM_BYTES, L::SLAB_KV, ATOM_BYTES);
    wgmma_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], db);
    if constexpr (L::HI_COLS > 0) {
      const uint64_t dh = sw128_desc(v + 2 * L::SLAB_KV + kk * 2 * ATOM_BYTES,
                                     L::SLAB_KV, ATOM_BYTES);
      wgmma_rs(hi, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], dh);
    }
  }
  wg_commit();
  wg_wait0();
  fence_regs(o);
  if constexpr (L::HI_COLS > 0) fence_regs(hi);
  fence_regs(p);
}

// Two floats rounded to bf16; the lower column goes to the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator element i of a thread (lane l of warp w in the warpgroup)
// sits at row 16w + l/4 + 8*((i >> 1) & 1), column 8*(i >> 2) + 2*(l % 4)
// + (i & 1): the mma.m16n8 layout repeated over N/8 eight-column chunks.

// --- the kernel --------------------------------------------------------------

// K/V tile t (keys t*BK ...) of kv head `kvh`, batch `b`, into ring stage
// t % STAGES: one box a slab of K, then of V, completing on that stage's
// "full" barrier.
template <int DK, int DV>
__device__ __forceinline__ void load_kv(const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, uint32_t kv_s,
                                        uint32_t full0, int t, int kvh, int b) {
  using L = Layout<DK, DV>;
  const int s = t % L::STAGES;
  const uint32_t dst = kv_s + s * L::STAGE_BYTES, bar = full0 + 8 * s;
  mbar_expect_tx(bar, L::STAGE_BYTES);
#pragma unroll
  for (int sl = 0; sl < L::K_SLABS; ++sl)
    tma_load(dst + sl * L::SLAB_KV, kmap, bar, sl * SLAB, t * L::BK, kvh, b);
#pragma unroll
  for (int sl = 0; sl < L::V_SLABS; ++sl)
    tma_load(dst + (L::K_SLABS + sl) * L::SLAB_KV, vmap, bar, sl * SLAB, t * L::BK, kvh, b);
}

// The epilogue of one thread's two rows: columns 0-127 (0-63 at d 64)
// from `o`, then, at d 160, columns 128-159 from `hi`.
template <int DK, int DV>
__device__ __forceinline__ void store_rows(__nv_bfloat16* ob, const Geo& g, int row0,
                                           int t4, const float (&o)[Layout<DK, DV>::O_COLS / 2],
                                           const float (&hi)[32], const float (&l)[2]) {
  using L = Layout<DK, DV>;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (row >= g.Sq) continue;
    const float den = fmaxf(l[hr], 1e-30f);
    __nv_bfloat16* orow = ob + (long long)row * g.os[1] + 2 * t4;
#pragma unroll
    for (int c = 0; c < L::O_COLS / 8; ++c) {
      *reinterpret_cast<uint32_t*>(orow + 8 * c) =
          pack_bf16(o[4 * c + 2 * hr] / den, o[4 * c + 2 * hr + 1] / den);
    }
#pragma unroll
    for (int c = 0; c < L::HI_COLS / 8; ++c) {
      *reinterpret_cast<uint32_t*>(orow + 128 + 8 * c) =
          pack_bf16(hi[4 * c + 2 * hr] / den, hi[4 * c + 2 * hr + 1] / den);
    }
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, Layout<DK, DV>::MIN_BLOCKS)
flash_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               __nv_bfloat16* __restrict__ o, const Geo g) {
  using L = Layout<DK, DV>;
  constexpr int BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  constexpr int STAGES = L::STAGES;
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];   // q, full[], empty[]
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, kv_s = base + L::Q_BYTES;
  const uint32_t qbar = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]), empty0 = smem_u32(&bars[1 + STAGES]);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const int kvh = h / (g.H / g.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest causal rows first
  const int end = g.causal ? min(g.Skv, g.q_offset + min(q0 + BQ, g.Sq)) : g.Skv;
  const int n_tiles = (end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
    for (int sl = 0; sl < L::K_SLABS; ++sl) tma_load(q_s + sl * SLAB_Q, &qmap, qbar, sl * SLAB, q0, h, b);
    load_kv<DK, DV>(&kmap, &vmap, kv_s, full0, 0, kvh, b);
  }

  const int t4 = lane & 3;
  const int row0 = q0 + 64 * wg + 16 * warp + (lane >> 2);   // and row0 + 8
  const int pos0 = g.q_offset + row0;
  const int wg_first = g.q_offset + q0 + 64 * wg;            // positions of the
  const int wg_last = wg_first + 63;                          // warpgroup's rows
  const uint32_t q_wg = q_s + 64 * wg * ROW_BYTES;

  constexpr int O_REGS = L::O_COLS / 2;
  float acc[O_REGS], acc_hi[32];
#pragma unroll
  for (int i = 0; i < O_REGS; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_hi[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    if (tid == 0 && j + 1 < n_tiles) {
      // Tile j+1 goes into the stage tile j+1-STAGES used, once all
      // threads are done with it.
      if (j + 1 >= STAGES) mbar_wait(empty0 + 8 * ((j + 1) % STAGES), ((j + 1) / STAGES - 1) & 1);
      load_kv<DK, DV>(&kmap, &vmap, kv_s, full0, j + 1, kvh, b);
    }
    __syncwarp();
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    const int kv0 = j * BK;
    const uint32_t k_s = kv_s + s * L::STAGE_BYTES;
    // A tile past the warpgroup's last causal row would add exactly 0.
    if (!g.causal || kv0 <= wg_last) {
      float sc[BK / 2];
      qk_product<DK, DV>(sc, q_wg, SLAB_Q, k_s);

      // Mask only tiles that cross the diagonal or the Skv edge. The row
      // max is taken on the raw scores; m lives in the log2 domain
      // (scores times scale * log2(e)), folded into one FMA before exp2f.
      const bool edge = kv0 + BK > g.Skv || (g.causal && kv0 + BK - 1 > wg_first);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
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
      // P as bf16 pairs: p[2c] and p[2c+1] hold columns 8c + 2*t4 (+1) of
      // rows row0 and row0 + 8, so p[4kk .. 4kk+3] is the A fragment of
      // k-step kk.
      uint32_t p[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int hr = (i >> 1) & 1;
        const float p0 = exp2f(fmaf(sc[i], g.scale_log2, -m[hr]));
        const float p1 = exp2f(fmaf(sc[i + 1], g.scale_log2, -m[hr]));
        rs[hr] += p0 + p1;
        p[i >> 1] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
        rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
        l[hr] = l[hr] * corr[hr] + rs[hr];
      }
#pragma unroll
      for (int i = 0; i < O_REGS; ++i) acc[i] *= corr[(i >> 1) & 1];
      if constexpr (L::HI_COLS > 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc_hi[i] *= corr[(i >> 1) & 1];
      }
      pv_product<DK, DV>(acc, acc_hi, p, k_s + L::K_SLABS * L::SLAB_KV);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  // Epilogue: each thread writes its two rows straight to global memory.
  store_rows<DK, DV>(o + b * g.os[0] + h * g.os[2], g, row0, t4, acc, acc_hi, l);
}

// One warpgroup: S = Q K^T and O = bf16(S) V for a 64-row Q and BK-row K
// and V, written out in fp32 (row-major 64 x BK and 64 x DV).
constexpr uint32_t PROBE_Q_SLAB = 64 * ROW_BYTES;

template <int DK, int DV>
constexpr size_t probe_smem() {
  return Layout<DK, DV>::K_SLABS * PROBE_Q_SLAB + Layout<DK, DV>::STAGE_BYTES + 1024;
}

template <int DK, int DV>
__global__ void __launch_bounds__(128, 1)
probe_sm90(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, float* s_out,
           float* o_out) {
  using L = Layout<DK, DV>;
  constexpr int BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_mem;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::K_SLABS * PROBE_Q_SLAB;
  const uint32_t bar = smem_u32(&bar_mem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, L::K_SLABS * PROBE_Q_SLAB + L::STAGE_BYTES);
#pragma unroll
    for (int sl = 0; sl < L::K_SLABS; ++sl) {
      tma_load(q_s + sl * PROBE_Q_SLAB, &qmap, bar, sl * SLAB, 0, 0, 0);
      tma_load(k_s + sl * L::SLAB_KV, &kmap, bar, sl * SLAB, 0, 0, 0);
    }
#pragma unroll
    for (int sl = 0; sl < L::V_SLABS; ++sl)
      tma_load(k_s + (L::K_SLABS + sl) * L::SLAB_KV, &vmap, bar, sl * SLAB, 0, 0, 0);
  }
  __syncwarp();
  mbar_wait(bar, 0);

  constexpr int O_REGS = L::O_COLS / 2;
  float s[BK / 2], acc[O_REGS], acc_hi[32];
  qk_product<DK, DV>(s, q_s, PROBE_Q_SLAB, k_s);
  uint32_t p[BK / 4];
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) p[i >> 1] = pack_bf16(s[i], s[i + 1]);
#pragma unroll
  for (int i = 0; i < O_REGS; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_hi[i] = 0.f;
  pv_product<DK, DV>(acc, acc_hi, p, k_s + L::K_SLABS * L::SLAB_KV);

  const int r = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    s_out[(r + 8 * ((i >> 1) & 1)) * BK + 8 * (i >> 2) + c0 + (i & 1)] = s[i];
#pragma unroll
  for (int i = 0; i < O_REGS; ++i)
    o_out[(r + 8 * ((i >> 1) & 1)) * DV + 8 * (i >> 2) + c0 + (i & 1)] = acc[i];
#pragma unroll
  for (int i = 0; i < 4 * L::HI_COLS / 8; ++i)
    o_out[(r + 8 * ((i >> 1) & 1)) * DV + 128 + 8 * (i >> 2) + c0 + (i & 1)] = acc_hi[i];
}

// --- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda.
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
// fill out of bounds (past d at d 160, past Sq and Skv).
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

// Dynamic shared memory past 48 KB, and the whole 228 KB of an SM as
// shared memory (a hint the CUDA runtime may ignore), so that d 64's two blocks
// an SM fit beside each other.
template <typename Kernel>
int opt_in_smem(Kernel kernel, bool& done, size_t bytes) {
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

template <int DK, int DV>
int launch_d(const void* q, const void* k, const void* v, void* o, const long long* geo,
             int causal, int q_offset, float scale, cudaStream_t stream) {
  using L = Layout<DK, DV>;
  CUtensorMap qm, km, vm;
  int err = encode_map(&qm, q, geo, BQ);
  if (err == 0) err = encode_map(&km, k, geo + 7, L::BK);
  if (err == 0) err = encode_map(&vm, v, geo + 14, L::BK);
  if (err != 0) return err;
  static bool smem_set = false;
  err = opt_in_smem(flash_fwd_sm90<DK, DV>, smem_set, L::SMEM_BYTES);
  if (err != 0) return err;
  Geo g;
  g.Sq = (int)geo[1];
  g.H = (int)geo[2];
  g.Skv = (int)geo[8];
  g.KVH = (int)geo[9];
  g.causal = causal;
  g.q_offset = q_offset;
  for (int i = 0; i < 3; ++i) g.os[i] = geo[21 + i];
  g.scale_log2 = scale * LOG2E;
  const dim3 grid((unsigned)(geo[3] * g.H), (unsigned)((g.Sq + BQ - 1) / BQ));
  flash_fwd_sm90<DK, DV><<<grid, THREADS, L::SMEM_BYTES, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), g);
  return (int)cudaGetLastError();
}

template <int DK, int DV>
int probe_d(const void* q, const void* k, const void* v, float* s_out, float* o_out,
            const long long* geo, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = encode_map(&qm, q, geo, 64);
  if (err == 0) err = encode_map(&km, k, geo + 7, Layout<DK, DV>::BK);
  if (err == 0) err = encode_map(&vm, v, geo + 14, Layout<DK, DV>::BK);
  if (err != 0) return err;
  static bool smem_set = false;
  err = opt_in_smem(probe_sm90<DK, DV>, smem_set, probe_smem<DK, DV>());
  if (err != 0) return err;
  probe_sm90<DK, DV><<<1, 128, probe_smem<DK, DV>(), stream>>>(qm, km, vm, s_out, o_out);
  return (int)cudaGetLastError();
}

// The instance of a (q/k, v) head-dim pair, `geo[0]` and `geo[14]` (q's
// and v's d; k's, `geo[7]`, must be q's); -1 for a pair without one.
int pair_index(const long long* geo) {
  if (geo[7] != geo[0]) return -1;
  if (geo[14] == geo[0]) return geo[0] == 64 ? 0 : geo[0] == 128 ? 1 : geo[0] == 160 ? 2 : -1;
  return geo[0] == 192 && geo[14] == 128 ? 3 : -1;
}

}  // namespace

extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o,
                                           const long long* geo, int causal,
                                           int q_offset, float scale,
                                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (pair_index(geo)) {
    case 0: return launch_d<64, 64>(q, k, v, o, geo, causal, q_offset, scale, st);
    case 1: return launch_d<128, 128>(q, k, v, o, geo, causal, q_offset, scale, st);
    case 2: return launch_d<160, 160>(q, k, v, o, geo, causal, q_offset, scale, st);
    case 3: return launch_d<192, 128>(q, k, v, o, geo, causal, q_offset, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_sm90_probe(const void* q, const void* k,
                                          const void* v, float* s_out,
                                          float* o_out, const long long* geo,
                                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (pair_index(geo)) {
    case 0: return probe_d<64, 64>(q, k, v, s_out, o_out, geo, st);
    case 1: return probe_d<128, 128>(q, k, v, s_out, o_out, geo, st);
    case 2: return probe_d<160, 160>(q, k, v, s_out, o_out, geo, st);
    case 3: return probe_d<192, 128>(q, k, v, s_out, o_out, geo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
