// FlashAttention-2 backward with GQA, causal masking and a q_offset window:
// the gradient of the forward in flash_attention*.cu with respect to q, k
// and v.
//
// Replaces no TPU kernel. The JAX package has no Pallas backward: it takes
// the attention gradient by autodiff of its jnp chunked path
// (src/repro/models/attention.py, `flash_attention`, differentiated in
// src/repro/train/train_loop.py). On the card the port's forward is a
// hand-written kernel whose output has no autograd graph, so its gradient is
// this kernel, called from `FlashAttentionFn.backward`
// (kernels/flash_attention/ops.py). It computes what
// `ref.py::flash_attention_bwd_ref` computes:
//   LSE = logsumexp over the keys a row may see of s = (q . k^T) * d^-0.5,
//   D = rowsum(dO * O) in fp32, with O as the forward stored it,
//   P = exp(s - LSE), dV = P^T dO, dP = dO V^T, dS = P * (dP - D),
//   dQ = scale * dS K, dK = scale * dS^T Q,
// dK and dV summed over the GQA group's query heads (head h reads kv head
// h / (H / KV)), masked keys (causal, q_offset + row < key) contributing 0.
//
// Two launches, one after the other on the caller's stream, no atomics, so
// two runs give the same bits:
//   1. dq: one block per (b * H + h, tile of query rows). It forms D for its
//      rows, walks its keys once for the row statistics (LSE, written to a
//      scratch row for launch 2), then again for dQ, and writes dQ once;
//   2. dkdv: one block per (b * KV + kv head, tile of keys). It walks the
//      group's query heads and, for each, the query tiles that can see its
//      keys (causal: those at or after the tile), and writes dK and dV once.
//      A key tile that no query row sees writes zeros.
// The backward recomputes LSE and reads nothing else of the forward but O,
// so the forward kernels are left as they were.
//
// Bound: the operations. The backward's five products of size Sq x Skv x d
// (S, dP, dV, dQ, dK) are 2.5 x the forward's two; at the training shape
// (B 4, S 4096, H 16 over 8, d 128, causal) 6.9e11 FLOP = 0.695 ms at the
// H100's 989 TFLOP/s, against 0.14 GB of q, k, v, o, dO and the three
// gradients. This first design recomputes S three times (the LSE pass, the
// dQ pass and the dK/dV pass: 8 products where 5 would do) and keeps every
// tile in shared memory with plain loads (no TMA, no wgmma); it is meant to
// be right, not fast.
//
// Arithmetic: bf16 tiles go through mma.sync.m16n8k16 with fp32
// accumulators (the fragment code of flash_attention.cu); P and dS are
// rounded to bf16 before the products that take them. fp32 inputs take a
// plain FMA loop (no TF32).
//
// Instances: templated on q/k's head dim DK and v's DV, as the forward in
// flash_attention.cu: DK == DV at 32, 64, 128 and 160, and MLA's unequal
// pairs (DK, DV) = (192, 128) (deepseek-v2-236b: nope 128 + rope 64, v 128)
// and (48, 32) (its smoke config). S = Q K^T, dQ = dS K and dK = dS^T Q
// are DK wide; dP = dO V^T contracts over DV, and D, O, dO and dV are DV
// wide. At (192, 128) the dq block's shared memory is Q and K tiles of 64 x
// 200, dO and V tiles of 64 x 136 and K^T of 192 x 72 (111 KB), the dk/dv
// block's 90 KB; the dk/dv accumulators are DK/2 + DV/2 fp32 registers a
// thread, 96 + 64 (d 160's 80 + 80). The fp32 kernels give each lane the
// columns lane + 32 i below DK (or DV), so DK 48 takes two, the second
// half-used.
//
// C entry: flash_attention_bwd_launch(q, k, v, o, dout, dq, dk, dv, lse,
// dsum, is_bf16, d, dv, B, H, KV, Sq, Skv, strides, causal, q_offset,
// scale, stream); d is q/k's head dim, dv v's (o, dout and dv are dv
// wide); `strides` points to 24 host int64 element strides, (batch, seq,
// head) of q, k, v, o, dout, dq, dk and dv in turn; the head dim is
// contiguous. `lse` and `dsum` are fp32 scratch of B * H * Sq. Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for a dtype
// or (d, dv) it lacks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;   // (B * H, Sq)
  float* dsum;  // (B * H, Sq): D = rowsum(dO * O)
  int H, KVH, Sq, Skv, causal, q_offset;
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  float scale;
};

// Keys a block of query rows [q0, q0 + rows) sees: all of them, or, when
// causal, up to the key at q_offset + the block's last valid row.
__device__ __forceinline__ int kv_end(const Args& a, int q0, int rows) {
  if (!a.causal) return a.Skv;
  const int last_row = min(q0 + rows, a.Sq) - 1;
  return min(a.Skv, a.q_offset + last_row + 1);
}

// The first query row that sees key k0 (causal), else 0.
__device__ __forceinline__ int q_begin(const Args& a, int k0) {
  return a.causal ? max(0, k0 - a.q_offset) : 0;
}

__device__ __forceinline__ bool masked(const Args& a, int row, int col) {
  return row >= a.Sq || col >= a.Skv || (a.causal && a.q_offset + row < col);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles.
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;  // 4 warps
constexpr int DQ_ROWS = 64;   // dq: query rows a block (16 a warp)
constexpr int DQ_KEYS = 64;   // dq: keys a tile
constexpr int KV_KEYS = 64;   // dkdv: keys a block (16 a warp)
constexpr int KV_ROWS = 32;   // dkdv: query rows a tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16; the lower column goes to the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment (16 rows x 16 columns) at row r0, column c0 of a row-major
// shared tile with leading dimension ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s,
                                       int ld, int r0, int c0, int g, int t) {
  const __nv_bfloat16* p = s + (r0 + g) * ld + c0 + t * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// Two 16x8 accumulator tiles (columns 16 kk .. 16 kk + 15) as one A
// fragment, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Rows [r0, r0 + rows) of a (seq, d) bf16 head into a row-major shared tile
// (ld) and, where t_out is given, its transpose (d rows, ldt); rows past
// `n` are zeros. Key-major order keeps the transposed stores conflict-free.
template <int D>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src, long long row_stride,
                                          int r0, int rows, int n, __nv_bfloat16* s_out,
                                          int ld, __nv_bfloat16* t_out, int ldt, int tid) {
  constexpr int CH = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < rows * CH; i += THREADS) {
    const int r = i % rows, c = i / rows;
    uint4 x = zero;
    if (r0 + r < n) x = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(s_out + r * ld + c * 8) = x;
    if (t_out != nullptr) {
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) t_out[(c * 8 + e) * ldt + r] = xe[e];
    }
  }
}

template <int DK, int DV>
constexpr size_t dq_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)(DQ_ROWS + DQ_KEYS) * (DK + 8 + DV + 8) +
                                  (size_t)DK * (DQ_KEYS + 8)) +
         sizeof(float) * DQ_ROWS;
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_bf16(Args a) {
  constexpr int LD = DK + 8, LDV = DV + 8, LDT = DQ_KEYS + 8;
  constexpr int KW = (DK > DV ? DK : DV) / 16;  // k-steps of the wider product
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* dOs = Qs + DQ_ROWS * LD;                            // [64][LDV]
  __nv_bfloat16* Ks = dOs + DQ_ROWS * LDV;                           // [64][LD]
  __nv_bfloat16* Vs = Ks + DQ_KEYS * LD;                             // [64][LDV]
  __nv_bfloat16* Kt = Vs + DQ_KEYS * LDV;                            // [DK][LDT]
  float* Drow = reinterpret_cast<float*>(Kt + DK * LDT);            // [64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;  // longest causal rows first
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(a.o) + b * a.os[0] + h * a.os[2];
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout) + b * a.dos[0] + h * a.dos[2];
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + kvh * a.vs[2];

  load_tile<DK>(q, a.qs[1], q0, DQ_ROWS, a.Sq, Qs, LD, nullptr, 0, tid);
  load_tile<DV>(dout, a.dos[1], q0, DQ_ROWS, a.Sq, dOs, LDV, nullptr, 0, tid);
  __syncthreads();

  // D = rowsum(dO * O) in fp32 for this warp's 16 rows.
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr, row = q0 + r;
    float part = 0.f;
    if (row < a.Sq) {
      const __nv_bfloat16* orow = o + (long long)row * a.os[1];
      for (int c = lane; c < DV; c += 32)
        part = fmaf(__bfloat162float(dOs[r * LDV + c]), __bfloat162float(orow[c]), part);
    }
    part = warp_sum(part);
    if (lane == 0) {
      Drow[r] = part;
      if (row < a.Sq) a.dsum[(long long)bh * a.Sq + row] = part;
    }
  }
  __syncthreads();

  const int r0 = warp * 16;
  const int row_abs[2] = {a.q_offset + q0 + r0 + g, a.q_offset + q0 + r0 + g + 8};
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const float d_r[2] = {Drow[r0 + g], Drow[r0 + g + 8]};
  const int end = kv_end(a, q0, DQ_ROWS);

  // Pass 1: the row statistics, as the forward's online softmax.
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  for (int kv0 = 0; kv0 < end; kv0 += DQ_KEYS) {
    __syncthreads();
    load_tile<DK>(k, a.ks[1], kv0, DQ_KEYS, a.Skv, Ks, LD, nullptr, 0, tid);
    __syncthreads();
    float s[DQ_KEYS / 8][4];
#pragma unroll
    for (int n = 0; n < DQ_KEYS / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t qa[4];
      load_a(qa, Qs, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < DQ_KEYS / 8; ++n) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * LD + kk * 16 + t * 2;
        mma_bf16(s[n], qa, ld32(kp), ld32(kp + 8));
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < DQ_KEYS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + n * 8 + t * 2 + (e & 1);
        float x = s[n][e] * a.scale;
        if (col >= a.Skv || (a.causal && row_abs[e >> 1] < col)) x = NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      m_new[hr] = fmaxf(m_r[hr], mx[hr]);
    }
#pragma unroll
    for (int n = 0; n < DQ_KEYS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e >> 1] += expf(s[n][e] - m_new[e >> 1]);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
      l_r[hr] = l_r[hr] * expf(m_r[hr] - m_new[hr]) + rs[hr];
      m_r[hr] = m_new[hr];
    }
  }
  float lse_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lse_r[hr] = m_r[hr] + logf(l_r[hr]);
    if (t == 0 && rows[hr] < a.Sq) a.lse[(long long)bh * a.Sq + rows[hr]] = lse_r[hr];
  }

  // Pass 2: dQ = scale * sum over key tiles of dS K.
  float acc[DK / 8][4];
#pragma unroll
  for (int dn = 0; dn < DK / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int kv0 = 0; kv0 < end; kv0 += DQ_KEYS) {
    __syncthreads();
    load_tile<DK>(k, a.ks[1], kv0, DQ_KEYS, a.Skv, Ks, LD, Kt, LDT, tid);
    load_tile<DV>(v, a.vs[1], kv0, DQ_KEYS, a.Skv, Vs, LDV, nullptr, 0, tid);
    __syncthreads();
    float s[DQ_KEYS / 8][4], dp[DQ_KEYS / 8][4];
#pragma unroll
    for (int n = 0; n < DQ_KEYS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    // S over DK's k-steps and dP over DV's (both, at equal dims).
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      uint32_t qa[4], da[4];
      if (kk < DK / 16) load_a(qa, Qs, LD, r0, kk * 16, g, t);
      if (kk < DV / 16) load_a(da, dOs, LDV, r0, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < DQ_KEYS / 8; ++n) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * LD + kk * 16 + t * 2;
        const __nv_bfloat16* vp = Vs + (n * 8 + g) * LDV + kk * 16 + t * 2;
        if (kk < DK / 16) mma_bf16(s[n], qa, ld32(kp), ld32(kp + 8));
        if (kk < DV / 16) mma_bf16(dp[n], da, ld32(vp), ld32(vp + 8));
      }
    }
    // dS = P * (dP - D), P = exp(s - LSE); masked entries are 0.
#pragma unroll
    for (int n = 0; n < DQ_KEYS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, col = kv0 + n * 8 + t * 2 + (e & 1);
        const float p = masked(a, rows[hr], col) ? 0.f : expf(s[n][e] * a.scale - lse_r[hr]);
        s[n][e] = p * (dp[n][e] - d_r[hr]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < DQ_KEYS / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DK / 8; ++dn) {
        const __nv_bfloat16* kp = Kt + (dn * 8 + g) * LDT + kk * 16 + t * 2;
        mma_bf16(acc[dn], pa, ld32(kp), ld32(kp + 8));
      }
    }
  }

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(a.dq) + b * a.dqs[0] + h * a.dqs[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (rows[hr] >= a.Sq) continue;
    __nv_bfloat16* drow = dq + (long long)rows[hr] * a.dqs[1] + t * 2;
#pragma unroll
    for (int dn = 0; dn < DK / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(drow + dn * 8) =
          pack_bf16(acc[dn][2 * hr] * a.scale, acc[dn][2 * hr + 1] * a.scale);
    }
  }
}

template <int DK, int DV>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)(KV_KEYS + KV_ROWS) * (DK + 8 + DV + 8) +
                                  (size_t)(DK + DV) * (KV_ROWS + 8)) +
         sizeof(float) * 2 * KV_ROWS;
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_bf16(Args a) {
  constexpr int LD = DK + 8, LDV = DV + 8, LDT = KV_ROWS + 8;
  constexpr int KW = (DK > DV ? DK : DV) / 16;  // k-steps of the wider product
  constexpr int NW = (DK > DV ? DK : DV) / 8;   // n-tiles of the wider gradient
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* Vs = Ks + KV_KEYS * LD;                             // [64][LDV]
  __nv_bfloat16* Qs = Vs + KV_KEYS * LDV;                            // [32][LD]
  __nv_bfloat16* dOs = Qs + KV_ROWS * LD;                            // [32][LDV]
  __nv_bfloat16* Qt = dOs + KV_ROWS * LDV;                           // [DK][LDT]
  __nv_bfloat16* dOt = Qt + DK * LDT;                                // [DV][LDT]
  float* lse_s = reinterpret_cast<float*>(dOt + DV * LDT);          // [32]
  float* d_s = lse_s + KV_ROWS;                                      // [32]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.KVH, kvh = blockIdx.x % a.KVH;
  const int group = a.H / a.KVH;
  const int k0 = blockIdx.y * KV_KEYS;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + kvh * a.vs[2];

  load_tile<DK>(k, a.ks[1], k0, KV_KEYS, a.Skv, Ks, LD, nullptr, 0, tid);
  load_tile<DV>(v, a.vs[1], k0, KV_KEYS, a.Skv, Vs, LDV, nullptr, 0, tid);

  const int kr = warp * 16;  // this warp's 16 keys: rows kr + g and kr + g + 8
  const int keys[2] = {k0 + kr + g, k0 + kr + g + 8};
  float dka[DK / 8][4], dva[DV / 8][4];
#pragma unroll
  for (int dn = 0; dn < DK / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = 0.f;
  }
#pragma unroll
  for (int dn = 0; dn < DV / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[dn][e] = 0.f;
  }
  const int qb = (q_begin(a, k0) / KV_ROWS) * KV_ROWS;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const long long bh = (long long)b * a.H + h;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.qs[0] + h * a.qs[2];
    const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout) + b * a.dos[0] + h * a.dos[2];
    for (int q0 = qb; q0 < a.Sq; q0 += KV_ROWS) {
      __syncthreads();  // every warp is done with the previous tile
      load_tile<DK>(q, a.qs[1], q0, KV_ROWS, a.Sq, Qs, LD, Qt, LDT, tid);
      load_tile<DV>(dout, a.dos[1], q0, KV_ROWS, a.Sq, dOs, LDV, dOt, LDT, tid);
      for (int i = tid; i < KV_ROWS; i += THREADS) {
        const bool in = q0 + i < a.Sq;
        lse_s[i] = in ? a.lse[bh * a.Sq + q0 + i] : 0.f;
        d_s[i] = in ? a.dsum[bh * a.Sq + q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 query rows a warp.
      float st[KV_ROWS / 8][4], dpt[KV_ROWS / 8][4];
#pragma unroll
      for (int n = 0; n < KV_ROWS / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KW; ++kk) {
        uint32_t ka[4], va[4];
        if (kk < DK / 16) load_a(ka, Ks, LD, kr, kk * 16, g, t);
        if (kk < DV / 16) load_a(va, Vs, LDV, kr, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < KV_ROWS / 8; ++n) {
          const __nv_bfloat16* qp = Qs + (n * 8 + g) * LD + kk * 16 + t * 2;
          const __nv_bfloat16* dp = dOs + (n * 8 + g) * LDV + kk * 16 + t * 2;
          if (kk < DK / 16) mma_bf16(st[n], ka, ld32(qp), ld32(qp + 8));
          if (kk < DV / 16) mma_bf16(dpt[n], va, ld32(dp), ld32(dp + 8));
        }
      }
      // P^T and dS^T; element e is key keys[e >> 1], query column
      // q0 + n * 8 + t * 2 + (e & 1).
#pragma unroll
      for (int n = 0; n < KV_ROWS / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + t * 2 + (e & 1);
          const float p = masked(a, q0 + c, keys[e >> 1]) ? 0.f
                                                          : expf(st[n][e] * a.scale - lse_s[c]);
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - d_s[c]);
        }
      }
      // dV += P^T dO and dK += dS^T Q over the tile's 32 query rows.
#pragma unroll
      for (int kk = 0; kk < KV_ROWS / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < NW; ++dn) {
          const __nv_bfloat16* op = dOt + (dn * 8 + g) * LDT + kk * 16 + t * 2;
          const __nv_bfloat16* qp = Qt + (dn * 8 + g) * LDT + kk * 16 + t * 2;
          if (dn < DV / 8) mma_bf16(dva[dn], pa, ld32(op), ld32(op + 8));
          if (dn < DK / 8) mma_bf16(dka[dn], sa, ld32(qp), ld32(qp + 8));
        }
      }
    }
  }

  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(a.dk) + b * a.dks[0] + kvh * a.dks[2];
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(a.dv) + b * a.dvs[0] + kvh * a.dvs[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (keys[hr] >= a.Skv) continue;
    __nv_bfloat16* krow = dk + (long long)keys[hr] * a.dks[1] + t * 2;
    __nv_bfloat16* vrow = dv + (long long)keys[hr] * a.dvs[1] + t * 2;
#pragma unroll
    for (int dn = 0; dn < NW; ++dn) {
      if (dn < DK / 8)
        *reinterpret_cast<uint32_t*>(krow + dn * 8) =
            pack_bf16(dka[dn][2 * hr] * a.scale, dka[dn][2 * hr + 1] * a.scale);
      if (dn < DV / 8)
        *reinterpret_cast<uint32_t*>(vrow + dn * 8) = pack_bf16(dva[dn][2 * hr], dva[dn][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: plain FMA loops. dq: one warp a query row, one key a lane; dkdv: one
// warp a key, one query row a lane.
// ---------------------------------------------------------------------------

constexpr int F_ROWS = 8;    // dq: query rows a block; dkdv: keys a block
constexpr int F_TILE = 32;   // keys (dq) or query rows (dkdv) a tile
constexpr int F_THREADS = 32 * F_ROWS;

template <int DK, int DV>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)F_ROWS * (DK + DV) + (size_t)F_TILE * (DK + 1 + DV + 1) +
                          2 * F_TILE);
}

// Columns lane + 32 i (i < ceil(D / 32)) of a D-wide row that lie below D:
// all of them when 32 divides D.
template <int D>
__device__ __forceinline__ bool lane_col(int lane, int i) {
  return D % 32 == 0 || lane + 32 * i < D;
}

template <int DK, int DV>
__global__ void __launch_bounds__(F_THREADS) flash_bwd_dq_f32(Args a) {
  constexpr int LDK = DK + 1, LDV = DV + 1;  // lane j reads row j: odd strides, no conflicts
  constexpr int NK = (DK + 31) / 32;
  extern __shared__ float fsm[];
  float* Qs = fsm;                 // [F_ROWS][DK]
  float* dOs = Qs + F_ROWS * DK;   // [F_ROWS][DV]
  float* Ks = dOs + F_ROWS * DV;   // [F_TILE][LDK]
  float* Vs = Ks + F_TILE * LDK;   // [F_TILE][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F_ROWS;
  const float* q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const float* o = static_cast<const float*>(a.o) + b * a.os[0] + h * a.os[2];
  const float* dout = static_cast<const float*>(a.dout) + b * a.dos[0] + h * a.dos[2];
  const float* k = static_cast<const float*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const float* v = static_cast<const float*>(a.v) + b * a.vs[0] + kvh * a.vs[2];

  for (int i = tid; i < F_ROWS * DK; i += F_THREADS) {
    const int r = i / DK, c = i % DK;
    Qs[i] = q0 + r < a.Sq ? q[(long long)(q0 + r) * a.qs[1] + c] : 0.f;
  }
  for (int i = tid; i < F_ROWS * DV; i += F_THREADS) {
    const int r = i / DV, c = i % DV;
    dOs[i] = q0 + r < a.Sq ? dout[(long long)(q0 + r) * a.dos[1] + c] : 0.f;
  }
  __syncthreads();
  const int row = q0 + warp;
  const int row_abs = a.q_offset + row;
  float dsum = 0.f;
  if (row < a.Sq) {
    const float* orow = o + (long long)row * a.os[1];
    for (int c = lane; c < DV; c += 32) dsum = fmaf(dOs[warp * DV + c], orow[c], dsum);
  }
  dsum = warp_sum(dsum);
  const int end = kv_end(a, q0, F_ROWS);

  float m = NEG_INF, l = 0.f;
  for (int kv0 = 0; kv0 < end; kv0 += F_TILE) {
    __syncthreads();
    for (int i = tid; i < F_TILE * DK; i += F_THREADS) {
      const int r = i / DK, c = i % DK;
      Ks[r * LDK + c] = kv0 + r < a.Skv ? k[(long long)(kv0 + r) * a.ks[1] + c] : 0.f;
    }
    __syncthreads();
    const int col = kv0 + lane;
    float sc = 0.f;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) sc = fmaf(Qs[warp * DK + d], Ks[lane * LDK + d], sc);
    sc *= a.scale;
    if (col >= a.Skv || (a.causal && row_abs < col)) sc = NEG_INF;
    const float m_new = fmaxf(m, warp_max(sc));
    l = l * expf(m - m_new) + warp_sum(expf(sc - m_new));
    m = m_new;
  }
  const float lse = m + logf(l);
  if (lane == 0 && row < a.Sq) {
    a.lse[(long long)bh * a.Sq + row] = lse;
    a.dsum[(long long)bh * a.Sq + row] = dsum;
  }

  float acc[NK];
#pragma unroll
  for (int i = 0; i < NK; ++i) acc[i] = 0.f;
  for (int kv0 = 0; kv0 < end; kv0 += F_TILE) {
    __syncthreads();
    for (int i = tid; i < F_TILE * DK; i += F_THREADS) {
      const int r = i / DK, c = i % DK;
      Ks[r * LDK + c] = kv0 + r < a.Skv ? k[(long long)(kv0 + r) * a.ks[1] + c] : 0.f;
    }
    for (int i = tid; i < F_TILE * DV; i += F_THREADS) {
      const int r = i / DV, c = i % DV;
      Vs[r * LDV + c] = kv0 + r < a.Skv ? v[(long long)(kv0 + r) * a.vs[1] + c] : 0.f;
    }
    __syncthreads();
    const int col = kv0 + lane;
    float sc = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) sc = fmaf(Qs[warp * DK + d], Ks[lane * LDK + d], sc);
#pragma unroll 8
    for (int d = 0; d < DV; ++d) dp = fmaf(dOs[warp * DV + d], Vs[lane * LDV + d], dp);
    const float p = masked(a, row, col) ? 0.f : expf(sc * a.scale - lse);
    const float ds = p * (dp - dsum);
    for (int j = 0; j < F_TILE; ++j) {
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
      for (int i = 0; i < NK; ++i)
        if (lane_col<DK>(lane, i)) acc[i] = fmaf(dsj, Ks[j * LDK + lane + 32 * i], acc[i]);
    }
  }
  if (row < a.Sq) {
    float* drow = static_cast<float*>(a.dq) + b * a.dqs[0] + h * a.dqs[2] + (long long)row * a.dqs[1];
#pragma unroll
    for (int i = 0; i < NK; ++i)
      if (lane_col<DK>(lane, i)) drow[lane + 32 * i] = acc[i] * a.scale;
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(F_THREADS) flash_bwd_dkdv_f32(Args a) {
  constexpr int LDQ = DK + 1, LDO = DV + 1;  // lane i reads row i: odd strides, no conflicts
  constexpr int NK = (DK + 31) / 32, NV = (DV + 31) / 32;
  extern __shared__ float fsm[];
  float* Ks = fsm;                    // [F_ROWS][DK]
  float* Vs = Ks + F_ROWS * DK;       // [F_ROWS][DV]
  float* Qs = Vs + F_ROWS * DV;       // [F_TILE][LDQ]
  float* dOs = Qs + F_TILE * LDQ;     // [F_TILE][LDO]
  float* lse_s = dOs + F_TILE * LDO;  // [F_TILE]
  float* d_s = lse_s + F_TILE;        // [F_TILE]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / a.KVH, kvh = blockIdx.x % a.KVH;
  const int group = a.H / a.KVH;
  const int k0 = blockIdx.y * F_ROWS;
  const int key = k0 + warp;
  const float* k = static_cast<const float*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const float* v = static_cast<const float*>(a.v) + b * a.vs[0] + kvh * a.vs[2];
  for (int i = tid; i < F_ROWS * DK; i += F_THREADS) {
    const int r = i / DK, c = i % DK;
    Ks[i] = k0 + r < a.Skv ? k[(long long)(k0 + r) * a.ks[1] + c] : 0.f;
  }
  for (int i = tid; i < F_ROWS * DV; i += F_THREADS) {
    const int r = i / DV, c = i % DV;
    Vs[i] = k0 + r < a.Skv ? v[(long long)(k0 + r) * a.vs[1] + c] : 0.f;
  }
  float dka[NK], dva[NV];
#pragma unroll
  for (int i = 0; i < NK; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) dva[i] = 0.f;
  const int qb = (q_begin(a, k0) / F_TILE) * F_TILE;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const long long bh = (long long)b * a.H + h;
    const float* q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[2];
    const float* dout = static_cast<const float*>(a.dout) + b * a.dos[0] + h * a.dos[2];
    for (int q0 = qb; q0 < a.Sq; q0 += F_TILE) {
      __syncthreads();
      for (int i = tid; i < F_TILE * DK; i += F_THREADS) {
        const int r = i / DK, c = i % DK;
        Qs[r * LDQ + c] = q0 + r < a.Sq ? q[(long long)(q0 + r) * a.qs[1] + c] : 0.f;
      }
      for (int i = tid; i < F_TILE * DV; i += F_THREADS) {
        const int r = i / DV, c = i % DV;
        dOs[r * LDO + c] = q0 + r < a.Sq ? dout[(long long)(q0 + r) * a.dos[1] + c] : 0.f;
      }
      for (int i = tid; i < F_TILE; i += F_THREADS) {
        const bool in = q0 + i < a.Sq;
        lse_s[i] = in ? a.lse[bh * a.Sq + q0 + i] : 0.f;
        d_s[i] = in ? a.dsum[bh * a.Sq + q0 + i] : 0.f;
      }
      __syncthreads();
      float sc = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < DK; ++d) sc = fmaf(Qs[lane * LDQ + d], Ks[warp * DK + d], sc);
#pragma unroll 8
      for (int d = 0; d < DV; ++d) dp = fmaf(dOs[lane * LDO + d], Vs[warp * DV + d], dp);
      const float p = masked(a, q0 + lane, key) ? 0.f : expf(sc * a.scale - lse_s[lane]);
      const float ds = p * (dp - d_s[lane]);
      for (int j = 0; j < F_TILE; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < NV; ++i)
          if (lane_col<DV>(lane, i)) dva[i] = fmaf(pj, dOs[j * LDO + lane + 32 * i], dva[i]);
#pragma unroll
        for (int i = 0; i < NK; ++i)
          if (lane_col<DK>(lane, i)) dka[i] = fmaf(dsj, Qs[j * LDQ + lane + 32 * i], dka[i]);
      }
    }
  }
  if (key < a.Skv) {
    float* krow = static_cast<float*>(a.dk) + b * a.dks[0] + kvh * a.dks[2] + (long long)key * a.dks[1];
    float* vrow = static_cast<float*>(a.dv) + b * a.dvs[0] + kvh * a.dvs[2] + (long long)key * a.dvs[1];
#pragma unroll
    for (int i = 0; i < NK; ++i)
      if (lane_col<DK>(lane, i)) krow[lane + 32 * i] = dka[i] * a.scale;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane_col<DV>(lane, i)) vrow[lane + 32 * i] = dva[i];
  }
}

// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, bool& smem_set, size_t smem, dim3 grid, int threads,
           cudaStream_t stream, const Args& a) {
  if (!smem_set && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DK, int DV>
int launch_d(bool is_bf16, int B, const Args& a, cudaStream_t stream) {
  static bool dq_set = false, kv_set = false, fdq_set = false, fkv_set = false;
  int err;
  if (is_bf16) {
    err = launch(flash_bwd_dq_bf16<DK, DV>, dq_set, dq_smem_bytes<DK, DV>(),
                 dim3(B * a.H, (a.Sq + DQ_ROWS - 1) / DQ_ROWS), THREADS, stream, a);
    if (err != 0) return err;
    return launch(flash_bwd_dkdv_bf16<DK, DV>, kv_set, dkdv_smem_bytes<DK, DV>(),
                  dim3(B * a.KVH, (a.Skv + KV_KEYS - 1) / KV_KEYS), THREADS, stream, a);
  }
  err = launch(flash_bwd_dq_f32<DK, DV>, fdq_set, f32_smem_bytes<DK, DV>(),
               dim3(B * a.H, (a.Sq + F_ROWS - 1) / F_ROWS), F_THREADS, stream, a);
  if (err != 0) return err;
  return launch(flash_bwd_dkdv_f32<DK, DV>, fkv_set, f32_smem_bytes<DK, DV>(),
                dim3(B * a.KVH, (a.Skv + F_ROWS - 1) / F_ROWS), F_THREADS, stream, a);
}

}  // namespace

extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, void* dq,
                                          void* dk, void* dv, float* lse, float* dsum,
                                          int is_bf16, int d, int dv_dim, int B, int H,
                                          int KVH, int Sq, int Skv, const long long* strides,
                                          int causal, int q_offset, float scale,
                                          void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = lse;
  a.dsum = dsum;
  a.H = H;
  a.KVH = KVH;
  a.Sq = Sq;
  a.Skv = Skv;
  a.causal = causal;
  a.q_offset = q_offset;
  a.scale = scale;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
    a.dos[i] = strides[12 + i];
    a.dqs[i] = strides[15 + i];
    a.dks[i] = strides[18 + i];
    a.dvs[i] = strides[21 + i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  const bool bf = is_bf16 != 0;
  if (d == dv_dim) {
    switch (d) {
      case 32: return launch_d<32, 32>(bf, B, a, st);
      case 64: return launch_d<64, 64>(bf, B, a, st);
      case 128: return launch_d<128, 128>(bf, B, a, st);
      case 160: return launch_d<160, 160>(bf, B, a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (d == 192 && dv_dim == 128) return launch_d<192, 128>(bf, B, a, st);
  if (d == 48 && dv_dim == 32) return launch_d<48, 32>(bf, B, a, st);
  return (int)cudaErrorInvalidValue;
}
