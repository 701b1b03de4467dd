// FlashAttention-2 forward with GQA, causal masking and a q_offset window.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py, body `_kernel`,
// wrapper `ops.py::flash_attention_pallas`). It computes the same function:
// s = (q . k^T) * d^-0.5 in fp32; where causal, s = -1e30 at
// q_offset + q_row < k_col; a running max m, sum l and accumulator acc in
// fp32; p = exp(s - m_new) cast to v's dtype before the PV product; the
// output acc / max(l, 1e-30) cast to q's dtype. Query head h reads kv head
// h / (H / KV), which equals the Pallas index map n // group on the
// flattened b*H + h.
//
// Layout: the model's own (B, S, H, d) and (B, S, KV, d) tensors, addressed
// through the strides the wrapper passes, so nothing is transposed and a
// per-layer slice of the KV cache is read where it lies. The TPU grid's
// sequential kv axis becomes a loop inside the block: one block per
// (b*H + h, tile of query rows), blocks in no order, no state carried
// between them, no atomics, so two runs give the same bits.
//
// Bound: at prefill (B 8, H 16, S 2048, d 128, causal) the operations,
// 4*B*H*d*S(S+1)/2 = 1.37e11 per layer against 0.2 GB of q, k, v and o;
// the score tile never leaves registers. At decode (one query row per
// head) the bytes of the populated cache prefix, and the launch. The bf16
// instances therefore run both products on the tensor cores
// (mma.sync m16n8k16, fp32 accumulate) with K and V tiles staged in shared
// memory (V transposed, so each B fragment is one 32-bit load), and a
// causal block stops at the tile that holds key q_offset + its last row:
// the tiles it skips would add exactly 0 (exp(-1e30 - m) == 0 in fp32), so
// a decode step reads only the pos + 1 keys it attends to. The fp32
// instances, used to hold the kernel tight to the plain version, are a
// plain FMA loop (no TF32): one warp per query row, one key per lane.
//
// Instances: templated on q/k's head dim DK and v's DV: DK == DV at 32, 64,
// 128 and 160, and MLA's unequal pairs (DK, DV) = (192, 128)
// (deepseek-v2-236b: q/k heads of 128 nope + 64 rope columns, v heads of
// 128) and (48, 32) (its smoke config). Q . K^T contracts over DK; P V and
// the accumulator are DV wide, and so is the output. The bf16 instance's
// shared memory is Q and K tiles of 64 x (DK + 8) and V^T of DV x 72 bf16:
// 66,048 B at d 160 and 69,632 B at (192, 128), which launch() opts in to
// above the default 48 KB; its per-thread Q fragments and accumulator are
// DK/4 + DV/2 registers, 40 + 80 at d 160 and 48 + 64 at (192, 128)
// (ptxas's report: chip_smoke.py's `environment` line).
//
// C entry: flash_attention_launch(q, k, v, o, is_bf16, dk, dv, B, H, KV, Sq,
// Skv, strides, causal, q_offset, scale, stream); `strides` points to 12
// host int64 element strides, (batch, seq, head) of q, k, v and o in turn;
// the head dim is contiguous. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a dtype or (dk, dv) it
// lacks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, KVH, Sq, Skv, causal, q_offset;
  long long qs[3], ks[3], vs[3], os[3];  // (batch, seq, head) element strides
  float scale;
};

// Keys a block of query rows [q0, q0 + rows) needs: all of them, or, when
// causal, up to the key at q_offset + the block's last valid row.
__device__ __forceinline__ int kv_end(const Args& a, int q0, int rows) {
  if (!a.causal) return a.Skv;
  const int last_row = min(q0 + rows, a.Sq) - 1;
  return min(a.Skv, a.q_offset + last_row + 1);
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
// bf16: 4 warps x 16 query rows, kv tiles of 64, tensor-core products.
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int BF_THREADS = 128;

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

template <int DK, int DV>
constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         ((size_t)BQ * (DK + 8) + (size_t)BK * (DK + 8) + (size_t)DV * (BK + 8));
}

template <int DK, int DV>
__global__ void __launch_bounds__(BF_THREADS) flash_fwd_bf16(Args a) {
  // Rows padded by 8 elements (16 bytes): the fragment loads of a warp
  // (8 rows x 4 words) then fall on 32 distinct banks.
  constexpr int LDQ = DK + 8, LDK = DK + 8, LDV = BK + 8, CH = DK / 8, CHV = DV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LDQ]
  __nv_bfloat16* Ks = Qs + BQ * LDQ;                                // [BK][LDK]
  __nv_bfloat16* Vt = Ks + BK * LDK;                                // [DV][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + kvh * a.vs[2];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BQ * CH; i += BF_THREADS) {
    const int r = i / CH, c = i % CH;
    uint4 x = zero;
    if (q0 + r < a.Sq) x = *reinterpret_cast<const uint4*>(q + (long long)(q0 + r) * a.qs[1] + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c * 8) = x;
  }
  __syncthreads();

  // This warp's 16 rows of Q as A fragments, kept in registers.
  const int r0 = warp * 16 + g;
  uint32_t qa[DK / 16][4];
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const __nv_bfloat16* p0 = Qs + r0 * LDQ + kk * 16 + t * 2;
    qa[kk][0] = ld32(p0);
    qa[kk][1] = ld32(p0 + 8 * LDQ);
    qa[kk][2] = ld32(p0 + 8);
    qa[kk][3] = ld32(p0 + 8 * LDQ + 8);
  }

  float acc[DV / 8][4];
#pragma unroll
  for (int dn = 0; dn < DV / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const int row_abs[2] = {a.q_offset + q0 + r0, a.q_offset + q0 + r0 + 8};
  const int end = kv_end(a, q0, BQ);

  for (int kv0 = 0; kv0 < end; kv0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * CH; i += BF_THREADS) {
      const int r = i / CH, c = i % CH;  // row-major: coalesced K reads
      uint4 x = zero;
      if (kv0 + r < a.Skv) x = *reinterpret_cast<const uint4*>(k + (long long)(kv0 + r) * a.ks[1] + c * 8);
      *reinterpret_cast<uint4*>(Ks + r * LDK + c * 8) = x;
    }
    for (int i = tid; i < BK * CHV; i += BF_THREADS) {
      const int r = i % BK, c = i / BK;  // key-major: conflict-free Vt stores
      uint4 x = zero;
      if (kv0 + r < a.Skv) x = *reinterpret_cast<const uint4*>(v + (long long)(kv0 + r) * a.vs[1] + c * 8);
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c * 8 + e) * LDV + r] = xe[e];
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: eight 16x8 accumulator tiles.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kp = Ks + (n * 8 + g) * LDK + t * 2;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) mma_bf16(s[n], qa[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
    }

    // Scale, mask, online softmax. Element e of a tile is row g + 8*(e>>1),
    // column t*2 + (e&1); the four lanes of a group share a row.
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + n * 8 + t * 2 + (e & 1);
        float x = s[n][e] * a.scale;
        if (col >= a.Skv || (a.causal && row_abs[e >> 1] < col)) x = NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_new[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      m_new[hr] = fmaxf(m_r[hr], mx[hr]);
      corr[hr] = expf(m_r[hr] - m_new[hr]);
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_new[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
      l_r[hr] = l_r[hr] * corr[hr] + rs[hr];
      m_r[hr] = m_new[hr];
    }
#pragma unroll
    for (int dn = 0; dn < DV / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }

    // acc += bf16(P) V: the S accumulator tiles are already laid out as
    // the A fragments of P (two 16x8 tiles make one 16x16 fragment).
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DV / 8; ++dn) {
        const __nv_bfloat16* vp = Vt + (dn * 8 + g) * LDV + kk * 16 + t * 2;
        mma_bf16(acc[dn], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.os[0] + h * a.os[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + 8 * hr;
    if (row >= a.Sq) continue;
    const float den = fmaxf(l_r[hr], 1e-30f);
    __nv_bfloat16* orow = o + (long long)row * a.os[1] + t * 2;
#pragma unroll
    for (int dn = 0; dn < DV / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8) =
          pack_bf16(acc[dn][2 * hr] / den, acc[dn][2 * hr + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: a plain FMA loop, one warp per query row, one key per lane.
// ---------------------------------------------------------------------------

constexpr int F_ROWS = 8;
constexpr int F_BK = 32;
constexpr int F_THREADS = 32 * F_ROWS;

template <int DK, int DV>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)F_ROWS * DK + (size_t)F_BK * (DK + 1) + (size_t)F_BK * DV);
}

template <int DK, int DV>
__global__ void __launch_bounds__(F_THREADS) flash_fwd_f32(Args a) {
  constexpr int LDK = DK + 1;  // lane j reads row j: odd stride, no conflicts
  extern __shared__ float fsm[];
  float* Qs = fsm;                // [F_ROWS][DK]
  float* Ks = Qs + F_ROWS * DK;   // [F_BK][LDK]
  float* Vs = Ks + F_BK * LDK;    // [F_BK][DV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F_ROWS;
  const float* q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const float* k = static_cast<const float*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const float* v = static_cast<const float*>(a.v) + b * a.vs[0] + kvh * a.vs[2];

  for (int i = tid; i < F_ROWS * DK; i += F_THREADS) {
    const int r = i / DK, c = i % DK;
    Qs[i] = (q0 + r < a.Sq) ? q[(long long)(q0 + r) * a.qs[1] + c] : 0.f;
  }
  const int row = q0 + warp;
  const int row_abs = a.q_offset + row;
  float acc[DV / 32];
#pragma unroll
  for (int i = 0; i < DV / 32; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;
  const int end = kv_end(a, q0, F_ROWS);

  for (int kv0 = 0; kv0 < end; kv0 += F_BK) {
    __syncthreads();
    for (int i = tid; i < F_BK * DK; i += F_THREADS) {
      const int r = i / DK, c = i % DK;
      Ks[r * LDK + c] = kv0 + r < a.Skv ? k[(long long)(kv0 + r) * a.ks[1] + c] : 0.f;
    }
    for (int i = tid; i < F_BK * DV; i += F_THREADS) {
      const int r = i / DV, c = i % DV;
      Vs[i] = kv0 + r < a.Skv ? v[(long long)(kv0 + r) * a.vs[1] + c] : 0.f;
    }
    __syncthreads();

    const int col = kv0 + lane;
    float sc = 0.f;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) sc = fmaf(Qs[warp * DK + d], Ks[lane * LDK + d], sc);
    sc *= a.scale;
    if (col >= a.Skv || (a.causal && row_abs < col)) sc = NEG_INF;
    const float m_new = fmaxf(m, warp_max(sc));
    const float corr = expf(m - m_new);
    const float p = expf(sc - m_new);
    l = l * corr + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int i = 0; i < DV / 32; ++i) acc[i] *= corr;
    for (int j = 0; j < F_BK; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < DV / 32; ++i) acc[i] = fmaf(pj, Vs[j * DV + lane + 32 * i], acc[i]);
    }
  }

  if (row < a.Sq) {
    float* orow = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[2] + (long long)row * a.os[1];
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DV / 32; ++i) orow[lane + 32 * i] = acc[i] / den;
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
  static bool bf16_set = false, f32_set = false;
  if (is_bf16) {
    const dim3 grid(B * a.H, (a.Sq + BQ - 1) / BQ);
    return launch(flash_fwd_bf16<DK, DV>, bf16_set, bf16_smem_bytes<DK, DV>(), grid,
                  BF_THREADS, stream, a);
  }
  const dim3 grid(B * a.H, (a.Sq + F_ROWS - 1) / F_ROWS);
  return launch(flash_fwd_f32<DK, DV>, f32_set, f32_smem_bytes<DK, DV>(), grid,
                F_THREADS, stream, a);
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int is_bf16,
                                      int dk, int dv, int B, int H, int KVH,
                                      int Sq, int Skv, const long long* strides,
                                      int causal, int q_offset, float scale,
                                      void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
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
  }
  cudaStream_t st = (cudaStream_t)stream;
  const bool bf = is_bf16 != 0;
  if (dk == dv) {
    switch (dk) {
      case 32: return launch_d<32, 32>(bf, B, a, st);
      case 64: return launch_d<64, 64>(bf, B, a, st);
      case 128: return launch_d<128, 128>(bf, B, a, st);
      case 160: return launch_d<160, 160>(bf, B, a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dk == 192 && dv == 128) return launch_d<192, 128>(bf, B, a, st);
  if (dk == 48 && dv == 32) return launch_d<48, 32>(bf, B, a, st);
  return (int)cudaErrorInvalidValue;
}
