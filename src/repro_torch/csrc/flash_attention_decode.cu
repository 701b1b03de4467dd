// Split-KV flash decoding for Hopper: one query row a head (Sq == 1), bf16,
// d 32, 64, 128 and 160.
//
// Replaces, for every decode call, the Pallas TPU kernel
// `flash_attention_kernel` (src/repro/kernels/flash_attention/
// flash_attention.py:66, `pallas_call` at :79). It computes the same
// function as kernels/flash_attention/ref.py: s = (q . k^T) * d^-0.5 in
// fp32; where causal, only keys 0 .. q_offset are seen; p = exp(s - m)
// rounded to bf16 before the PV product; m, l and the accumulator in fp32;
// the output acc / max(l, 1e-30) rounded to bf16. Query head h reads kv
// head h / G, G = H / KV.
//
// Bound: bytes. A decode step reads the populated prefix of a layer's K
// and V once, about G FLOP a byte, far below the H100's ~295 a byte. What
// the design does about it:
//   - one block serves one (batch b, kv head, key split); its rows are the
//     G query heads of that kv head (at most 16), so each K/V byte is read
//     once a step;
//   - the populated prefix [0, n_keys) is cut into n_split <= 8 contiguous
//     ranges of ceil(n_keys / n_split) keys (the wrapper's
//     `decode_splits`), one a block, so that B * KV * n_split blocks fill
//     the card however long the cache is;
//   - a block is one warp. K and V go to shared memory in tiles of 32 keys
//     by cp.async (16 bytes a lane, keys past the split zero-filled), two
//     tiles in flight;
//   - both products run as mma.sync m16n8k16 (bf16 in, fp32 out) with the
//     G rows zero-padded to 16. The tensor cores are not needed for the
//     operations: they cut the instructions. A version on the CUDA cores
//     (a lane a key, bf16 converted to fp32 and multiplied element by
//     element) was bound by its arithmetic's issue and latency, not by the
//     bytes (PERF.md, on an H100 80GB HBM3 at 700 W); here a 32-key tile is
//     64 mma, 16 ldmatrix and the softmax;
//   - V's B fragments come from row-major tiles by ldmatrix .trans, and P
//     never leaves registers: S's accumulator, rounded to bf16, is the A
//     fragment of the PV product;
//   - the n_split blocks of one (b, kv head) are one thread-block cluster.
//     Each leaves its partial (m, l, acc) in its own shared memory; after
//     cluster.sync() block r reads every peer's partial through distributed
//     shared memory, in rank order 0, 1, 2 ..., for its share of the d
//     columns, merges as the online softmax does and writes the output. A
//     second cluster.sync() keeps every block resident until its peers are
//     done reading it. One launch, no workspace, no atomics: every sum has
//     a fixed order, so two runs give the same bits.
// A split with no keys (a prefix shorter than n_split ranges) still joins
// its cluster with m = -1e30, l = 0, acc = 0, and adds exactly 0.
//
// C entry: flash_attention_decode_launch(q, k, v, o, d, B, H, KV, n_keys,
// n_split, q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h, scale,
// stream): element strides (batch, [seq,] head) of q (B, 1, H, d), k and v
// (B, Skv, KV, d) and o (B, 1, H, d), head dim contiguous, data 16-byte
// aligned. Launches on `stream` with cudaLaunchKernelEx and returns the
// launch's error, else cudaGetLastError() (cudaErrorInvalidValue for a
// shape it lacks).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr int TK = 32;            // keys a tile
constexpr int STAGES = 2;         // tiles in flight: more took longer on the card
constexpr int ROWS = 16;          // the mma's M: the GQA group, zero-padded
constexpr int MAX_SPLITS = 8;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int G, KVH, n_keys, n_split;
  long long qb, qh, kb, ks, kh, vb, vs, vh, ob, oh;
  float scale;
};

// K and V, [STAGES][TK][D + 8] bf16 each (rows padded by 16 bytes, so the
// eight row addresses of an ldmatrix hit distinct banks). After the loop
// the split's partial (m[ROWS], l[ROWS], acc[ROWS][D] fp32) takes K's place.
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * (D + 8) * 2 * STAGES * TK;
}

// Every head dim it takes fits without opt-in shared memory, and its
// partial fits in K's space (d 160: 43,008 B; a partial of 10,368 B in
// 21,504).
template <int D>
constexpr bool fits() {
  return smem_bytes<D>() <= 48 * 1024 &&
         (2 * ROWS + ROWS * D) * 4 <= STAGES * TK * (D + 8) * 2;
}
static_assert(fits<32>() && fits<64>() && fits<128>() && fits<160>(),
              "no opt-in shared memory; the partial fits in K's space");

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared; `bytes` 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunks [C0, C0 + N) (16 bytes each) of the tile's TK key rows of K and V
// into shared memory, keys past the split zero-filled: lane l takes chunk
// C0 + l % N of rows l / N, l / N + 32 / N, ...
template <int N, int C0, int LD>
__device__ __forceinline__ void copy_chunks(bf16* kd, bf16* vd, const bf16* kbase,
                                            const bf16* vbase, long long ks,
                                            long long vs, int key0, int k1, int lane) {
  static_assert(32 % N == 0, "a row's chunks divide the warp");
  const int c = C0 + lane % N;
#pragma unroll
  for (int r = lane / N; r < TK; r += 32 / N) {
    const bool in = key0 + r < k1;
    const long long off = in ? (long long)(key0 + r) : 0;
    cp_async16(kd + r * LD + c * 8, kbase + off * ks + c * 8, in ? 16 : 0);
    cp_async16(vd + r * LD + c * 8, vbase + off * vs + c * 8, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(32) flash_decode(Args a) {
  constexpr int LD = D + 8, CH = D / 8, KSTEPS = D / 16, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);      // [STAGES][TK][LD]
  bf16* Vs = Ks + STAGES * TK * LD;              // [STAGES][TK][LD]
  float* part = reinterpret_cast<float*>(Ks);    // after the loop

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bk = blockIdx.x / a.n_split;
  const int b = bk / a.KVH, kvh = bk % a.KVH;
  const int G = a.G;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;

  const int per = (a.n_keys + a.n_split - 1) / a.n_split;
  const int k0 = min(rank * per, a.n_keys), k1 = min(k0 + per, a.n_keys);
  const int n_tiles = (k1 - k0 + TK - 1) / TK;
  const bf16* kbase = a.k + b * a.kb + kvh * a.kh;
  const bf16* vbase = a.v + b * a.vb + kvh * a.vh;

  auto issue = [&](int tile) {
    const int key0 = k0 + tile * TK;
    bf16* kd = Ks + (tile % STAGES) * TK * LD;
    bf16* vd = Vs + (tile % STAGES) * TK * LD;
    if constexpr (32 % CH == 0) {
      copy_chunks<CH, 0, LD>(kd, vd, kbase, vbase, a.ks, a.vs, key0, k1, lane);
    } else {  // d 160: a row's 20 chunks as 16 + 4, each dividing the warp
      copy_chunks<16, 0, LD>(kd, vd, kbase, vbase, a.ks, a.vs, key0, k1, lane);
      copy_chunks<CH - 16, 16, LD>(kd, vd, kbase, vbase, a.ks, a.vs, key0, k1, lane);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  // Q as the A fragments of S = Q K^T, straight from global memory: rows
  // g and g + 8 of the group (zero past G), columns 2t, 2t + 1 (+ 8).
  const bf16* qbase = a.q + b * a.qb + (long long)kvh * G * a.qh;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const bf16* p0 = qbase + g * a.qh + kk * 16 + t * 2;
    const bf16* p1 = p0 + 8 * a.qh;
    qa[kk][0] = g < G ? ld32(p0) : 0u;
    qa[kk][1] = g + 8 < G ? ld32(p1) : 0u;
    qa[kk][2] = g < G ? ld32(p0 + 8) : 0u;
    qa[kk][3] = g + 8 < G ? ld32(p1 + 8) : 0u;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + STAGES - 1 < n_tiles) issue(tile + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const bf16* kt = Ks + (tile % STAGES) * TK * LD;
    const bf16* vt = Vs + (tile % STAGES) * TK * LD;
    const int key0 = k0 + tile * TK;

    // S = Q K^T: 16 rows x 32 keys, four 16x8 tiles.
    float s[TK / 8][4];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < KSTEPS / 2; ++k2) {
        uint32_t bb[4];
        ldsm_x4(bb, kt + (n * 8 + (lane & 7)) * LD + (2 * k2 + (lane >> 4)) * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[n], qa[2 * k2], bb[0], bb[1]);
        mma_bf16(s[n], qa[2 * k2 + 1], bb[2], bb[3]);
      }
    }

    // Scale, mask keys past the split, online softmax (row g: e < 2).
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + n * 8 + t * 2 + (e & 1);
        const float x = col < k1 ? s[n][e] * a.scale : NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      mx[hr] = fmaxf(m_r[hr], mx[hr]);
      corr[hr] = expf(m_r[hr] - mx[hr]);
    }
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - mx[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
      l_r[hr] = l_r[hr] * corr[hr] + rs[hr];
      m_r[hr] = mx[hr];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += bf16(P) V, V's B fragments by transposing loads.
#pragma unroll
    for (int k2 = 0; k2 < TK / 16; ++k2) {
      const uint32_t pa[4] = {pack_bf16(s[2 * k2][0], s[2 * k2][1]),
                              pack_bf16(s[2 * k2][2], s[2 * k2][3]),
                              pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]),
                              pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, vt + (k2 * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                              (2 * n2 + (lane >> 4)) * 8);
        mma_bf16(acc[2 * n2], pa, bb[0], bb[1]);
        mma_bf16(acc[2 * n2 + 1], pa, bb[2], bb[3]);
      }
    }
    __syncwarp();  // this stage is free for a later tile
  }
  cp_async_wait<0>();
  __syncwarp();

  // This split's partial, then the cluster's merge.
  float* part_m = part;
  float* part_l = part + ROWS;
  float* part_acc = part + 2 * ROWS;
  if (t == 0) {
    part_m[g] = m_r[0], part_m[g + 8] = m_r[1];
    part_l[g] = l_r[0], part_l[g + 8] = l_r[1];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<float2*>(part_acc + g * D + n * 8 + t * 2) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(part_acc + (g + 8) * D + n * 8 + t * 2) =
        make_float2(acc[n][2], acc[n][3]);
  }
  cluster.sync();

  // Block `rank` merges its share of the d columns (ceil(d/2 / n_split)
  // pairs; the last ranks' shares may be short or empty, as at d 160 with
  // 3, 6 or 7 splits), every peer's partial read through distributed
  // shared memory in rank order.
  constexpr int PAIRS = D / 2;
  const int pairs_per = (PAIRS + a.n_split - 1) / a.n_split;
  const int p0 = min(rank * pairs_per, PAIRS);
  const int np = min(p0 + pairs_per, PAIRS) - p0;
  bf16* obase = a.o + b * a.ob + (long long)kvh * G * a.oh;
  for (int e = lane; e < G * np; e += 32) {
    const int row = e / np, pc = p0 + e % np;
    float pm[MAX_SPLITS], pl[MAX_SPLITS];
    float2 pv[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < a.n_split) {
        const float* peer = cluster.map_shared_rank(part, r);
        pm[r] = peer[row];
        pl[r] = peer[ROWS + row];
        pv[r] = *reinterpret_cast<const float2*>(peer + 2 * ROWS + row * D + 2 * pc);
      }
    }
    float m = NEG_INF, l = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < a.n_split) {
        const float m_new = fmaxf(m, pm[r]);
        const float c_old = expf(m - m_new), c_new = expf(pm[r] - m_new);
        l = l * c_old + pl[r] * c_new;
        o0 = o0 * c_old + pv[r].x * c_new;
        o1 = o1 * c_old + pv[r].y * c_new;
        m = m_new;
      }
    }
    const float den = fmaxf(l, 1e-30f);
    *reinterpret_cast<__nv_bfloat162*>(obase + row * a.oh + 2 * pc) =
        __floats2bfloat162_rn(o0 / den, o1 / den);
  }
  cluster.sync();  // no block leaves while a peer still reads its partial
}

template <int D>
int launch_d(const Args& a, int B, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.KVH * a.n_split, 1, 1);
  cfg.blockDim = dim3(32, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<D>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, flash_decode<D>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_decode_launch(
    const void* q, const void* k, const void* v, void* o, int d, int B, int H,
    int KVH, int n_keys, int n_split, long long q_b, long long q_h,
    long long k_b, long long k_s, long long k_h, long long v_b, long long v_s,
    long long v_h, long long o_b, long long o_h, float scale, void* stream) {
  if (B < 1 || KVH < 1 || H % KVH || H / KVH > ROWS || n_keys < 1 ||
      n_split < 1 || n_split > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.G = H / KVH;
  a.KVH = KVH;
  a.n_keys = n_keys;
  a.n_split = n_split;
  a.qb = q_b;
  a.qh = q_h;
  a.kb = k_b;
  a.ks = k_s;
  a.kh = k_h;
  a.vb = v_b;
  a.vs = v_s;
  a.vh = v_h;
  a.ob = o_b;
  a.oh = o_h;
  a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 32: return launch_d<32>(a, B, st);
    case 64: return launch_d<64>(a, B, st);
    case 128: return launch_d<128>(a, B, st);
    case 160: return launch_d<160>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
