// Per-edge spatio-temporal predicate scan with fused aggregation: the
// per-edge query engine of the store (the paper's InfluxDB role, §3.5.2).
//
// Replaces the Pallas TPU kernel `st_scan_kernel`
// (src/repro/kernels/st_scan/st_scan.py, body `_kernel`, wrapper
// `ops.py::st_scan`). The TPU kernel walks a sequential (E, Q/BQ, C/BC) grid
// and carries its accumulators across the C steps in revisited output
// tiles. Here one thread block owns one (query tile of BQ queries, edge)
// pair and loops over the edge's slots itself; nothing is carried between
// blocks, so no atomics and no second pass.
//
// What it computes, for every query q of the tile and edge e: over the live
// slots `slot < n_valid = min(count[e], valid_c)` (slots beyond are dead by
// the ring contract, so the loop simply ends there), the tuples passing the
// AND/OR of the bbox / time-window / sid-equality tests AND the (q, e) shard
// OR-list (len > 0: sid among the first len entries; 0: edge not selected;
// < 0: scan all) — their count and, per requested channel (log rows
// `rows[k]`), sum, min and max. Empty: count 0, sum 0, min +inf, max -inf.
//
// Bound: bytes. Each live slot of a selected edge costs 5 words (t, lat,
// lon, two sid words) plus K channel words when some query of the tile
// matches it, against a few compares per (slot, query). Design:
//  * the column-major log (E, 3+V, C) makes neighbouring threads read
//    neighbouring slots of one field row: every load is coalesced;
//  * a tile serves BQ queries per pass over the log, dividing log traffic by
//    BQ; the channel words are loaded only for slots some query matched;
//  * a block whose queries all have len == 0 on its edge writes the empty
//    sentinels and exits without reading the log (most (q, e) pairs are
//    unselected);
//  * the tile's OR-lists live in shared memory (BQ * L * 2 int32, 4 KB at
//    BQ = 4, L = 128). The membership test is a linear scan over up to L
//    entries, run only for slots that already passed the predicate; sorting
//    the lists for a binary search is later work.
// Per-thread partials (BQ * (1 + 3K) registers; BQ = 8 for K <= 2 and 4 for
// K = 3..4) are reduced in a fixed order — warp butterfly shuffles, then the
// warps' results summed in warp order by one thread per query — with no float
// atomics, so a rerun is bitwise identical.
//
// C entry: st_scan_launch(...) launches on `stream` and returns
// cudaGetLastError(). Outputs: count (Q, E) int32 and sum/min/max
// (Q, k_total, E) float32, of which this launch writes channel rows
// [k_off, k_off + K). Q must be a multiple of 8 (the wrapper pads).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 4;

struct Rows {
  int r[kMaxK];
};

template <int BQ, int K>
__global__ void __launch_bounds__(kThreads)
st_scan_kernel(const float* __restrict__ tup_f, const int32_t* __restrict__ tup_sid,
               const int32_t* __restrict__ tup_count,
               const float* __restrict__ pred_f, const int32_t* __restrict__ pred_i,
               const int32_t* __restrict__ sublists,
               const int32_t* __restrict__ sublist_len, int E, int W, int C,
               int L, int valid_c, Rows rows, int32_t* __restrict__ out_count,
               float* __restrict__ out_sum, float* __restrict__ out_min,
               float* __restrict__ out_max, int k_total, int k_off) {
  const int q0 = blockIdx.x * BQ;
  const int e = blockIdx.y;
  const int tid = threadIdx.x;

  __shared__ float s_pf[BQ][6];
  __shared__ int32_t s_pi[BQ][6];
  __shared__ int32_t s_len[BQ];
  __shared__ int32_t s_cnt[kWarps][BQ];
  __shared__ float s_sum[kWarps][BQ][K];
  __shared__ float s_min[kWarps][BQ][K];
  __shared__ float s_max[kWarps][BQ][K];
  extern __shared__ int32_t s_list[];        // [BQ][L][2]

  if (tid < BQ) {
    const int q = q0 + tid;
    s_len[tid] = sublist_len[(size_t)q * E + e];
    for (int j = 0; j < 6; ++j) {
      s_pf[tid][j] = pred_f[q * 8 + j];
      s_pi[tid][j] = pred_i[q * 8 + j];
    }
  }
  __syncthreads();

  bool any_selected = false;
#pragma unroll
  for (int qq = 0; qq < BQ; ++qq) any_selected |= (s_len[qq] != 0);
  if (!any_selected) {
    if (tid < BQ) {
      const int q = q0 + tid;
      out_count[(size_t)q * E + e] = 0;
      for (int k = 0; k < K; ++k) {
        const size_t o = ((size_t)q * k_total + k_off + k) * E + e;
        out_sum[o] = 0.0f;
        out_min[o] = INFINITY;
        out_max[o] = -INFINITY;
      }
    }
    return;
  }

  for (int idx = tid; idx < BQ * L; idx += kThreads) {
    const int qq = idx / L;
    const int j = idx - qq * L;
    const int len = abs(s_len[qq]);
    if (j < len) {
      const size_t src = (((size_t)(q0 + qq) * E + e) * L + j) * 2;
      s_list[2 * idx] = sublists[src];
      s_list[2 * idx + 1] = sublists[src + 1];
    }
  }
  __syncthreads();

  int cnt[BQ];
  float vsum[BQ][K], vmin[BQ][K], vmax[BQ][K];
#pragma unroll
  for (int qq = 0; qq < BQ; ++qq) {
    cnt[qq] = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      vsum[qq][k] = 0.0f;
      vmin[qq][k] = INFINITY;
      vmax[qq][k] = -INFINITY;
    }
  }

  const int n_valid = min(tup_count[e], valid_c);
  const float* f_t = tup_f + (size_t)e * W * C;
  const int32_t* s_hi = tup_sid + (size_t)e * 2 * C;
  const int32_t* s_lo = s_hi + C;
  for (int c = tid; c < n_valid; c += kThreads) {
    const float t = f_t[c];
    const float lat = f_t[(size_t)C + c];
    const float lon = f_t[2 * (size_t)C + c];
    const int32_t shi = s_hi[c];
    const int32_t slo = s_lo[c];
    bool loaded = false;
    float v[K];
#pragma unroll
    for (int qq = 0; qq < BQ; ++qq) {
      const int len = s_len[qq];
      if (len == 0) continue;
      const bool sp = (s_pf[qq][0] <= lat) & (lat <= s_pf[qq][1]) &
                      (s_pf[qq][2] <= lon) & (lon <= s_pf[qq][3]);
      const bool tp = (s_pf[qq][4] <= t) & (t <= s_pf[qq][5]);
      const bool ip = (shi == s_pi[qq][0]) & (slo == s_pi[qq][1]);
      const bool hs = s_pi[qq][2] != 0, ht = s_pi[qq][3] != 0,
                 hi = s_pi[qq][4] != 0;
      const bool pm = s_pi[qq][5] != 0
                          ? ((sp | !hs) & (tp | !ht) & (ip | !hi))
                          : ((sp & hs) | (tp & ht) | (ip & hi));
      if (!pm) continue;
      if (len > 0) {
        const int32_t* lst = s_list + 2 * qq * L;
        bool found = false;
        for (int j = 0; j < len; ++j)
          found |= (lst[2 * j] == shi) & (lst[2 * j + 1] == slo);
        if (!found) continue;
      }
      if (!loaded) {
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = f_t[(size_t)rows.r[k] * C + c];
        loaded = true;
      }
      cnt[qq] += 1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        vsum[qq][k] += v[k];
        vmin[qq][k] = fminf(vmin[qq][k], v[k]);
        vmax[qq][k] = fmaxf(vmax[qq][k], v[k]);
      }
    }
  }

  // Fixed-order reduction: butterfly within each warp, then warps in order.
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int qq = 0; qq < BQ; ++qq) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cnt[qq] += __shfl_xor_sync(0xffffffffu, cnt[qq], off);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        vsum[qq][k] += __shfl_xor_sync(0xffffffffu, vsum[qq][k], off);
        vmin[qq][k] = fminf(vmin[qq][k],
                            __shfl_xor_sync(0xffffffffu, vmin[qq][k], off));
        vmax[qq][k] = fmaxf(vmax[qq][k],
                            __shfl_xor_sync(0xffffffffu, vmax[qq][k], off));
      }
    }
    if (lane == 0) {
      s_cnt[warp][qq] = cnt[qq];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        s_sum[warp][qq][k] = vsum[qq][k];
        s_min[warp][qq][k] = vmin[qq][k];
        s_max[warp][qq][k] = vmax[qq][k];
      }
    }
  }
  __syncthreads();
  if (tid < BQ) {
    const int qq = tid;
    const int q = q0 + qq;
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_cnt[w][qq];
    out_count[(size_t)q * E + e] = total;
    for (int k = 0; k < K; ++k) {
      float sm = 0.0f, mn = INFINITY, mx = -INFINITY;
      for (int w = 0; w < kWarps; ++w) {
        sm += s_sum[w][qq][k];
        mn = fminf(mn, s_min[w][qq][k]);
        mx = fmaxf(mx, s_max[w][qq][k]);
      }
      const size_t o = ((size_t)q * k_total + k_off + k) * E + e;
      out_sum[o] = sm;
      out_min[o] = mn;
      out_max[o] = mx;
    }
  }
}

template <int BQ, int K>
int launch(const void* tup_f, const void* tup_sid, const void* tup_count,
           const void* pred_f, const void* pred_i, const void* sublists,
           const void* sublist_len, int E, int W, int C, int Q, int L,
           int valid_c, Rows rows, void* out_count, void* out_sum,
           void* out_min, void* out_max, int k_total, int k_off,
           cudaStream_t stream) {
  if (Q % BQ != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)BQ * L * 2 * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        st_scan_kernel<BQ, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(Q / BQ, E);
  st_scan_kernel<BQ, K><<<grid, kThreads, smem, stream>>>(
      (const float*)tup_f, (const int32_t*)tup_sid, (const int32_t*)tup_count,
      (const float*)pred_f, (const int32_t*)pred_i, (const int32_t*)sublists,
      (const int32_t*)sublist_len, E, W, C, L, valid_c, rows,
      (int32_t*)out_count, (float*)out_sum, (float*)out_min, (float*)out_max,
      k_total, k_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int st_scan_launch(const void* tup_f, const void* tup_sid,
                              const void* tup_count, const void* pred_f,
                              const void* pred_i, const void* sublists,
                              const void* sublist_len, int E, int W, int C,
                              int Q, int L, int valid_c, int K, int r0, int r1,
                              int r2, int r3, void* out_count, void* out_sum,
                              void* out_min, void* out_max, int k_total,
                              int k_off, void* stream) {
  Rows rows = {{r0, r1, r2, r3}};
  for (int k = 0; k < K; ++k)
    if (rows.r[k] < 3 || rows.r[k] >= W) return (int)cudaErrorInvalidValue;
  if (E < 1 || E > 65535 || Q < 0 || L < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define ST_SCAN_ARGS                                                      \
  tup_f, tup_sid, tup_count, pred_f, pred_i, sublists, sublist_len, E, W, \
      C, Q, L, valid_c, rows, out_count, out_sum, out_min, out_max,       \
      k_total, k_off, s
  switch (K) {
    case 1: return launch<8, 1>(ST_SCAN_ARGS);
    case 2: return launch<8, 2>(ST_SCAN_ARGS);
    case 3: return launch<4, 3>(ST_SCAN_ARGS);
    case 4: return launch<4, 4>(ST_SCAN_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ST_SCAN_ARGS
}
