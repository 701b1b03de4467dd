// Per-edge spatio-temporal predicate scan with fused aggregation: the
// per-edge query engine of the store (the paper's InfluxDB role, §3.5.2).
//
// Replaces the Pallas TPU kernel `st_scan_kernel`
// (src/repro/kernels/st_scan/st_scan.py, body `_kernel`, wrapper
// `ops.py::st_scan`).
//
// What it computes, for every query q and edge e: over the live slots
// `slot < n_valid = min(count[e], valid_c)`, the tuples passing the AND/OR
// of the bbox / time-window / sid-equality tests AND the (q, e) shard
// OR-list (len > 0: sid among the first len entries; 0: edge not selected;
// < 0: scan all) — their count and, per requested channel (log rows
// `rows[k]`), sum, min and max. Empty: count 0, sum 0, min +inf, max -inf.
// A NaN channel word of a matched slot makes that channel's sum, min and
// max NaN (NaN-propagating min/max, as the reference's jnp.min).
//
// Bound: bytes. Each live slot of a selected edge costs 5 words (t, lat,
// lon, two sid words), plus K channel words where some query matches it.
// The TPU kernel's grid (E, Q/BQ, C/BC) walked each edge's log once per
// query tile; on this card that multiplies the bytes and the instructions
// by Q/BQ. Here:
//  * one pass over each edge's live slots serves the whole batch: the
//    queries that select the edge (len != 0) are compacted once, in groups
//    of QG = 64 (a batch above 64 queries takes one pass per group);
//  * the edge's live slots are split among the S blocks of a thread-block
//    cluster, and each warp of a block walks its own tiles of 128 slots
//    (four a lane, neighbouring lanes on neighbouring slots of one row),
//    with no block barrier between the group's start and its merge;
//  * each tile is summarised from its own data, in registers and warp
//    votes: the min and max of t, lat and lon over non-NaN values, and its
//    runs of equal sid (the store writes a shard's records on consecutive
//    slots). A query is skipped for the tile when no slot can match it: an
//    AND query whose enabled test misses the tile's box, window or runs; an
//    OR query all of whose enabled tests miss; a listed query none of whose
//    listed sids is a run of the tile. NaN fields fail every comparison, so
//    the summaries are exact on any data; an unsorted or wrapped log only
//    prunes less;
//  * list membership is tested once per (tile, query), by the lanes holding
//    32 list entries each and voting over the tile's runs; a slot reads its
//    run's bit. A tile of more than 32 runs (unsorted data) tests each slot
//    against the list instead;
//  * channel words are read only for matched slots; a warp's matches are
//    reduced by butterfly shuffles into its own accumulators in shared
//    memory;
//  * the blocks' partials are merged in rank order through distributed
//    shared memory between two cluster barriers.
// Every sum is taken in a fixed order (slots of a thread, butterfly, tiles,
// warps, ranks), with no float atomics: a rerun is bitwise identical.
//
// C entry: st_scan_launch(...) launches on `stream` and returns
// cudaGetLastError(). Outputs: count (Q, E) int32 and sum/min/max
// (Q, k_total, E) float32, of which this launch writes channel rows
// [k_off, k_off + K).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotsPerLane = 4;
constexpr int kTile = 32 * kSlotsPerLane;           // 128 slots, one warp's
constexpr int kGroup = 64;                          // queries per pass
constexpr int kMaxRuns = 32;                        // runs a tile summarises
constexpr int kMaxK = 4;
constexpr int kMaxSplits = 8;                       // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

// min and max that return NaN when either operand is NaN, as jnp.minimum /
// torch.amin do (fminf and fmaxf return the other operand).
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

struct Params {
  const float* tup_f;
  const int32_t* tup_sid;
  const int32_t* tup_count;
  const float* pred_f;      // (Q, 8): lat0, lat1, lon0, lon1, t0, t1, -, -
  const int32_t* pred_i;    // (Q, 8): sid_hi, sid_lo, has_s, has_t, has_i, is_and
  const int32_t* sublists;  // (Q, E, L, 2)
  const int32_t* sublist_len;
  int E, W, C, Q, L, valid_c, k_total, k_off;
  int rows[kMaxK];
  int32_t* out_count;
  float* out_sum;
  float* out_min;
  float* out_max;
};

// Predicate flags packed per selected query.
enum : int { kHasS = 1, kHasT = 2, kHasI = 4, kAnd = 8 };

template <int K>
struct Smem {
  // the group's selected queries
  int q[kGroup];
  float pf[kGroup][6];
  int sid[kGroup][2];
  int flags[kGroup];
  int len[kGroup];          // |len| clamped to L, or -1 for scan-all
  int n_sel;
  // each warp's tile: the sids of its runs
  int run_sid[kWarps][kMaxRuns][2];
  // accumulators: per warp, then the block's partial for the cluster merge
  int acc_cnt[kWarps][kGroup];
  float acc[kWarps][kGroup][3][K];
  int part_cnt[kGroup];
  float part[kGroup][3][K];
};

__device__ __forceinline__ bool range_miss(float lo, float hi, float mn,
                                           float mx) {
  // No finite value v of [mn, mx] satisfies lo <= v <= hi. NaN bounds make
  // the comparisons false and so never prune (the evaluation rejects them).
  return hi < mn || lo > mx;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 3)
st_scan_kernel(const Params p) {
  __shared__ Smem<K> sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int e = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int n_valid = min(max(p.tup_count[e], 0), p.valid_c);
  const int n_tiles = (n_valid + kTile - 1) / kTile;
  const int per = (n_tiles + S - 1) / S;
  const int tile_lo = min(rank * per, n_tiles);
  const int tile_hi = min(tile_lo + per, n_tiles);
  const float* f_t = p.tup_f + (size_t)e * p.W * p.C;
  const float* f_lat = f_t + p.C;
  const float* f_lon = f_t + 2 * (size_t)p.C;
  const int32_t* s_hi = p.tup_sid + (size_t)e * 2 * p.C;
  const int32_t* s_lo = s_hi + p.C;

  for (int qbase = 0; qbase < p.Q; qbase += kGroup) {
    __syncthreads();   // the last group's readers are done with the tables
    // -- the group's queries that select this edge, compacted in order ----
    if (warp == 0) {
      int n_sel = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = qbase + h * 32 + lane;
        const int len = q < p.Q ? p.sublist_len[(size_t)q * p.E + e] : 0;
        const uint32_t sel = __ballot_sync(kFull, len != 0);
        if (len != 0) {
          const int i = n_sel + __popc(sel & ((1u << lane) - 1));
          const float* pf = p.pred_f + (size_t)q * 8;
          const int32_t* pi = p.pred_i + (size_t)q * 8;
          sm.q[i] = q;
#pragma unroll
          for (int j = 0; j < 6; ++j) sm.pf[i][j] = pf[j];
          sm.sid[i][0] = pi[0];
          sm.sid[i][1] = pi[1];
          sm.flags[i] = (pi[2] ? kHasS : 0) | (pi[3] ? kHasT : 0) |
                        (pi[4] ? kHasI : 0) | (pi[5] ? kAnd : 0);
          sm.len[i] = len < 0 ? -1 : min(len, p.L);
        } else if (q < p.Q && q % S == rank) {
          // not selected: the empty sentinels, written by one rank
          p.out_count[(size_t)q * p.E + e] = 0;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const size_t o = ((size_t)q * p.k_total + p.k_off + k) * p.E + e;
            p.out_sum[o] = 0.0f;
            p.out_min[o] = INFINITY;
            p.out_max[o] = -INFINITY;
          }
        }
        n_sel += __popc(sel);
      }
      if (lane == 0) sm.n_sel = n_sel;
    }
    for (int idx = tid; idx < kWarps * kGroup; idx += kThreads) {
      (&sm.acc_cnt[0][0])[idx] = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        (&sm.acc[0][0][0][0])[idx * 3 * K + k] = 0.0f;
        (&sm.acc[0][0][0][0])[idx * 3 * K + K + k] = INFINITY;
        (&sm.acc[0][0][0][0])[idx * 3 * K + 2 * K + k] = -INFINITY;
      }
    }
    __syncthreads();
    const int n_sel = sm.n_sel;   // the same in every block of the cluster
    if (n_sel == 0) continue;

    // Each warp walks its own tiles: no block barrier until the merge.
    for (int tile = tile_lo + warp; tile < tile_hi; tile += kWarps) {
      const int base = tile * kTile;
      // -- the five hot rows of my four slots (slot base + 32 j + lane) -----
      float t[kSlotsPerLane], la[kSlotsPerLane], lo[kSlotsPerLane];
      int hi[kSlotsPerLane], sl[kSlotsPerLane];
      uint32_t live = 0;
#pragma unroll
      for (int j = 0; j < kSlotsPerLane; ++j) {
        const int s = base + j * 32 + lane;
        if (s < n_valid) {
          live |= 1u << j;
          t[j] = f_t[s];
          la[j] = f_lat[s];
          lo[j] = f_lon[s];
          hi[j] = s_hi[s];
          sl[j] = s_lo[s];
        } else {
          t[j] = la[j] = lo[j] = NAN;
          hi[j] = sl[j] = 0;
        }
      }
      // -- summary: runs of equal sid, and the box of non-NaN values -------
      int run[kSlotsPerLane];
      int n_runs = 0;
      float bx[6] = {INFINITY, -INFINITY, INFINITY, -INFINITY, INFINITY,
                     -INFINITY};
#pragma unroll
      for (int j = 0; j < kSlotsPerLane; ++j) {
        // the slot before mine: lane - 1 of this row, or lane 31 of the last
        int ph = __shfl_up_sync(kFull, hi[j], 1);
        int pl = __shfl_up_sync(kFull, sl[j], 1);
        if (j > 0) {
          const int h31 = __shfl_sync(kFull, hi[j - 1], 31);
          const int l31 = __shfl_sync(kFull, sl[j - 1], 31);
          if (lane == 0) {
            ph = h31;
            pl = l31;
          }
        }
        const bool first = j == 0 && lane == 0;
        const bool start = ((live >> j) & 1) &&
                           (first || hi[j] != ph || sl[j] != pl);
        const uint32_t b = __ballot_sync(kFull, start);
        run[j] = n_runs + __popc(b & ((2u << lane) - 1)) - 1;
        if (start && run[j] < kMaxRuns) {
          sm.run_sid[warp][run[j]][0] = hi[j];
          sm.run_sid[warp][run[j]][1] = sl[j];
        }
        n_runs += __popc(b);
        // fminf / fmaxf skip NaN: the box holds non-NaN values only
        bx[0] = fminf(bx[0], t[j]);
        bx[1] = fmaxf(bx[1], t[j]);
        bx[2] = fminf(bx[2], la[j]);
        bx[3] = fmaxf(bx[3], la[j]);
        bx[4] = fminf(bx[4], lo[j]);
        bx[5] = fmaxf(bx[5], lo[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int v = 0; v < 6; v += 2) {
          bx[v] = fminf(bx[v], __shfl_xor_sync(kFull, bx[v], off));
          bx[v + 1] = fmaxf(bx[v + 1], __shfl_xor_sync(kFull, bx[v + 1], off));
        }
      }
      __syncwarp();
      const bool few_runs = n_runs <= kMaxRuns;
      const int (*runs)[2] = sm.run_sid[warp];
      // -- which queries can match in this tile: lane i%32 tests query i ---
      uint32_t cand[2], act[2], my_mask[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = h * 32 + lane;
        bool possible = false;
        if (i < n_sel) {
          const float* pf = sm.pf[i];
          const int fl = sm.flags[i];
          const bool s_miss = range_miss(pf[0], pf[1], bx[2], bx[3]) ||
                              range_miss(pf[2], pf[3], bx[4], bx[5]);
          const bool t_miss = range_miss(pf[4], pf[5], bx[0], bx[1]);
          bool i_miss = false;
          if ((fl & kHasI) && few_runs) {
            i_miss = true;
            for (int r = 0; r < n_runs; ++r)
              i_miss &= !(runs[r][0] == sm.sid[i][0] && runs[r][1] == sm.sid[i][1]);
          }
          const bool hs = fl & kHasS, ht = fl & kHasT, hsid = fl & kHasI;
          possible = (fl & kAnd)
                         ? !((hs && s_miss) || (ht && t_miss) || (hsid && i_miss))
                         : ((hs && !s_miss) || (ht && !t_miss) || (hsid && !i_miss));
          possible &= sm.len[i] != 0;   // a list of length > 0 when L is 0
        }
        const bool listed = i < n_sel && sm.len[i] > 0 && few_runs;
        cand[h] = __ballot_sync(kFull, possible && listed);
        act[h] = __ballot_sync(kFull, possible && !listed);
        my_mask[h] = kFull;
      }
      // -- list membership of the tile's runs, one candidate at a time -----
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        for (uint32_t bits = cand[h]; bits; bits &= bits - 1) {
          const int b = __ffs(bits) - 1;
          const int i = h * 32 + b;
          const int len = sm.len[i];
          const int2* lst = reinterpret_cast<const int2*>(
              p.sublists + ((size_t)sm.q[i] * p.E + e) * p.L * 2);
          uint32_t mask = 0;
          for (int j0 = 0; j0 < len; j0 += 32) {
            const bool ok = j0 + lane < len;
            const int2 ent = ok ? lst[j0 + lane] : make_int2(0, 0);
            for (int r = 0; r < n_runs; ++r) {
              const bool eq = ok && ent.x == runs[r][0] && ent.y == runs[r][1];
              if (__ballot_sync(kFull, eq)) mask |= 1u << r;
            }
          }
          if (lane == b) my_mask[h] = mask;
          if (mask) act[h] |= 1u << b;
        }
      }
      // -- evaluate the active queries on my slots -------------------------
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        for (uint32_t abits = act[h]; abits; abits &= abits - 1) {
          const int b = __ffs(abits) - 1;
          const int i = h * 32 + b;
          const uint32_t mask = __shfl_sync(kFull, my_mask[h], b);
          const float* pf = sm.pf[i];
          const float lat0 = pf[0], lat1 = pf[1], lon0 = pf[2], lon1 = pf[3],
                      t0 = pf[4], t1 = pf[5];
          const int fl = sm.flags[i];
          const int qh = sm.sid[i][0], ql = sm.sid[i][1];
          const int len = sm.len[i];
          const bool slow = len > 0 && !few_runs;
          const bool hs = fl & kHasS, ht = fl & kHasT, hsid = fl & kHasI;
          uint32_t bits = 0;
#pragma unroll
          for (int j = 0; j < kSlotsPerLane; ++j) {
            const bool sp = (lat0 <= la[j]) & (la[j] <= lat1) &
                            (lon0 <= lo[j]) & (lo[j] <= lon1);
            const bool tp = (t0 <= t[j]) & (t[j] <= t1);
            const bool ip = (hi[j] == qh) & (sl[j] == ql);
            const bool pm = (fl & kAnd)
                                ? ((sp | !hs) & (tp | !ht) & (ip | !hsid))
                                : ((sp & hs) | (tp & ht) | (ip & hsid));
            bool m = ((live >> j) & 1) && pm;
            if (m && slow) {
              const int2* lst = reinterpret_cast<const int2*>(
                  p.sublists + ((size_t)sm.q[i] * p.E + e) * p.L * 2);
              bool found = false;
              for (int jj = 0; jj < len && !found; ++jj) {
                const int2 ent = lst[jj];
                found = ent.x == hi[j] && ent.y == sl[j];
              }
              m = found;
            } else if (m && len > 0) {
              m = (mask >> run[j]) & 1;
            }
            bits |= (uint32_t)m << j;
          }
          if (!__any_sync(kFull, bits != 0)) continue;
          int cnt = __popc(bits);
          float vs[K], vn[K], vx[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            vs[k] = 0.0f;
            vn[k] = INFINITY;
            vx[k] = -INFINITY;
          }
#pragma unroll
          for (int j = 0; j < kSlotsPerLane; ++j) {
            if ((bits >> j) & 1) {
              const size_t s = (size_t)base + j * 32 + lane;
#pragma unroll
              for (int k = 0; k < K; ++k) {
                const float v = p.tup_f[((size_t)e * p.W + p.rows[k]) * p.C + s];
                vs[k] += v;
                vn[k] = min_nan(vn[k], v);
                vx[k] = max_nan(vx[k], v);
              }
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            cnt += __shfl_xor_sync(kFull, cnt, off);
#pragma unroll
            for (int k = 0; k < K; ++k) {
              vs[k] += __shfl_xor_sync(kFull, vs[k], off);
              vn[k] = min_nan(vn[k], __shfl_xor_sync(kFull, vn[k], off));
              vx[k] = max_nan(vx[k], __shfl_xor_sync(kFull, vx[k], off));
            }
          }
          if (lane == 0) {
            sm.acc_cnt[warp][i] += cnt;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              sm.acc[warp][i][0][k] += vs[k];
              sm.acc[warp][i][1][k] = min_nan(sm.acc[warp][i][1][k], vn[k]);
              sm.acc[warp][i][2][k] = max_nan(sm.acc[warp][i][2][k], vx[k]);
            }
          }
        }
      }
      __syncwarp();   // the run table is rewritten by the next tile
    }
    __syncthreads();
    // -- the block's partial: warps in order ------------------------------
    for (int idx = tid; idx < n_sel * (1 + K); idx += kThreads) {
      const int i = idx / (1 + K), col = idx % (1 + K);
      if (col == 0) {
        int c = 0;
        for (int w = 0; w < kWarps; ++w) c += sm.acc_cnt[w][i];
        sm.part_cnt[i] = c;
      } else {
        const int k = col - 1;
        float vs = 0.0f, vn = INFINITY, vx = -INFINITY;
        for (int w = 0; w < kWarps; ++w) {
          vs += sm.acc[w][i][0][k];
          vn = min_nan(vn, sm.acc[w][i][1][k]);
          vx = max_nan(vx, sm.acc[w][i][2][k]);
        }
        sm.part[i][0][k] = vs;
        sm.part[i][1][k] = vn;
        sm.part[i][2][k] = vx;
      }
    }
    cluster.sync();
    // -- the cluster's merge: ranks in order, through distributed smem ----
    for (int idx = rank * kThreads + tid; idx < n_sel * (1 + K);
         idx += S * kThreads) {
      const int i = idx / (1 + K), col = idx % (1 + K);
      const int q = sm.q[i];
      if (col == 0) {
        int c = 0;
        for (int r = 0; r < S; ++r) c += cluster.map_shared_rank(&sm, r)->part_cnt[i];
        p.out_count[(size_t)q * p.E + e] = c;
      } else {
        const int k = col - 1;
        float vs = 0.0f, vn = INFINITY, vx = -INFINITY;
        for (int r = 0; r < S; ++r) {
          const Smem<K>* peer = cluster.map_shared_rank(&sm, r);
          vs += peer->part[i][0][k];
          vn = min_nan(vn, peer->part[i][1][k]);
          vx = max_nan(vx, peer->part[i][2][k]);
        }
        const size_t o = ((size_t)q * p.k_total + p.k_off + k) * p.E + e;
        p.out_sum[o] = vs;
        p.out_min[o] = vn;
        p.out_max[o] = vx;
      }
    }
    cluster.sync();   // no block reuses or leaves its partial while peers read it
  }
}

template <int K>
int launch(const Params& p, int S, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, p.E, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, st_scan_kernel<K>, p);
  if (err != cudaSuccess) return (int)err;
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
                              int k_off, int n_split, void* stream) {
  Params p;
  p.tup_f = static_cast<const float*>(tup_f);
  p.tup_sid = static_cast<const int32_t*>(tup_sid);
  p.tup_count = static_cast<const int32_t*>(tup_count);
  p.pred_f = static_cast<const float*>(pred_f);
  p.pred_i = static_cast<const int32_t*>(pred_i);
  p.sublists = static_cast<const int32_t*>(sublists);
  p.sublist_len = static_cast<const int32_t*>(sublist_len);
  p.E = E;
  p.W = W;
  p.C = C;
  p.Q = Q;
  p.L = L;
  p.valid_c = valid_c;
  p.k_total = k_total;
  p.k_off = k_off;
  p.rows[0] = r0;
  p.rows[1] = r1;
  p.rows[2] = r2;
  p.rows[3] = r3;
  p.out_count = static_cast<int32_t*>(out_count);
  p.out_sum = static_cast<float*>(out_sum);
  p.out_min = static_cast<float*>(out_min);
  p.out_max = static_cast<float*>(out_max);
  for (int k = 0; k < K; ++k)
    if (p.rows[k] < 3 || p.rows[k] >= W) return (int)cudaErrorInvalidValue;
  if (E < 1 || E > 65535 || Q < 0 || L < 0 || C < 0 || valid_c < 0 ||
      valid_c > C || n_split < 1 || n_split > kMaxSplits ||
      k_off < 0 || k_off + K > k_total)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch<1>(p, n_split, s);
    case 2: return launch<2>(p, n_split, s);
    case 3: return launch<3>(p, n_split, s);
    case 4: return launch<4>(p, n_split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
