// Voronoi point location H_s (paper §3.4.1): nearest edge site per point.
//
// Replaces the Pallas TPU kernel `voronoi_assign`
// (src/repro/kernels/voronoi_assign/voronoi_assign.py, body `_kernel`,
// wrapper `ops.py::hash_spatial_kernel`). The TPU version forms a
// (block, E) distance tile with one matrix-unit contraction over the 2
// coordinates and takes a lane-wise argmin. A contraction of depth 2 gives a
// tensor core nothing to do, and TF32 or bf16 would break the bitwise
// agreement below, so here the distances are scalar float32 work.
//
// What bounds it. Visiting all 80 sites for each of the main path's
// 102,400 slice-grid cell centres is 8.2M (point, site) pairs of 5 float
// operations and a compare with two selects each: some 3 µs of instruction
// throughput on 132 SMs, while a point moves only 12 bytes (two coordinates
// in, one index out). Most of those pairs cannot win, so the design visits
// only the sites that can; what is left is latency: the chain of dependent
// memory reads a point waits on (its coordinates, its cell, its sites).
//
// Design. Once per site set the wrapper (`ops.packed_sites`) lays a grid of
// cells over the sites' box, widened by its own extent on each side, and
// lists for each cell the sites that may be nearest to some point of the
// cell (below). A thread takes one point, finds its cell with two products,
// and visits that cell's sites: 1.7 a point on the D400 slice grid, against
// 80. The lists hold the sites themselves (a float4 {sx, sy, snorm, index};
// some 150 KB for 80 sites), and a cell's first kAhead sites are loaded
// together, so a point waits on three reads in a row. A point outside the
// grid, or with a NaN or huge coordinate, visits every site. There is no
// shared-memory staging and no block barrier; the grid of blocks is at most
// one wave, walked point by point.
//
// Exactness: a visited pair evaluates `snorm - 2 * (px*sx + py*sy)` with
// round-to-nearest intrinsics and no fused multiply-add, in the same order
// as the plain PyTorch version (repro_torch/core/voronoi.py), which takes
// the same centred sites (the wrapper packs `centred_sites`' own tensors).
// The argmin keeps the first minimum (strict <); ties go to the lowest edge
// index.
//
// Why a cell's list never misses the argmin (the wrapper builds the lists
// in float64, `ops._cell_lists`). Write u = 2^-24 and, for a
// point p and site e, d*(p, e) = sn_e - 2 (px sx_e + py sy_e): the exact
// value of the pair's expression on the same float inputs. The float
// evaluation d_f is within 4u mag_e(p) + 2^-146 of d*, where mag_e(p) =
// sn_e + 2 (|px||sx_e| + |py||sy_e|) (four roundings, none fused; the
// absolute term covers underflow). For a witness site w (the site nearest
// the cell's centre), d*(p, e) - d*(p, w) = (sn_e - sn_w) - 2 (px a + py b),
// a = sx_e - sx_w, b = sy_e - sy_w, is linear in p, so on a box [x0, x1] x
// [y0, y1] it is never below
//   G = (sn_e - sn_w) - 2 (max(x0 a, x1 a) + max(y0 b, y1 b)).
// A site is left out of the cell's list only when G > M_e + M_w, with
// M = 2^-12 (sn + 2 (mx |sx| + my |sy|)) + 2^-100 and mx, my the box's
// largest |px|, |py|: 2^-12 is 1024 times the 4u the evaluation needs, and
// float64 rounds G far below that. Then d_f(p, e) > d_f(p, w) at every
// point of the box: a site that attains the minimum, the first among them
// included, is on the list, the list is in ascending index order, and the
// first minimum among the listed sites is the plain version's argmin. The
// box is the cell widened by a thousandth of its width on each side, which
// covers every point that the kernel's rounded cell arithmetic below puts in
// the cell (its relative error is a few u over at most 256 cells).
//
// Non-finite and huge inputs. A NaN or huge coordinate fails the cell's
// bounds test and visits every site with torch.argmin's rule (the first NaN
// wins, else the first minimum), so a NaN point gives index 0. A site set
// with a NaN or a centred coordinate of 2^60 or more has an empty grid.
//
// Packed layout, float4 rows: e sites {sx, sy, snorm, index bits}; then
// {cx, cy, cells across bits, cells down bits}; then {x0, y0, 1 / cell
// width, 1 / cell height} (the grid's corner, in centred coordinates); then
// the cells' lists, back to back. `cells` holds each cell's first row in
// the lists and, last, their end.
//
// C entry: voronoi_assign_launch(lat, lon, packed, cells, out, n, e, stream)
// launches on `stream` and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 4;  // listed sites loaded at once

// One site against a point. NANS: torch.argmin's rule for inputs that may
// give NaN (a NaN distance wins, the first one stays); otherwise the plain
// strict < on finite distances.
template <bool NANS>
__device__ __forceinline__ void visit(const float4 s, const int j,
                                      const float px, const float py,
                                      float& best, int& arg) {
  const float cross = __fadd_rn(__fmul_rn(px, s.x), __fmul_rn(py, s.y));
  const float d = __fsub_rn(s.z, __fmul_rn(2.0f, cross));
  const bool take = NANS ? (!(d >= best) && !isnan(best)) : d < best;
  if (take) {
    best = d;
    arg = j;
  }
}

__global__ void __launch_bounds__(kThreads)
    voronoi_assign_kernel(const float* __restrict__ lat,
                          const float* __restrict__ lon,
                          const float4* __restrict__ packed,
                          const int* __restrict__ cells,
                          int32_t* __restrict__ out, const int n,
                          const int e) {
  const float4 head = __ldg(packed + e);
  const float4 grid = __ldg(packed + e + 1);
  const float4* const list = packed + e + 2;
  const int across = __float_as_int(head.z), down = __float_as_int(head.w);
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += gridDim.x * blockDim.x) {
    const float px = __fsub_rn(__ldg(lat + p), head.x);
    const float py = __fsub_rn(__ldg(lon + p), head.y);
    const float tx = __fmul_rn(__fsub_rn(px, grid.x), grid.z);
    const float ty = __fmul_rn(__fsub_rn(py, grid.y), grid.w);
    float best = __int_as_float(0x7f800000);  // +inf
    int arg = 0;
    if (tx >= 0.0f && tx < (float)across && ty >= 0.0f && ty < (float)down) {
      const int cell = (int)tx * down + (int)ty;
      const int start = __ldg(cells + cell), end = __ldg(cells + cell + 1);
      // The first kAhead listed sites are loaded together, so a point pays
      // one memory latency for them, not one a site.
      float4 ahead[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i)
        if (start + i < end) ahead[i] = __ldg(list + start + i);
#pragma unroll
      for (int i = 0; i < kAhead; ++i)
        if (start + i < end)
          visit<false>(ahead[i], __float_as_int(ahead[i].w), px, py, best, arg);
      for (int k = start + kAhead; k < end; ++k) {
        const float4 s = __ldg(list + k);
        visit<false>(s, __float_as_int(s.w), px, py, best, arg);
      }
    } else {
      for (int j = 0; j < e; ++j)
        visit<true>(__ldg(packed + j), j, px, py, best, arg);
    }
    out[p] = arg;
  }
}

}  // namespace

extern "C" int voronoi_assign_launch(const void* lat, const void* lon,
                                     const void* packed, const void* cells,
                                     void* out, int n, int e, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n + kThreads - 1) / kThreads;
  const int wave = sms * (2048 / kThreads);
  if (blocks > wave) blocks = wave;
  voronoi_assign_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)lat, (const float*)lon, (const float4*)packed,
      (const int*)cells, (int32_t*)out, n, e);
  return (int)cudaGetLastError();
}
