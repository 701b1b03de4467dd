// Voronoi point location H_s (paper §3.4.1): nearest edge site per point.
//
// Replaces the Pallas TPU kernel `voronoi_assign`
// (src/repro/kernels/voronoi_assign/voronoi_assign.py, body `_kernel`,
// wrapper `ops.py::hash_spatial_kernel`). The TPU version forms a
// (block, E) distance tile with one matrix-unit contraction over the 2
// coordinates and takes a lane-wise argmin. A contraction of depth 2 gives a
// tensor core nothing to do, so here each thread owns one point and walks
// the sites in ascending order.
//
// Bound: operations for the edge counts the store runs (E = 80: ~6 float
// operations per site, ~480 per point, against 12 bytes of traffic per
// point: two float coordinates in, one int32 edge id out). The centred sites
// and their squared norms (3 floats a site) sit in shared memory, loaded once
// per block, so the inner loop reads shared memory broadcast to the warp and
// never touches device memory.
//
// Exactness: the distance `snorm[e] - 2 * (px*sx + py*sy)` is evaluated with
// round-to-nearest intrinsics and no fused multiply-add, in the same order as
// the plain PyTorch version (repro_torch/core/voronoi.py), and the argmin
// keeps the first minimum (strict <), so kernel and plain version agree bit
// for bit; ties go to the lowest edge index.
//
// C entry: voronoi_assign_launch(lat, lon, centroid, sites, snorm, out, n, e,
// stream) launches on `stream` and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void voronoi_assign_kernel(const float* __restrict__ lat,
                                      const float* __restrict__ lon,
                                      const float* __restrict__ centroid,
                                      const float* __restrict__ sites,
                                      const float* __restrict__ snorm,
                                      int32_t* __restrict__ out, int n,
                                      int e) {
  extern __shared__ float smem[];        // sx[e], sy[e], sn[e]
  float* sx = smem;
  float* sy = smem + e;
  float* sn = smem + 2 * e;
  for (int j = threadIdx.x; j < e; j += blockDim.x) {
    sx[j] = sites[2 * j];
    sy[j] = sites[2 * j + 1];
    sn[j] = snorm[j];
  }
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = __fsub_rn(lat[i], centroid[0]);
  const float py = __fsub_rn(lon[i], centroid[1]);
  float best = 0.0f;
  int arg = 0;
  for (int j = 0; j < e; ++j) {
    const float cross = __fadd_rn(__fmul_rn(px, sx[j]), __fmul_rn(py, sy[j]));
    const float d = __fsub_rn(sn[j], __fmul_rn(2.0f, cross));
    if (j == 0 || d < best) {
      best = d;
      arg = j;
    }
  }
  out[i] = arg;
}

}  // namespace

extern "C" int voronoi_assign_launch(const void* lat, const void* lon,
                                     const void* centroid, const void* sites,
                                     const void* snorm, void* out, int n, int e,
                                     void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = 3 * (size_t)e * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        voronoi_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  voronoi_assign_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)lat, (const float*)lon, (const float*)centroid,
      (const float*)sites, (const float*)snorm, (int32_t*)out, n, e);
  return (int)cudaGetLastError();
}
