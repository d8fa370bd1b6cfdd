// Native-resolution pyramid lookup for training: gather and scatter-add.
//
// Replaces the TPU kernels pixelnerf_tpu/ops/pyramid_pallas.py:
// pyramid_gather (`_gather_kernel`) and pyramid_scatter_add
// (`_scatter_kernel`, with `dual`).
//
// What they compute, per map b and point n, for each native level l of
// (H_l, W_l, C_l) with the finest level (hf, wf) as the sampling grid:
//   x, y  = fine pixel coordinates of the normalized uv, clipped
//   w     = wy (x) wx, the composed <=3x3 taps of upsample-then-bilinear
//           (axis_taps; coincident taps add), each axis weight and their
//           product rounded to bf16 as the TPU kernel's bf16 one-hots
//   gather: out[b, n, c0_l + c] = bf16(sum_taps w * feat_l[b, iy, ix, c])
//   scatter: grad_l[b, iy, ix, c] += w * g[b, n, c0_l + c]   (f32)
//            with g = bf16(dz + dz2) when dual, else dz
// Products of two bf16 values are exact in f32; sums are f32.
//
// Bound on the H100: bytes. The gather writes, and the scatter reads, the
// (N, sum C) bf16 latent (1 KB a point at sum C = 512) for ~9 * 2 flops a
// channel: far below the ~295 flop/byte ridge. The levels themselves are
// small (9 MB for 8 views at the flagship) and stay in L2.
//
// The gather runs gather_tile.cuh: only the nonzero taps, 16-byte lane
// loads, two points a warp walking streams of consecutive points with the
// fine level's tap rows kept in registers while the tap base holds, and the
// levels whose bf16 block fits shared memory (16x16x128 and 8x8x256 at the
// flagship) staged there once a unit; the TPU kernels' one-hot matrices on
// the MXU are gone.
//
// The scatter is held back not by bytes but by its reductions into device
// memory: one f32 atomic a channel and tap is ~1.5 G atomics a train step
// at the flagship, and the two small levels' 16x16 and 8x8 pixels receive
// thousands each. So it runs the units of scatter_accum.cuh, one launch a
// call: a level whose f32 (H, W, slice) block fits a unit's shared memory
// (16x16x128 and 8x8x256 at the flagship) is accumulated there and flushed
// once a unit; the fine level (64x64x128, 2 MB a map) takes vector
// reductions of 4 floats, one a lane and tap for each run of consecutive
// points whose tap base does not change.

#include "gather_tile.cuh"
#include "scatter_accum.cuh"

#define PYR_LANES 16  // lanes a point: two points a warp
#define PYR_ROWS 1    // the fine level's channel groups a lane caches: C_0 <= 128 at V = 8

template <int NLEV, int V>
__global__ void __launch_bounds__(THREADS, GT_MIN_BLOCKS) pyramid_gather_kernel(GatherParams p) {
  const int hf = p.hf, wf = p.wf;
  gather_block<NLEV, V, PYR_LANES, PYR_ROWS>(
      p, [hf, wf](const GatherMap& m, float u, float v, int* bx, int* by, float w[3][3]) {
        float fx, fy;
        fine_coords(u, v, hf, wf, &fx, &fy);
        level_taps(fx, fy, m.h, m.w, hf, wf, bx, by, w);
      });
}

__global__ void __launch_bounds__(THREADS, SC_MIN_BLOCKS) pyramid_scatter_kernel(ScatterPlan p) {
  const int hf = p.hf, wf = p.wf;
  scatter_block<3>(p, [hf, wf](const ScatterSeg& s, float u, float v, int* bx, int* by,
                               float w[3][3]) {
    float fx, fy;
    fine_coords(u, v, hf, wf, &fx, &fy);
    level_taps(fx, fy, s.h, s.w, hf, wf, bx, by, w);
  });
}

template <int V>
static int pyramid_gather_launch(const GatherParams& p, int nlev, int units, int smem,
                                 cudaStream_t stream) {
  switch (nlev) {
    case 1: return gather_launch(pyramid_gather_kernel<1, V>, p, units, smem, stream);
    case 2: return gather_launch(pyramid_gather_kernel<2, V>, p, units, smem, stream);
    case 3: return gather_launch(pyramid_gather_kernel<3, V>, p, units, smem, stream);
    default: return gather_launch(pyramid_gather_kernel<4, V>, p, units, smem, stream);
  }
}

extern "C" {

// Launch on `stream`; each returns cudaGetLastError() (or a refusal).
// `plan`: ops/gather_plan.py's GatherPlan.as_ints for these levels, b
// maps and n points.
int pnt_pyramid_gather(const void* const* feats, const int* dims, int nlev, const int* plan,
                       const void* uv, void* out, int b, int n, void* stream) {
  GatherParams p = {};
  int units = 0, smem = 0, vec = 0;
  int rc = gather_plan(&p, plan, feats, dims, nlev, b, n, PYR_LANES, PYR_ROWS, &units, &smem, &vec);
  if (rc) return rc;
  p.hf = dims[0];
  p.wf = dims[1];
  p.uv = static_cast<const float*>(uv);
  p.out = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec == 8 ? pyramid_gather_launch<8>(p, nlev, units, smem, s)
                  : pyramid_gather_launch<2>(p, nlev, units, smem, s);
}

// `plan`: ops/scatter_plan.py's ScatterPlan.as_ints for these levels, b
// maps and n points; dz2 null unless dual.
int pnt_pyramid_scatter(void* const* grads, const int* dims, int nlev, const int* plan,
                        const void* uv, const void* dz, const void* dz2, int b, int n,
                        int csum, void* stream) {
  if (nlev < 1 || nlev > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  int c0[MAX_LEVELS], sum = 0;
  for (int l = 0; l < nlev; l++) {
    c0[l] = sum;
    sum += dims[3 * l + 2];
  }
  if (sum != csum) return (int)cudaErrorInvalidValue;
  ScatterPlan p = {};
  int units = 0, smem = 0;
  int rc = scatter_plan(&p, plan, reinterpret_cast<float* const*>(grads), dims, c0, nlev, b, n,
                        3, &units, &smem);
  if (rc) return rc;
  p.n = n;
  p.csum = csum;
  p.hf = dims[0];
  p.wf = dims[1];
  p.uv = static_cast<const float*>(uv);
  p.dz = static_cast<const bf16*>(dz);
  p.dz2 = static_cast<const bf16*>(dz2);
  return scatter_launch(pyramid_scatter_kernel, p, units, smem, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
