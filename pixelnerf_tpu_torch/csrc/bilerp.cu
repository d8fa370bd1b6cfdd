// Single-map bilinear lookup for training: gather and scatter-add.
//
// Replaces the TPU kernels pixelnerf_tpu/ops/scatter_pallas.py:
// bilerp_gather (`_gather_kernel`) and bilerp_scatter_add
// (`_scatter_kernel`), the forward and backward of
// grid_sample_border_train.
//
// What they compute, per map b and point n of a (B, hl, wl, C) map:
//   x, y  = clip((u + 1) / 2 * (wl - 1), 0, wl - 1), the same for v
//   axis weights 1 - fx, fx (fx = x - floor x) and 1 - fy, fy, in float32
//   w     = wy * wx, the float32 product; on a map of at most 8,192 pixels
//           (`_onehot_w`, scatter_pallas.py:55-96) rounded to bf16 once
//           (not pyramid.cu's rounding, which rounds each axis weight
//           first); on a larger map (`WIDE`, which the JAX package samples
//           with grid_sample_2d) left as grid_sample's float32 product
//   a tap at x0 + 1 == wl (or y0 + 1 == hl) is dropped
//   gather:  out[b, n, c] = bf16(sum_taps w * feat[b, iy, ix, c])   (f32 sum)
//   scatter: grad[b, iy, ix, c] += w * bf16(dz[b, n, c])            (f32)
// The wrappers (ops/scatter.py) set WIDE from the map's size. Products of
// two bf16 values are exact in f32; a WIDE product rounds once, in the FMA
// that adds it.
//
// Bound on the H100: bytes. The gather writes, and the scatter reads, the
// (N, C) bf16 latent (1 KB a point at C = 512) for 4 * 2 flops a channel:
// far below the ~295 flop/byte ridge. The nearest path's map (4 MB for 8
// views of 64x64x512 bf16) stays in L2. dtu's composed 150x200x512 map
// (30,000 pixels, WIDE) is 30.7 MB a source, 92 MB for a view's 3 sources:
// more than L2's 50 MB, so the gather's tap rows come partly from HBM. A
// dtu view writes 62.9M rows (8 chunks x 16,384 rays x (64 + 96) samples x
// 3 sources): 19.2 ms at 3.35 TB/s; a dtu training step (12 maps, 65,536 +
// 32,768 points a map) 1.2 GB, 0.36 ms.
//
// The gather runs gather_tile.cuh (pyramid.cu's design): only the nonzero
// taps, 16-byte lane loads, one point a warp walking a stream of
// consecutive points with the map's tap rows kept in registers while the
// tap corner holds; a map whose bf16 block fits shared memory is staged
// there once a unit. The TPU kernels' (TN, P) one-hot matrices on the MXU
// are gone. A WIDE point's record carries its four float32 weights (five
// words, not three); the FMA chain over the taps in grid_sample's order
// gives grid_sample_2d's float32 sums, so the WIDE gather equals it bit
// for bit on the H100. At dtu's map the register cache still holds: a
// view's fine call reads 11-12 GB of nonzero tap rows and 7-8 GB after the
// cache, mostly from L2, and runs at about half its bytes bound (2.4 ms
// against 1.48 on an H100 at 700 W). Chunks that give each map a wave of
// its own (one source's map hot in L2) measured 13-18% faster, about 5 ms
// of a 1.23 s view: not taken.
//
// The scatter is held back not by bytes but by its reductions into device
// memory: one f32 atomic a channel and tap is ~1.5 G atomics a nearest
// train step. It runs the units of scatter_accum.cuh, one launch a call:
// the flagship's 64x64x512 map (8 MB a map in f32) and dtu's (61 MB a map,
// 737 MB for a step's 12) take vector reductions of 4 floats, one a lane
// and tap for each run of consecutive points whose tap corner does not
// change; a map whose f32 (hl, wl, slice) block fits a unit's shared
// memory is accumulated there and flushed once a unit.

#include "gather_tile.cuh"
#include "scatter_accum.cuh"

#define BIL_LANES 32  // lanes a point: one point a warp
#define BIL_ROWS 2    // channel groups a lane caches: C <= 512 at V = 8

// the 2x2 taps of a point at normalized (u, v): corner (x0, y0) and
// weights, zero for a tap past the map's edge; rounded to bf16 unless WIDE
template <bool WIDE>
__device__ __forceinline__ void bilerp_taps(float u, float v, int hl, int wl, int* x0, int* y0,
                                            float w[2][2]) {
  float x, y;
  fine_coords(u, v, hl, wl, &x, &y);
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = __fsub_rn(x, x0f), fy = __fsub_rn(y, y0f);
  const float ax[2] = {__fsub_rn(1.f, fx), fx}, ay[2] = {__fsub_rn(1.f, fy), fy};
  *x0 = (int)x0f;
  *y0 = (int)y0f;
#pragma unroll
  for (int ty = 0; ty < 2; ty++)
#pragma unroll
    for (int tx = 0; tx < 2; tx++)
      if (*y0 + ty < hl && *x0 + tx < wl) {
        const float p = __fmul_rn(ay[ty], ax[tx]);
        w[ty][tx] = WIDE ? p : round_bf16(p);
      } else {
        w[ty][tx] = 0.f;
      }
}

template <int V, bool WIDE>
__global__ void __launch_bounds__(THREADS, GT_MIN_BLOCKS) bilerp_gather_kernel(GatherParams p) {
  gather_block<1, V, BIL_LANES, BIL_ROWS, WIDE>(
      p, [](const GatherMap& m, float u, float v, int* x0, int* y0, float w[3][3]) {
        float w2[2][2];
        bilerp_taps<WIDE>(u, v, m.h, m.w, x0, y0, w2);
#pragma unroll
        for (int i = 0; i < 4; i++) w[i / 2][i % 2] = w2[i / 2][i % 2];
      });
}

template <bool WIDE>
__global__ void __launch_bounds__(THREADS, SC_MIN_BLOCKS) bilerp_scatter_kernel(ScatterPlan p) {
  scatter_block<2>(p, [](const ScatterSeg& s, float u, float v, int* x0, int* y0, float w[2][2]) {
    bilerp_taps<WIDE>(u, v, s.h, s.w, x0, y0, w);
  });
}

extern "C" {

// Launch on `stream`; each returns cudaGetLastError() (or a refusal).
// `plan`: ops/gather_plan.py's GatherPlan.as_ints for one (hl, wl, c) map,
// b maps and n points. `wide`: 1 for a map past 8,192 pixels (float32 tap
// weights), which the wrapper sets from the map's size.
int pnt_bilerp_gather(const int* plan, const void* feat, const void* uv, void* out, int b, int n,
                      int hl, int wl, int c, int wide, void* stream) {
  GatherParams p = {};
  const int dims[3] = {hl, wl, c};
  const void* feats[1] = {feat};
  int units = 0, smem = 0, vec = 0;
  int rc = gather_plan(&p, plan, feats, dims, 1, b, n, BIL_LANES, BIL_ROWS, &units, &smem, &vec);
  if (rc) return rc;
  p.hf = hl;
  p.wf = wl;
  p.uv = static_cast<const float*>(uv);
  p.out = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    return vec == 8 ? gather_launch(bilerp_gather_kernel<8, true>, p, units, smem, s)
                    : gather_launch(bilerp_gather_kernel<2, true>, p, units, smem, s);
  return vec == 8 ? gather_launch(bilerp_gather_kernel<8, false>, p, units, smem, s)
                  : gather_launch(bilerp_gather_kernel<2, false>, p, units, smem, s);
}

// `plan`: ops/scatter_plan.py's ScatterPlan.as_ints for one (hl, wl, c)
// map, b maps and n points; `wide` as for the gather.
int pnt_bilerp_scatter(const int* plan, const void* uv, const void* dz, void* grad, int b, int n,
                       int hl, int wl, int c, int wide, void* stream) {
  ScatterPlan p = {};
  const int dims[3] = {hl, wl, c}, c0 = 0;
  float* grads[1] = {static_cast<float*>(grad)};
  int units = 0, smem = 0;
  int rc = scatter_plan(&p, plan, grads, dims, &c0, 1, b, n, 2, &units, &smem);
  if (rc) return rc;
  p.n = n;
  p.csum = c;
  p.hf = hl;
  p.wf = wl;
  p.uv = static_cast<const float*>(uv);
  p.dz = static_cast<const bf16*>(dz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? scatter_launch(bilerp_scatter_kernel<true>, p, units, smem, s)
              : scatter_launch(bilerp_scatter_kernel<false>, p, units, smem, s);
}

}  // extern "C"
