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
// The gather: one warp per point, its lanes over channel pairs (bf16x2),
// so a warp's loads of a tap row and its stores are contiguous; the TPU
// kernels' one-hot matrices on the MXU are gone: each lane reads its <=9
// taps directly.
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

#include "scatter_accum.cuh"

#define PTS_PER_BLOCK WARPS

// The gather's parameter block. The two `unused` fields keep its size and
// layout: without them ptxas copies the level arrays, which the gather
// indexes by a runtime level, to local memory (a 152-byte stack frame in
// place of 24) and the gather runs slower.
struct PyrParams {
  const bf16* feats[MAX_LEVELS];
  const void* unused_mid[MAX_LEVELS];
  int lh[MAX_LEVELS], lw[MAX_LEVELS], lc[MAX_LEVELS], lc0[MAX_LEVELS];
  int nlev, n, csum;
  const float* uv;  // (B, N, 2)
  bf16* out;        // (B, N, csum)
  const void* unused_tail[2];
};

__global__ void __launch_bounds__(THREADS) pyramid_gather_kernel(PyrParams p) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int n = blockIdx.x * PTS_PER_BLOCK + threadIdx.x / 32;
  if (n >= p.n) return;
  float fx, fy;
  fine_coords(p.uv + ((size_t)b * p.n + n) * 2, p.lh[0], p.lw[0], &fx, &fy);
  bf16* out = p.out + ((size_t)b * p.n + n) * p.csum;
  for (int l = 0; l < p.nlev; l++) {
    const int hn = p.lh[l], wn = p.lw[l], C = p.lc[l];
    int bx, by;
    float w[3][3];
    level_taps(fx, fy, hn, wn, p.lh[0], p.lw[0], &bx, &by, w);
    const bf16* f = p.feats[l] + (size_t)b * hn * wn * C;
    for (int c = 2 * lane; c < C; c += 64) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int ty = 0; ty < 3; ty++) {
        if (by + ty >= hn) continue;
#pragma unroll
        for (int tx = 0; tx < 3; tx++) {
          if (bx + tx >= wn) continue;
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              f + ((size_t)(by + ty) * wn + bx + tx) * C + c));
          a0 += w[ty][tx] * v.x;
          a1 += w[ty][tx] * v.y;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(out + p.lc0[l] + c) = __floats2bfloat162_rn(a0, a1);
    }
  }
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

static PyrParams level_params(const int* dims, int nlev, int n) {
  PyrParams p = {};
  int c0 = 0;
  for (int l = 0; l < MAX_LEVELS; l++) {
    const bool on = l < nlev;
    p.lh[l] = on ? dims[3 * l] : 0;
    p.lw[l] = on ? dims[3 * l + 1] : 0;
    p.lc[l] = on ? dims[3 * l + 2] : 0;
    p.lc0[l] = c0;
    c0 += p.lc[l];
  }
  p.nlev = nlev;
  p.n = n;
  p.csum = c0;
  return p;
}

extern "C" {

// Launch on `stream`; each returns cudaGetLastError() (or a refusal).
int pnt_pyramid_gather(const void* const* feats, const int* dims, int nlev,
                       const void* uv, void* out, int b, int n, void* stream) {
  PyrParams p = level_params(dims, nlev, n);
  for (int l = 0; l < nlev; l++) p.feats[l] = static_cast<const bf16*>(feats[l]);
  p.uv = static_cast<const float*>(uv);
  p.out = static_cast<bf16*>(out);
  dim3 grid((n + PTS_PER_BLOCK - 1) / PTS_PER_BLOCK, b);
  pyramid_gather_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
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
