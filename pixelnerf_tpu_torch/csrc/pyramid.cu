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
// Design, simple first: one warp per point, its lanes over channel pairs
// (bf16x2), so a warp's loads of a tap row, of the cotangent row and its
// stores are contiguous. The TPU kernels' one-hot matrices on the MXU are
// gone: each lane reads its <=9 taps directly. The scatter adds into
// channel-contiguous (B, H_l, W_l, C_l) f32 gradients with f32 atomics, so
// a warp's atomics fall on neighbouring addresses; the TPU's (C, P)
// accumulator layout was an artifact of its sequential grid.

#include "tile_common.cuh"

#define PTS_PER_BLOCK WARPS

struct PyrParams {
  const bf16* feats[MAX_LEVELS];
  float* grads[MAX_LEVELS];
  int lh[MAX_LEVELS], lw[MAX_LEVELS], lc[MAX_LEVELS], lc0[MAX_LEVELS];
  int nlev, n, csum;
  const float* uv;  // (B, N, 2)
  bf16* out;        // (B, N, csum)
  const bf16* dz;   // (B, N, csum)
  const bf16* dz2;  // (B, N, csum) or null
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

__global__ void __launch_bounds__(THREADS) pyramid_scatter_kernel(PyrParams p) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int n = blockIdx.x * PTS_PER_BLOCK + threadIdx.x / 32;
  if (n >= p.n) return;
  float fx, fy;
  fine_coords(p.uv + ((size_t)b * p.n + n) * 2, p.lh[0], p.lw[0], &fx, &fy);
  const size_t row = ((size_t)b * p.n + n) * p.csum;
  for (int l = 0; l < p.nlev; l++) {
    const int hn = p.lh[l], wn = p.lw[l], C = p.lc[l];
    int bx, by;
    float w[3][3];
    level_taps(fx, fy, hn, wn, p.lh[0], p.lw[0], &bx, &by, w);
    float* grad = p.grads[l] + (size_t)b * hn * wn * C;
    for (int c = 2 * lane; c < C; c += 64) {
      float2 g = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.dz + row + p.lc0[l] + c));
      if (p.dz2 != nullptr) {
        // the two cotangents summed in registers, rounded to bf16 as the
        // TPU kernel's bf16 add
        const float2 g2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.dz2 + row + p.lc0[l] + c));
        g.x = round_bf16(g.x + g2.x);
        g.y = round_bf16(g.y + g2.y);
      }
#pragma unroll
      for (int ty = 0; ty < 3; ty++) {
        if (by + ty >= hn) continue;
#pragma unroll
        for (int tx = 0; tx < 3; tx++) {
          if (bx + tx >= wn || w[ty][tx] == 0.f) continue;
          float* dst = grad + ((size_t)(by + ty) * wn + bx + tx) * C + c;
          atomicAdd(dst, w[ty][tx] * g.x);
          atomicAdd(dst + 1, w[ty][tx] * g.y);
        }
      }
    }
  }
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

// Launch on `stream`; each returns cudaGetLastError().
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

int pnt_pyramid_scatter(void* const* grads, const int* dims, int nlev,
                        const void* uv, const void* dz, const void* dz2, int b,
                        int n, int csum, int dual, void* stream) {
  PyrParams p = level_params(dims, nlev, n);
  if (p.csum != csum) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < nlev; l++) p.grads[l] = static_cast<float*>(grads[l]);
  p.uv = static_cast<const float*>(uv);
  p.dz = static_cast<const bf16*>(dz);
  p.dz2 = dual ? static_cast<const bf16*>(dz2) : nullptr;
  dim3 grid((n + PTS_PER_BLOCK - 1) / PTS_PER_BLOCK, b);
  pyramid_scatter_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
