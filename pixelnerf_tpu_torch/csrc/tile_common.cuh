// Device code shared by the package's CUDA sources: the composed
// native-pyramid taps (pyramid_pallas.py:_axis_pairs), rounded as the TPU
// kernels round them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define MAX_LEVELS 4
#define WARPS 8
#define THREADS (WARPS * 32)

// Composed taps on one native axis of size wn for a fine coordinate cf in
// [0, wf-1]: weights of native indices base, base+1, base+2. Coincident
// taps add (pyramid_pallas.py:_axis_pairs). Every operation rounds on its
// own (the _rn intrinsics are never fused into an FMA), as the plain
// versions' elementwise ops do: the pyramid kernels round these weights to
// bf16, and an FMA's one-ulp difference would move a weight across a bf16
// rounding boundary.
__device__ __forceinline__ void axis_taps(float cf, int wn, int wf, int* base,
                                          float w[3]) {
  w[0] = w[1] = w[2] = 0.f;
  if (wn == wf) {
    float j = floorf(cf);
    float t = __fsub_rn(cf, j);
    *base = (int)j;
    w[0] = __fsub_rn(1.f, t);
    w[1] = t;
    return;
  }
  float r = (wn - 1.0f) / (wf - 1.0f);
  float j = fminf(floorf(cf), wf - 2.0f);
  float t = __fsub_rn(cf, j);
  float xl = __fmul_rn(j, r);
  float xr = __fmul_rn(__fadd_rn(j, 1.0f), r);
  float ilf = floorf(xl);
  float irf = fminf(floorf(xr), wn - 1.0f);
  float fl = __fsub_rn(xl, ilf);
  float fr = __fsub_rn(xr, irf);
  const float u = __fsub_rn(1.f, t);
  *base = (int)ilf;
  w[0] = __fmul_rn(u, __fsub_rn(1.f, fl));
  w[1] = __fmul_rn(u, fl);
  // the right pair lands on taps d, d + 1 with d = irf - ilf, 0 or 1 (r <= 1);
  // chosen by a branch, not a runtime index, which would put w in local memory
  const float a = __fmul_rn(t, __fsub_rn(1.f, fr)), c = __fmul_rn(t, fr);
  if (irf == ilf) {
    w[0] = __fadd_rn(w[0], a);
    w[1] = __fadd_rn(w[1], c);
  } else {
    w[1] = __fadd_rn(w[1], a);
    w[2] = __fadd_rn(w[2], c);  // 0 + c: c
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Clipped fine pixel coordinates of a normalized [-1, 1] point on an
// (hf, wf) grid (align_corners, border padding).
__device__ __forceinline__ void fine_coords(float u, float v, int hf, int wf, float* fx,
                                            float* fy) {
  *fx = fminf(fmaxf((u + 1.f) * 0.5f * (float)(wf - 1), 0.f), (float)(wf - 1));
  *fy = fminf(fmaxf((v + 1.f) * 0.5f * (float)(hf - 1), 0.f), (float)(hf - 1));
}

__device__ __forceinline__ void fine_coords(const float* g, int hf, int wf, float* fx,
                                            float* fy) {
  fine_coords(g[0], g[1], hf, wf, fx, fy);
}

// The <=3x3 composed taps of one native (hn, wn) level under the (hf, wf)
// fine grid: base indices and weights, each axis weight and their product
// rounded to bf16 as the TPU kernels' bf16 one-hot matrices
// (pyramid_pallas.py:_level_onehot), zero past the map's edge.
__device__ __forceinline__ void level_taps(float fx, float fy, int hn, int wn, int hf, int wf,
                                           int* bx, int* by, float w[3][3]) {
  float wx[3], wy[3];
  axis_taps(fx, wn, wf, bx, wx);
  axis_taps(fy, hn, hf, by, wy);
#pragma unroll
  for (int ty = 0; ty < 3; ty++)
#pragma unroll
    for (int tx = 0; tx < 3; tx++)
      w[ty][tx] = (*by + ty < hn && *bx + tx < wn)
                      ? round_bf16(round_bf16(wy[ty]) * round_bf16(wx[tx]))
                      : 0.f;
}

extern "C" const char* pnt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
