// Fused pixel-aligned field forward: native-pyramid gather -> ResnetFC,
// with an optional bf16 stash for the backward.
//
// Replaces the TPU kernel pixelnerf_tpu/ops/field_pallas.py:
// pyramid_field_fused (`_field_fwd_kernel`: the primal with stash=False,
// the VJP forward `_field_vjp_fwd` with stash=True), whose gather math is
// pyramid_pallas.py `_fine_coords` / `_level_onehot` and whose MLP is
// resnetfc_pallas.py `_forward_body`.
//
// What it computes, per scene s and point p, for NS source views:
//   z_v   = sum over the composed <=3x3 taps of each native level of
//           w * feat_l[view v]   (upsample-then-bilinear, border padding,
//           align_corners), concatenated over levels, cast to bf16; each
//           tap weight rounded as the TPU kernel's bf16 one-hots
//           (tile_common.cuh:level_taps), so z is exactly pyramid.cu's
//           gather
//   then the ResnetFC chain of fwd_chain.cuh on (z, xin).
// With the stash pointers given it also writes the z tile to the z-stash
// (SB, NS, B, DL) and the relu'd activations to the stash (fwd_chain.cuh).
//
// Bound on the H100: operations. A point at NS=2 costs ~11.6 MFLOP of
// bf16 products (512-wide, 5 blocks, 3 injections) against ~100 bytes of
// input, far above the ~295 FLOP/byte ridge, so the least time is
// FLOP / 989 TFLOP/s.
//
// Design, simple first: one CTA of 8 warps per (scene, tile of TB points
// x NS views), TB = max(1, 32 / NS), so a tile holds NS * TB <= 32 rows
// for NS <= 32 (more rows, one point, beyond). The gathered z tile (bf16),
// the f32 residual stream, and two bf16 operand buffers live in dynamic
// shared memory (~168 KB for 32 rows at the flagship width, which caps NS
// at 32 there); the TPU kernel's one-hot gather matrices are gone: each
// thread loads its channel pair of every tap directly, the loads of a warp
// coalesced over C. Weights (one head ~6.8 MB bf16) are not resident as on
// the TPU: they stream from L2 as wmma B fragments, each warp owning 4 of
// the 32 16-wide output column strips of a product. Injections are
// computed per block rather than packed into one product. A later change
// moves the products to wgmma with TMA-fed rings.

#include "fwd_chain.cuh"

struct FieldParams {
  ChainParams c;
  const bf16* feats[MAX_LEVELS];
  int lh[MAX_LEVELS], lw[MAX_LEVELS], lc[MAX_LEVELS], lc0[MAX_LEVELS];
  int nlev;
  const float* grid;  // (SB, NS, B, 2) normalized fine-grid coords
  bf16* zstash;       // (SB, NS, B, DL) or null
};

__global__ void __launch_bounds__(THREADS, 1) field_fwd_kernel(FieldParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ChainParams& c = p.c;
  const FwdSmem m = fwd_smem(smem, c);
  const int DL = c.d_latent, ns = c.ns, tb = c.tb, B = c.b;
  const int s = blockIdx.y, p0 = blockIdx.x * tb;
  const int rows = ns * tb;
  const int hf = p.lh[0], wf = p.lw[0];

  // 1. gather the latent tile, rows view-major (row = v * tb + point);
  // rows past the last point or past ns * tb are zero
  for (int r = 0; r < c.rows_pad; r++) {
    const int v = r / tb, pt = p0 + r % tb;
    if (r >= rows || pt >= B) {
      for (int ch = threadIdx.x; ch < DL; ch += THREADS) m.Z[r * DL + ch] = __float2bfloat16(0.f);
      continue;
    }
    float fx, fy;
    fine_coords(p.grid + (((size_t)s * ns + v) * B + pt) * 2, hf, wf, &fx, &fy);
    for (int ch = 2 * threadIdx.x; ch < DL; ch += 2 * THREADS) {
      int l = 0;
      while (l + 1 < p.nlev && ch >= p.lc0[l + 1]) l++;
      const int hn = p.lh[l], wn = p.lw[l], C = p.lc[l];
      int bx, by;
      float w[3][3];
      level_taps(fx, fy, hn, wn, hf, wf, &bx, &by, w);
      const bf16* f = p.feats[l] + ((size_t)(s * ns + v) * hn * wn) * C + (ch - p.lc0[l]);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int ty = 0; ty < 3; ty++) {
        const int iy = by + ty;
        if (iy >= hn) continue;
#pragma unroll
        for (int tx = 0; tx < 3; tx++) {
          const int ix = bx + tx;
          if (ix >= wn) continue;
          const float2 vf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(f + ((size_t)iy * wn + ix) * C));
          a0 += w[ty][tx] * vf.x;
          a1 += w[ty][tx] * vf.y;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(m.Z + r * DL + ch) = __floats2bfloat162_rn(a0, a1);
    }
  }
  load_xin(c, m, s, p0);
  __syncthreads();
  if (p.zstash != nullptr) write_rows(c, m.Z, DL, DL, true, p.zstash, s, p0);

  // 2. the block chain
  forward_chain(c, m, s, p0);
}

extern "C" {

size_t pnt_field_fwd_smem_bytes(int hidden, int d_latent, int d_in_pad, int ns) {
  return fwd_smem_bytes(hidden, d_latent, d_in_pad, ns);
}

// Launches the kernel on `stream`; the stash (zstash, spre, spost) is
// written when spost is not null. Returns cudaGetLastError().
int pnt_field_fwd(const void* const* feats, const int* dims, int nlev,
                  const void* grid, const void* xin, const void* w_in,
                  const void* b_in, const void* wz, const void* bz,
                  const void* w0, const void* b0, const void* w1,
                  const void* b1, const void* w_out, const void* b_out,
                  void* out, void* zstash, void* spre, void* spost, int sb, int ns,
                  int b, int d_in, int d_in_pad, int hidden, int d_out, int n_blocks,
                  int combine_layer, void* stream) {
  FieldParams p;
  int c0 = 0;
  for (int l = 0; l < MAX_LEVELS; l++) {
    const bool on = l < nlev;
    p.feats[l] = on ? static_cast<const bf16*>(feats[l]) : nullptr;
    p.lh[l] = on ? dims[3 * l] : 0;
    p.lw[l] = on ? dims[3 * l + 1] : 0;
    p.lc[l] = on ? dims[3 * l + 2] : 0;
    p.lc0[l] = c0;
    c0 += p.lc[l];
  }
  p.nlev = nlev;
  p.grid = static_cast<const float*>(grid);
  p.zstash = spost != nullptr ? static_cast<bf16*>(zstash) : nullptr;
  p.c = chain_params(xin, w_in, b_in, wz, bz, w0, b0, w1, b1, w_out, b_out, out, spre, spost,
                     sb, ns, b, c0, d_in, d_in_pad, hidden, d_out, n_blocks, combine_layer);

  const size_t smem = fwd_smem_bytes(hidden, c0, d_in_pad, ns);
  cudaError_t err = cudaFuncSetAttribute(
      field_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_dim((b + p.c.tb - 1) / p.c.tb, sb);
  field_fwd_kernel<<<grid_dim, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
