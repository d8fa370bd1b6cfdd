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
// FLOP / 989 TFLOP/s. What holds the chain back from it is in
// fwd_chain.cuh; the gather below adds ~1/3 to the tile's time and
// overlaps nothing, since one CTA fills an SM.
//
// Design: one CTA of 384 threads per (scene, tile of P = max(1, 64/NS)
// points x NS views). The two consumer warpgroups gather the z tile
// straight into the swizzled K-major bf16 layout that wgmma reads (each
// thread loads its channel pair of every tap, the loads of a warp
// coalesced over C, four rows' loads in flight at once; the TPU kernel's
// one-hot gather matrices are gone)
// while the producer thread already streams the first weight tiles by TMA;
// then fwd_chain.cuh's wgmma chain runs on them. Injections are computed
// per block rather than packed into one product.

#include "fwd_chain.cuh"

struct FieldLevels {
  const bf16* feats[MAX_LEVELS];
  int lh[MAX_LEVELS], lw[MAX_LEVELS], lc[MAX_LEVELS], lc0[MAX_LEVELS];
  int nlev;
  const float* grid;  // (SB, NS, B, 2) normalized fine-grid coords
};

// Gather the latent tile's channels [c0, c0 + nc), rows view-major (row =
// v * P + point); rows past the last point or past NS * P are zero. A
// thread owns channel pairs (one at DL = 512) and walks the rows GR at a
// time, all their tap loads issued before any is summed.
template <int GR>
__device__ __forceinline__ void gather_band(const ChainParams& c, const FieldLevels& lv,
                                            unsigned char* Z, int s, int p0, int c0, int nc) {
  const int ns = c.ns, P = c.pts, B = c.b, rows = ns * P;
  const int hf = lv.lh[0], wf = lv.lw[0];
  for (int ch = c0 + 2 * threadIdx.x; ch < c0 + nc; ch += 2 * FWD_CONSUMERS) {
    int l = 0;
    while (l + 1 < lv.nlev && ch >= lv.lc0[l + 1]) l++;
    const int hn = lv.lh[l], wn = lv.lw[l], C = lv.lc[l];
    const bf16* fl = lv.feats[l] + (ch - lv.lc0[l]);
    for (int r0 = 0; r0 < FWD_ROWS; r0 += GR) {
      float2 tap[GR][9];
      float w[GR][3][3];
      int bx[GR], by[GR];
      bool ok[GR];
#pragma unroll
      for (int i = 0; i < GR; i++) {
        const int r = r0 + i, v = r / P, pt = p0 + r % P;
        ok[i] = r < rows && pt < B;
        bx[i] = by[i] = 0;
        if (ok[i]) {
          float fx, fy;
          fine_coords(lv.grid + (((size_t)s * ns + v) * B + pt) * 2, hf, wf, &fx, &fy);
          level_taps(fx, fy, hn, wn, hf, wf, &bx[i], &by[i], w[i]);
        }
        const bf16* f = fl + ((size_t)(s * ns + (ok[i] ? v : 0)) * hn * wn) * C;
#pragma unroll
        for (int t = 0; t < 9; t++) {
          const int iy = by[i] + t / 3, ix = bx[i] + t % 3;
          tap[i][t] = make_float2(0.f, 0.f);
          if (ok[i] && iy < hn && ix < wn)
            tap[i][t] = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(f + ((size_t)iy * wn + ix) * C));
        }
      }
#pragma unroll
      for (int i = 0; i < GR; i++) {
        float a0 = 0.f, a1 = 0.f;
        if (ok[i]) {
#pragma unroll
          for (int ty = 0; ty < 3; ty++) {
            if (by[i] + ty >= hn) continue;
#pragma unroll
            for (int tx = 0; tx < 3; tx++) {
              if (bx[i] + tx >= wn) continue;
              a0 += w[i][ty][tx] * tap[i][ty * 3 + tx].x;
              a1 += w[i][ty][tx] * tap[i][ty * 3 + tx].y;
            }
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(Z + sw128_offset(r0 + i, ch - c0)) =
            __floats2bfloat162_rn(a0, a1);
      }
    }
  }
}

template <int H>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    field_fwd_kernel(const __grid_constant__ ChainParams c,
                     const __grid_constant__ ChainMaps maps,
                     const __grid_constant__ FieldLevels lv) {
  run_chain<H>(c, maps, [&](unsigned char* Z, int s, int p0, int c0, int nc, bool live) {
    // a band reloaded mid-chain (a latent wider than the z tile) gathers a
    // row at a time: the residual stream's registers are live there
    if (live)
      gather_band<1>(c, lv, Z, s, p0, c0, nc);
    else
      gather_band<4>(c, lv, Z, s, p0, c0, nc);
  });
}

template <int H>
static int launch(const ChainParams& c, const ChainMaps& maps, const FieldLevels& lv, size_t smem,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(field_fwd_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_dim((c.b + c.pts - 1) / c.pts, c.sb);
  field_fwd_kernel<H><<<grid_dim, FWD_THREADS, smem, stream>>>(c, maps, lv);
  return (int)cudaGetLastError();
}

extern "C" {

size_t pnt_field_fwd_smem_bytes(int hidden, int d_latent, int d_in_pad, int ns) {
  return fwd_smem_bytes(hidden, d_latent, ns);
}

// Launches the kernel on `stream`; the stash (zstash, spre, spost) is
// written when spost is not null. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a width the chain is not built for.
int pnt_field_fwd(const void* const* feats, const int* dims, int nlev,
                  const void* grid, const void* xin, const void* w_in,
                  const void* b_in, const void* wz, const void* bz,
                  const void* w0, const void* b0, const void* w1,
                  const void* b1, const void* w_out, const void* b_out,
                  void* out, void* zstash, void* spre, void* spost, int sb, int ns,
                  int b, int d_in, int d_in_pad, int hidden, int d_out, int n_blocks,
                  int combine_layer, void* stream) {
  FieldLevels lv;
  int c0 = 0;
  for (int l = 0; l < MAX_LEVELS; l++) {
    const bool on = l < nlev;
    lv.feats[l] = on ? static_cast<const bf16*>(feats[l]) : nullptr;
    lv.lh[l] = on ? dims[3 * l] : 0;
    lv.lw[l] = on ? dims[3 * l + 1] : 0;
    lv.lc[l] = on ? dims[3 * l + 2] : 0;
    lv.lc0[l] = c0;
    c0 += lv.lc[l];
  }
  lv.nlev = nlev;
  lv.grid = static_cast<const float*>(grid);
  ChainParams c;
  ChainMaps maps;
  const int err = chain_setup(&c, &maps, xin, w_in, b_in, wz, bz, w0, b0, w1, b1, w_out, b_out,
                              out, spre, spost, sb, ns, b, c0, d_in, d_in_pad, hidden, d_out,
                              n_blocks, combine_layer);
  if (err) return err;
  c.zstash = spost != nullptr ? static_cast<bf16*>(zstash) : nullptr;
  const size_t smem = fwd_smem_bytes(hidden, c0, ns);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_hidden(
      hidden, [&](auto h) { return launch<decltype(h)::value>(c, maps, lv, smem, st); });
}

}  // extern "C"
