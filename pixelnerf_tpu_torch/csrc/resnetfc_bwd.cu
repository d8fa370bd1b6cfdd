// ResnetFC backward from the bf16 stash: dz, dxin and every weight
// gradient, with no recomputation of the forward; and the fused field's
// backward, which scatters dz onto the native pyramid levels instead.
//
// Replaces the TPU kernels pixelnerf_tpu/ops/resnetfc_pallas.py:
// `_bwd_kernel` / `_backward_tile` (`_fused_bwd_impl`) and
// pixelnerf_tpu/ops/field_pallas.py: `_field_bwd_kernel`
// (`_field_vjp_bwd`).
//
// What it computes (row-wise over the points; `bf(.)` rounds to bf16, the
// casts of the TPU kernel's `_dot_t` and `_dot_g`; masks are stash > 0):
//   the cotangent chain, dxin, dz (or the field's level gradients) and the
//   bias gradients: bwd_chain.cuh;
//   dW = act^T @ bf(G): dw1_i = relu(h1_i)^T G1_i, dw0_i = relu(bin_i)^T
//        G0_i, dwz_i = z^T Gin_i, dw_in = xin^T gx, dw_out = relu(xf)^T g
//
// The field's backward (levels given): z is the forward's bf16 z-stash, and
// the chain's epilogue rounds gz to bf16 once and adds w * bf(gz) into
// per-level f32 gradients (B, H_l, W_l, C_l) with f32 reductions merged
// along runs of consecutive points (bwd_chain.cuh: scatter_gz), w the
// composed taps rounded as the forward's (tile_common.cuh:level_taps),
// recomputed from the grid: pyramid.cu's scatter of dz, with the (M, DL)
// cotangent never written to device memory (field_pallas.py:26-30).
//
// Bound on the H100: operations. The backward does about twice the
// forward's bf16 products (~23 MFLOP a point at the flagship width and
// NS=2) against ~17 KB of stash read a point; the field's scatter adds
// bytes, not operations worth counting.
//
// Design: the TPU kernel sums weight gradients across its sequential grid,
// which Hopper's concurrent CTAs cannot do. So three kernels:
// 1. `chain`: one CTA per point tile (the forward's 64-row tiling) walks the
//    blocks backward with wgmma on TMA-fed weight tiles (bwd_chain.cuh),
//    writing the bf16 cotangents G1, G0, Gin and bf(g) to device memory in
//    the stash's layout.
// 2. `wgrad_products`: every weight gradient act^T @ G over all points in
//    one grouped launch, TMA-fed wgmma on 128 x 256 output tiles over
//    splits of the point axis, each split's partial tile stored apart.
// 3. `wgrad_reduce`: the splits summed in a fixed order into the gradients
//    (wgrad.cuh), so the weight gradients are the same from run to run.

#include "wgrad.cuh"

// FIELD: the field's epilogue (the level scatter) in place of the dz copy,
// compiled apart so that the ResnetFC's chain keeps its own register
// allocation
template <int H, bool FIELD>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    resnetfc_bwd_chain_kernel(const __grid_constant__ BwdParams p,
                              const __grid_constant__ BwdMaps maps) {
  run_bwd_chain<H, FIELD>(p, maps);
}

template <int H, bool FIELD>
static int launch_chain(const BwdParams& p, const BwdMaps& maps, size_t smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(resnetfc_bwd_chain_kernel<H, FIELD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_dim((p.b + p.pts - 1) / p.pts, p.sb);
  resnetfc_bwd_chain_kernel<H, FIELD><<<grid_dim, FWD_THREADS, smem, stream>>>(p, maps);
  return (int)cudaGetLastError();
}

extern "C" {

size_t pnt_resnetfc_bwd_smem_bytes(int hidden, int d_latent, int ns) {
  return bwd_smem_bytes(hidden, d_latent, ns);
}

// ptrs, in order: z, xin, g, spre, spost, w_in, wz, w0, w1, w_out, gpre,
// gpost, gin, gout, dz, dxin, dw_in, db_in, dwz, dbz, dw0, db0, dw1, db1,
// dw_out, db_out, xin_pad (xin's columns zero-padded to d_in_pad), ws (the
// f32 workspace of pnt_wgrad_workspace's floats). dims: as bwd_dims. For
// the field, nlev > 0 level gradients `grads` of (H_l, W_l, C_l) `ldims`
// (finest first) and the `grid` of the forward, and dz is not written; nlev
// 0 ignores the three. Gradients are added to (the caller zeroes them).
// Launches the chain kernel, the weight-gradient products and their
// reduction on `stream`, adding each kernel launched to launched[0] (the
// chain) or launched[1] (wgrad: products and reduction); returns the first
// error.
int pnt_resnetfc_bwd(void* const* ptrs, const int* dims, void* const* grads, const int* ldims,
                     int nlev, const void* grid, void* stream_, int* launched) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  BwdParams p;
  bwd_dims(&p, dims);
  p.z = static_cast<const bf16*>(ptrs[0]);
  p.xin = static_cast<const bf16*>(ptrs[1]);
  p.g = static_cast<const float*>(ptrs[2]);
  p.spre = static_cast<const bf16*>(ptrs[3]);
  p.spost = static_cast<const bf16*>(ptrs[4]);
  p.w_in = static_cast<const bf16*>(ptrs[5]);
  p.wz = static_cast<const bf16*>(ptrs[6]);
  p.w0 = static_cast<const bf16*>(ptrs[7]);
  p.w1 = static_cast<const bf16*>(ptrs[8]);
  p.w_out = static_cast<const bf16*>(ptrs[9]);
  p.gpre = static_cast<bf16*>(ptrs[10]);
  p.gpost = static_cast<bf16*>(ptrs[11]);
  p.gin = static_cast<bf16*>(ptrs[12]);
  p.gout = static_cast<bf16*>(ptrs[13]);
  p.dz = static_cast<bf16*>(ptrs[14]);
  p.dxin = static_cast<bf16*>(ptrs[15]);
  float* dw_in = static_cast<float*>(ptrs[16]);
  p.db_in = static_cast<float*>(ptrs[17]);
  float* dwz = static_cast<float*>(ptrs[18]);
  p.dbz = static_cast<float*>(ptrs[19]);
  float* dw0 = static_cast<float*>(ptrs[20]);
  p.db0 = static_cast<float*>(ptrs[21]);
  float* dw1 = static_cast<float*>(ptrs[22]);
  p.db1 = static_cast<float*>(ptrs[23]);
  float* dw_out = static_cast<float*>(ptrs[24]);
  p.db_out = static_cast<float*>(ptrs[25]);
  int c0 = 0;
  for (int l = 0; l < MAX_LEVELS; l++) {
    const bool on = l < nlev;
    p.grads[l] = on ? static_cast<float*>(grads[l]) : nullptr;
    p.lh[l] = on ? ldims[3 * l] : 0;
    p.lw[l] = on ? ldims[3 * l + 1] : 0;
    p.lc[l] = on ? ldims[3 * l + 2] : 0;
    p.lc0[l] = c0;
    c0 += p.lc[l];
  }
  p.nlev = nlev;
  p.grid = static_cast<const float*>(grid);
  if (nlev > 0 && c0 != p.d_latent) return (int)cudaErrorInvalidValue;
  // the widths and views of the forward chain (fwd_chain.cuh: chain_setup)
  if (!chain_dims_ok(p.hidden, p.d_latent, p.d_in, p.d_in_pad, p.d_out, p.ns, p.n_inj))
    return (int)cudaErrorInvalidValue;
  BwdMaps maps;
  const int nh = bwd_nh(p.hidden);
  int rc = weight_map(&maps.w1, p.w1, p.n_blocks * p.hidden, p.hidden, BWD_KW, nh, 1);
  if (!rc) rc = weight_map(&maps.w0, p.w0, p.n_blocks * p.hidden, p.hidden, BWD_KW, nh, 1);
  if (!rc) rc = weight_map(&maps.w_in, p.w_in, p.d_in_pad, p.hidden, BWD_KS, BWD_IW, 1);
  if (!rc) rc = weight_map(&maps.wz, p.wz, p.n_inj * p.d_latent, p.hidden, BWD_KS, BWD_ZW, 1);
  if (rc) return rc;
  const size_t smem = bwd_smem_bytes(p.hidden, p.d_latent, p.ns);
  rc = dispatch_hidden(p.hidden, [&](auto h) {
    return p.nlev > 0 ? launch_chain<decltype(h)::value, true>(p, maps, smem, stream)
                      : launch_chain<decltype(h)::value, false>(p, maps, smem, stream);
  });
  if (rc) return rc;
  launched[0]++;
  return wgrad_launch(p, static_cast<const bf16*>(ptrs[26]), static_cast<float*>(ptrs[27]), dw_in,
                      dwz, dw0, dw1, dw_out, stream, &launched[1]);
}

}  // extern "C"
