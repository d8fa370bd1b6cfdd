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
// per-level f32 gradients (B, H_l, W_l, C_l) with f32 atomics, w the
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
// which Hopper's concurrent CTAs cannot do. So two kernels:
// 1. `chain`: one CTA per point tile (the forward's 64-row tiling) walks the
//    blocks backward with wgmma on TMA-fed weight tiles (bwd_chain.cuh),
//    writing the bf16 cotangents G1, G0, Gin and bf(g) to device memory in
//    the stash's layout.
// 2. `wgrad`: a split-K wmma product act^T @ G over all points for each
//    weight gradient: 64x64 output tiles, the point axis cut into slices,
//    f32 atomics into the result.

#include "bwd_chain.cuh"

#define WG_BM 32   // points a step of the weight-gradient product
#define WG_BK 64   // rows of act^T (the weight's input side) per CTA
#define WG_BN 64   // columns of G per CTA
#define WG_LD 72   // padded shared-memory row (bf16 elements)
#define WG_THREADS 128

template <int H>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    resnetfc_bwd_chain_kernel(const __grid_constant__ BwdParams p,
                              const __grid_constant__ BwdMaps maps) {
  run_bwd_chain<H>(p, maps);
}

template <int H>
static int launch_chain(const BwdParams& p, const BwdMaps& maps, size_t smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(resnetfc_bwd_chain_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_dim((p.b + p.pts - 1) / p.pts, p.sb);
  resnetfc_bwd_chain_kernel<H><<<grid_dim, FWD_THREADS, smem, stream>>>(p, maps);
  return (int)cudaGetLastError();
}

struct WgParams {
  const bf16* a;  // (M, ka), row stride lda
  const bf16* g;  // (M, n), row stride ldg
  float* c;       // (ka, n), row stride ldc; added to
  int m, ka, n, lda, ldg, ldc, rows_per_split;
};

// rows [m0, m0 + WG_BM) x columns [c0, c0 + 64) of a (M, cols) bf16 matrix
// into a shared-memory tile, zero past the edges
__device__ __forceinline__ void load_tile(bf16 (*dst)[WG_LD], const bf16* src, int ld,
                                          int m0, int mend, int c0, int cols) {
  for (int e = threadIdx.x; e < WG_BM * 8; e += WG_THREADS) {
    const int r = e / 8, c8 = (e % 8) * 8;
    const int mr = m0 + r, cc = c0 + c8;
    bf16* d = &dst[r][c8];
    const bf16* sp = src + (size_t)mr * ld + cc;
    if (mr < mend && cc + 8 <= cols && ld % 8 == 0) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(sp);
    } else {
#pragma unroll
      for (int i = 0; i < 8; i++)
        d[i] = (mr < mend && cc + i < cols) ? sp[i] : __float2bfloat16(0.f);
    }
  }
}

__global__ void __launch_bounds__(WG_THREADS) wgrad_kernel(WgParams p) {
  __shared__ __align__(32) bf16 As[WG_BM][WG_LD];
  __shared__ __align__(32) bf16 Gs[WG_BM][WG_LD];
  __shared__ __align__(32) float stage[4][256];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / 2, wc = warp % 2;
  const int ka0 = blockIdx.x * WG_BK, n0 = blockIdx.y * WG_BN;
  const int mbeg = blockIdx.z * p.rows_per_split;
  const int mend = min(p.m, mbeg + p.rows_per_split);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; i++)
#pragma unroll
    for (int j = 0; j < 2; j++) wmma::fill_fragment(acc[i][j], 0.f);
  for (int m0 = mbeg; m0 < mend; m0 += WG_BM) {
    load_tile(As, p.a, p.lda, m0, mend, ka0, p.ka);
    load_tile(Gs, p.g, p.ldg, m0, mend, n0, p.n);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WG_BM; kk += 16) {
      // act^T (ka x points): the point axis runs down the shared tile's rows
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; i++) {
        wmma::load_matrix_sync(a[i], &As[kk][wr * 32 + i * 16], WG_LD);
        wmma::load_matrix_sync(b[i], &Gs[kk][wc * 32 + i * 16], WG_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; i++)
#pragma unroll
        for (int j = 0; j < 2; j++) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; i++)
#pragma unroll
    for (int j = 0; j < 2; j++) {
      wmma::store_matrix_sync(stage[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = ka0 + wr * 32 + i * 16 + e / 16, c = n0 + wc * 32 + j * 16 + e % 16;
        if (r < p.ka && c < p.n) atomicAdd(p.c + (size_t)r * p.ldc + c, stage[warp][e]);
      }
      __syncwarp();
    }
}

static int launch_wgrad(const bf16* a, int lda, const bf16* g, int ldg, float* c, int ldc,
                        int m, int ka, int n, cudaStream_t stream) {
  WgParams p = {a, g, c, m, ka, n, lda, ldg, ldc, 0};
  const int tiles = ((ka + WG_BK - 1) / WG_BK) * ((n + WG_BN - 1) / WG_BN);
  int splits = (4 * 132 + tiles - 1) / tiles;
  const int max_splits = (m + 127) / 128;  // at least 128 points a slice
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  p.rows_per_split = ((m + splits - 1) / splits + WG_BM - 1) / WG_BM * WG_BM;
  splits = (m + p.rows_per_split - 1) / p.rows_per_split;
  dim3 grid((ka + WG_BK - 1) / WG_BK, (n + WG_BN - 1) / WG_BN, splits > 0 ? splits : 1);
  wgrad_kernel<<<grid, WG_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" {

size_t pnt_resnetfc_bwd_smem_bytes(int hidden, int d_latent, int ns) {
  return bwd_smem_bytes(hidden, d_latent, ns);
}

// ptrs, in order: z, xin, g, spre, spost, w_in, wz, w0, w1, w_out, gpre,
// gpost, gin, gout, dz, dxin, dw_in, db_in, dwz, dbz, dw0, db0, dw1, db1,
// dw_out, db_out. dims: sb, ns, b, d_latent, d_in, d_in_pad, hidden,
// d_out, n_blocks, combine_layer. For the field, nlev > 0 level gradients
// `grads` of (H_l, W_l, C_l) `ldims` (finest first) and the `grid` of the
// forward, and dz is not written; nlev 0 ignores the three. Gradients are
// added to (the caller zeroes them). Launches the chain kernel and the
// weight-gradient products on `stream`, adding each kernel launched to
// launched[0] (the chain) or launched[1] (wgrad); returns the first
// cudaGetLastError() that fails.
int pnt_resnetfc_bwd(void* const* ptrs, const int* dims, void* const* grads, const int* ldims,
                     int nlev, const void* grid, void* stream_, int* launched) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  BwdParams p;
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
  p.sb = dims[0];
  p.ns = dims[1];
  p.b = dims[2];
  p.d_latent = dims[3];
  p.d_in = dims[4];
  p.d_in_pad = dims[5];
  p.hidden = dims[6];
  p.d_out = dims[7];
  p.n_blocks = dims[8];
  p.combine_layer = dims[9];
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
  p.pts = chain_points(p.ns);
  p.n_inj = p.combine_layer < p.n_blocks ? p.combine_layer : p.n_blocks;
  p.k = p.ns > 1 ? p.n_inj : 0;
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
  rc = dispatch_hidden(
      p.hidden, [&](auto h) { return launch_chain<decltype(h)::value>(p, maps, smem, stream); });
  if (rc) return rc;
  launched[0]++;
  auto wgrad = [&](const bf16* a, int lda, const bf16* g, int ldg, float* c, int ldc, int m,
                   int ka, int n) {
    const int err = launch_wgrad(a, lda, g, ldg, c, ldc, m, ka, n, stream);
    if (!err) launched[1]++;
    return err;
  };

  const int H = p.hidden, DL = p.d_latent, k = p.k, m = p.n_blocks - p.k;
  const int n_inj = p.combine_layer < p.n_blocks ? p.combine_layer : p.n_blocks;
  const int mpre = p.sb * p.ns * p.b, mpost = p.sb * p.b;
  const size_t hh = (size_t)H * H;
  // dw_out = relu(x_final)^T bf(g)
  rc = wgrad(p.spost + (size_t)2 * m * mpost * H, H, p.gout, GOUT_LD, dw_out, p.d_out, mpost, H,
             p.d_out);
  for (int blk = 0; blk < p.n_blocks && !rc; blk++) {
    const bool pre = blk < k;
    const int mrows = pre ? mpre : mpost;
    const bf16* rx = pre ? p.spre + (size_t)blk * mrows * H : p.spost + (size_t)(blk - k) * mrows * H;
    const bf16* rh = pre ? p.spre + (size_t)(k + blk) * mrows * H
                         : p.spost + (size_t)(m + blk - k) * mrows * H;
    const bf16* g1 = pre ? p.gpre + (size_t)blk * mrows * H : p.gpost + (size_t)(blk - k) * mrows * H;
    const bf16* g0 = pre ? p.gpre + (size_t)(k + blk) * mrows * H
                         : p.gpost + (size_t)(m + blk - k) * mrows * H;
    rc = wgrad(rh, H, g1, H, dw1 + blk * hh, H, mrows, H, H);
    if (!rc) rc = wgrad(rx, H, g0, H, dw0 + blk * hh, H, mrows, H, H);
  }
  // dwz_i = z^T Gin_i, with Gin_0 = gin and Gin_i = G1_{i-1} (the
  // cotangent at block i's input is the one at block i-1's output)
  for (int blk = 0; blk < n_inj && !rc; blk++) {
    const bool pre = blk - 1 < k;
    const bf16* gi = blk == 0 ? p.gin
                     : pre    ? p.gpre + (size_t)(blk - 1) * mpre * H
                              : p.gpost + (size_t)(blk - 1 - k) * mpost * H;
    rc = wgrad(p.z, DL, gi, H, dwz + (size_t)blk * DL * H, H, mpre, DL, H);
  }
  if (!rc) rc = wgrad(p.xin, p.d_in, p.gin, H, dw_in, H, mpre, p.d_in, H);
  return rc;
}

}  // extern "C"
