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
//   gx         = bf(g) @ W_out^T * (relu(x_final) > 0)
//   block i, from the last:  G1_i = gx (the cotangent at its output)
//              gh1  = bf(gx) @ W1_i^T * (relu(h1_i) > 0)     G0_i = gh1
//              gx  += bf(gh1) @ W0_i^T * (relu(block_in_i) > 0)
//              i < n_inj: gz += bf(gx) @ Wz_i^T; Gin_i = gx
//              i == combine_layer, NS > 1: gx = broadcast(gx) / NS
//   dxin = bf(gx) @ W_in^T,  dz = gz (f32, then cast to bf16)
//   db = column sums of the f32 cotangents (db1_i of G1_i, db0_i of G0_i,
//        dbz_i of Gin_i, db_in of gx, db_out of g)
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
// Design, simple first: the TPU kernel sums weight gradients across its
// sequential grid, which Hopper's concurrent CTAs cannot do. So two kernels:
// 1. `chain`: one CTA per point tile (the forward's tiling) walks the
//    blocks backward with wmma (weights read transposed as col-major
//    fragments from L2), keeps gx and gz in f32 shared memory, writes the
//    bf16 cotangents G1, G0, Gin and bf(g) to device memory in the stash's
//    layout, writes dz (or, for the field, scatters it from shared memory,
//    one warp per row, lanes over channels) and dxin, and adds each tile's
//    f32 column sums to the bias gradients with one f32 atomic per column.
// 2. `wgrad`: a split-K wmma product act^T @ G over all points for each
//    weight gradient: 64x64 output tiles, the point axis cut into slices,
//    f32 atomics into the result.

#include "tile_common.cuh"

#define WG_BM 32   // points a step of the weight-gradient product
#define WG_BK 64   // rows of act^T (the weight's input side) per CTA
#define WG_BN 64   // columns of G per CTA
#define WG_LD 72   // padded shared-memory row (bf16 elements)
#define WG_THREADS 128
#define GOUT_LD 16 // columns of the bf16 copy of g (d_out <= 16)

struct BwdParams {
  const bf16* z;      // (SB, NS, B, DL)
  const bf16* xin;    // (SB, NS, B, d_in)
  const float* g;     // (SB, B, d_out)
  const bf16* spre;   // (2k, SB, NS, B, H)
  const bf16* spost;  // (2m+1, SB, B, H)
  const bf16* w_in;   // (d_in_pad, H)
  const bf16* wz;     // (n_inj, DL, H)
  const bf16* w0;     // (n_blocks, H, H)
  const bf16* w1;
  const bf16* w_out;  // (H, d_out)
  bf16* gpre;         // (2k, SB, NS, B, H): [G1 | G0] of the pre-pool blocks
  bf16* gpost;        // (2m, SB, B, H): [G1 | G0] of the others
  bf16* gin;          // (SB, NS, B, H): cotangent at block 0's input
  bf16* gout;         // (SB, B, GOUT_LD): bf(g), zero past d_out
  bf16* dz;           // (SB, NS, B, DL); null for the field
  bf16* dxin;         // (SB, NS, B, d_in)
  float* grads[MAX_LEVELS];  // the field's level gradients (SB*NS, H_l, W_l, C_l)
  int lh[MAX_LEVELS], lw[MAX_LEVELS], lc[MAX_LEVELS], lc0[MAX_LEVELS];
  int nlev;           // 0: no levels, write dz
  const float* grid;  // (SB, NS, B, 2) normalized fine-grid coords
  float* db_in;       // (H)
  float* dbz;         // (n_inj, H)
  float* db0;         // (n_blocks, H)
  float* db1;
  float* db_out;      // (d_out)
  int sb, ns, b, tb, rows_pad, d_in, d_in_pad, hidden, d_latent, d_out,
      n_blocks, combine_layer, k;
};

// global row of tile row r, or -1 past the points: pre-pool rows r = v * tb
// + pt index (SB, NS, B) arrays, post-pool rows r = pt index (SB, B) ones
__device__ __forceinline__ long long tile_row(const BwdParams& p, bool pre, int s,
                                              int p0, int r) {
  const int tb = p.tb;
  if (pre) {
    if (r >= p.ns * tb || p0 + r % tb >= p.b) return -1;
    return ((long long)s * p.ns + r / tb) * p.b + p0 + r % tb;
  }
  if (r >= tb || p0 + r >= p.b) return -1;
  return (long long)s * p.b + p0 + r;
}

// element (r, c) of a stash (or cotangent) slot: a slot of a pre-pool
// array holds SB*NS*B rows, of a post-pool one SB*B
__device__ __forceinline__ size_t slot_rows(const BwdParams& p, bool pre) {
  return (size_t)p.sb * (pre ? p.ns : 1) * p.b;
}

// rows [0, nrows) of a bf16 tile (stride ld, H wide) to their global rows
// of a cotangent slot
__device__ void store_rows(const BwdParams& p, const bf16* tile, int ld, bool pre,
                           bf16* slot, int s, int p0, int nrows) {
  const int H = p.hidden, chunks = H / 8;
  for (int e = threadIdx.x; e < nrows * chunks; e += THREADS) {
    const int r = e / chunks, c8 = (e % chunks) * 8;
    const long long row = tile_row(p, pre, s, p0, r);
    if (row < 0) continue;
    *reinterpret_cast<uint4*>(slot + row * H + c8) =
        *reinterpret_cast<const uint4*>(tile + r * ld + c8);
  }
}

// Gb = bf(GX) over rows [0, nrows), and the f32 column sums of GX added to
// db (one atomic per column); ends with __syncthreads
__device__ void round_and_sum(const float* GX, bf16* Gb, int H, int nrows, float* db) {
  for (int e = threadIdx.x; e < nrows * H; e += THREADS) Gb[e] = __float2bfloat16(GX[e]);
  for (int c = threadIdx.x; c < H; c += THREADS) {
    float sum = 0.f;
    for (int r = 0; r < nrows; r++) sum += GX[r * H + c];
    atomicAdd(db + c, sum);
  }
  __syncthreads();
}

// the field's epilogue: each pre-pool row's bf16 gz times its composed
// taps, added into the level gradients of its map (s, v)
__device__ void scatter_gz(const BwdParams& p, const float* GZ, int s, int p0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tb = p.tb, DL = p.d_latent, hf = p.lh[0], wf = p.lw[0];
  for (int r = warp; r < p.ns * tb; r += WARPS) {
    const int v = r / tb, pt = p0 + r % tb;
    if (pt >= p.b) continue;
    const size_t map = (size_t)s * p.ns + v;
    float fx, fy;
    fine_coords(p.grid + (map * p.b + pt) * 2, hf, wf, &fx, &fy);
    for (int l = 0; l < p.nlev; l++) {
      const int hn = p.lh[l], wn = p.lw[l], C = p.lc[l];
      int bx, by;
      float w[3][3];
      level_taps(fx, fy, hn, wn, hf, wf, &bx, &by, w);
      float* grad = p.grads[l] + map * hn * wn * C;
      const float* g = GZ + r * DL + p.lc0[l];
      for (int c = lane; c < C; c += 32) {
        const float gv = round_bf16(g[c]);
#pragma unroll
        for (int ty = 0; ty < 3; ty++) {
          if (by + ty >= hn) continue;
#pragma unroll
          for (int tx = 0; tx < 3; tx++) {
            if (bx + tx >= wn || w[ty][tx] == 0.f) continue;
            atomicAdd(grad + ((size_t)(by + ty) * wn + bx + tx) * C + c, w[ty][tx] * gv);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) resnetfc_bwd_chain_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.hidden, DL = p.d_latent, RP = p.rows_pad;
  float* GX = reinterpret_cast<float*>(smem);  // RP x H
  float* GZ = GX + RP * H;                     // RP x DL
  float* csum = GZ + RP * DL;                  // H
  float* gsm = csum + H;                       // RP x GOUT_LD: g, f32
  float* stage = gsm + RP * GOUT_LD + (threadIdx.x / 32) * 256;
  bf16* Gb = reinterpret_cast<bf16*>(gsm + RP * GOUT_LD + WARPS * 256);  // RP x H
  bf16* Hb = Gb + RP * H;                                               // RP x H

  const int s = blockIdx.y, tb = p.tb, ns = p.ns;
  const int p0 = blockIdx.x * tb;
  const int k = p.k, m = p.n_blocks - p.k;
  const int n_inj = p.combine_layer < p.n_blocks ? p.combine_layer : p.n_blocks;
  const int cur_post = (tb + 15) / 16 * 16;
  const size_t pre_rows = slot_rows(p, true), post_rows = slot_rows(p, false);

  // 1. g for the tile's points (zero past B), its bf16 copy, db_out
  for (int e = threadIdx.x; e < RP * GOUT_LD; e += THREADS) {
    const int r = e / GOUT_LD, o = e % GOUT_LD;
    const long long row = tile_row(p, false, s, p0, r);
    const float v = (row >= 0 && o < p.d_out) ? p.g[row * p.d_out + o] : 0.f;
    gsm[e] = v;
    if (row >= 0) p.gout[row * GOUT_LD + o] = __float2bfloat16(v);
  }
  for (int e = threadIdx.x; e < RP * DL; e += THREADS) GZ[e] = 0.f;
  __syncthreads();
  for (int o = threadIdx.x; o < p.d_out; o += THREADS) {
    float sum = 0.f;
    for (int r = 0; r < tb; r++) sum += gsm[r * GOUT_LD + o];
    atomicAdd(p.db_out + o, sum);
  }
  // gx = bf(g) @ W_out^T * (relu(x_final) > 0), post-pool rows
  const bf16* sxf = p.spost + 2 * m * post_rows * H;
  for (int e = threadIdx.x; e < RP * H; e += THREADS) {
    const int r = e / H, c = e % H;
    const long long row = tile_row(p, false, s, p0, r);
    float v = 0.f;
    if (row >= 0 && __bfloat162float(sxf[row * H + c]) > 0.f)
      for (int o = 0; o < p.d_out; o++)
        v += __bfloat162float(__float2bfloat16(gsm[r * GOUT_LD + o])) *
             __bfloat162float(p.w_out[c * p.d_out + o]);
    GX[e] = v;
  }
  __syncthreads();

  // 2. the blocks, from the last
  for (int blk = p.n_blocks - 1; blk >= 0; blk--) {
    const bool pre = blk < k;
    const int cur = pre ? RP : cur_post;
    const size_t nrow = pre ? pre_rows : post_rows;
    const bf16* rx = pre ? p.spre + (size_t)blk * nrow * H : p.spost + (size_t)(blk - k) * nrow * H;
    const bf16* rh = pre ? p.spre + (size_t)(k + blk) * nrow * H
                         : p.spost + (size_t)(m + blk - k) * nrow * H;
    bf16* g1 = pre ? p.gpre + (size_t)blk * nrow * H : p.gpost + (size_t)(blk - k) * nrow * H;
    bf16* g0 = pre ? p.gpre + (size_t)(k + blk) * nrow * H
                   : p.gpost + (size_t)(m + blk - k) * nrow * H;

    round_and_sum(GX, Gb, H, cur, p.db1 + (size_t)blk * H);
    store_rows(p, Gb, H, pre, g1, s, p0, cur);
    for (int c = threadIdx.x; c < H; c += THREADS) csum[c] = 0.f;
    __syncthreads();
    // gh1 = bf(gx) @ W1^T * mask(relu(h1)), kept as bf16 (G0) and summed
    tile_mm<true>(Gb, H, H, cur / 16, p.w1 + (size_t)blk * H * H, H, H, stage,
                  [&](int r, int c, float v) {
                    const long long row = tile_row(p, pre, s, p0, r);
                    const float gv =
                        (row >= 0 && __bfloat162float(rh[row * H + c]) > 0.f) ? v : 0.f;
                    Hb[r * H + c] = __float2bfloat16(gv);
                    atomicAdd(csum + c, gv);
                  });
    __syncthreads();
    for (int c = threadIdx.x; c < H; c += THREADS) atomicAdd(p.db0 + (size_t)blk * H + c, csum[c]);
    store_rows(p, Hb, H, pre, g0, s, p0, cur);
    // gx += bf(gh1) @ W0^T * mask(relu(block_in))
    tile_mm<true>(Hb, H, H, cur / 16, p.w0 + (size_t)blk * H * H, H, H, stage,
                  [&](int r, int c, float v) {
                    const long long row = tile_row(p, pre, s, p0, r);
                    if (row >= 0 && __bfloat162float(rx[row * H + c]) > 0.f) GX[r * H + c] += v;
                  });
    __syncthreads();
    if (blk < n_inj) {
      // gz += bf(gx) @ Wz^T; dbz from the same f32 cotangent
      round_and_sum(GX, Gb, H, cur, p.dbz + (size_t)blk * H);
      tile_mm<true>(Gb, H, H, cur / 16, p.wz + (size_t)blk * DL * H, H, DL, stage,
                    [&](int r, int c, float v) { GZ[r * DL + c] += v; });
      __syncthreads();
    }
    if (blk == p.combine_layer && ns > 1) {
      // un-pool the view average: each view row gets gx / NS
      for (int e = threadIdx.x; e < tb * H; e += THREADS) {
        const int pt = e / H, c = e % H;
        const float v = GX[pt * H + c] / (float)ns;
        for (int vv = 0; vv < ns; vv++) GX[(vv * tb + pt) * H + c] = v;
      }
      for (int e = ns * tb * H + threadIdx.x; e < RP * H; e += THREADS) GX[e] = 0.f;
      __syncthreads();
    }
  }

  // 3. block 0's input: Gin, db_in, dxin = bf(gx) @ W_in^T; dz = gz
  const bool pre0 = k > 0;
  const int cur0 = pre0 ? RP : cur_post;
  round_and_sum(GX, Gb, H, cur0, p.db_in);
  // for NS == 1 the (SB, 1, B) rows of gin, dz and dxin are the post rows
  store_rows(p, Gb, H, pre0, p.gin, s, p0, cur0);
  tile_mm<true>(Gb, H, H, cur0 / 16, p.w_in, H, p.d_in_pad, stage,
                [&](int r, int c, float v) {
                  const long long row = tile_row(p, pre0, s, p0, r);
                  if (row >= 0 && c < p.d_in) p.dxin[row * p.d_in + c] = __float2bfloat16(v);
                });
  if (p.nlev > 0) {
    scatter_gz(p, GZ, s, p0);
    return;
  }
  for (int e = threadIdx.x; e < cur0 * DL; e += THREADS) {
    const int r = e / DL, c = e % DL;
    const long long row = tile_row(p, pre0, s, p0, r);
    if (row >= 0) p.dz[row * DL + c] = __float2bfloat16(GZ[e]);
  }
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
  const size_t rp = tile_rows_padded(ns);
  return rp * hidden * 4 + rp * d_latent * 4 + hidden * 4 + rp * GOUT_LD * 4 +
         (size_t)WARPS * 256 * 4 + 2 * rp * hidden * 2;
}

// ptrs, in order: z, xin, g, spre, spost, w_in, wz, w0, w1, w_out, gpre,
// gpost, gin, gout, dz, dxin, dw_in, db_in, dwz, dbz, dw0, db0, dw1, db1,
// dw_out, db_out. dims: sb, ns, b, d_latent, d_in, d_in_pad, hidden,
// d_out, n_blocks, combine_layer. For the field, nlev > 0 level gradients
// `grads` of (H_l, W_l, C_l) `ldims` (finest first) and the `grid` of the
// forward, and dz is not written; nlev 0 ignores the three. Gradients are
// added to (the caller zeroes them). Launches the chain kernel and the
// weight-gradient products on `stream`; returns the first
// cudaGetLastError() that fails.
int pnt_resnetfc_bwd(void* const* ptrs, const int* dims, void* const* grads, const int* ldims,
                     int nlev, const void* grid, void* stream_) {
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
  p.tb = tile_points(p.ns);
  p.rows_pad = tile_rows_padded(p.ns);
  p.k = p.ns > 1 ? (p.combine_layer < p.n_blocks ? p.combine_layer : p.n_blocks) : 0;
  if (p.d_out > GOUT_LD) return (int)cudaErrorInvalidValue;

  const size_t smem = pnt_resnetfc_bwd_smem_bytes(p.hidden, p.d_latent, p.ns);
  cudaError_t err = cudaFuncSetAttribute(
      resnetfc_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_dim((p.b + p.tb - 1) / p.tb, p.sb);
  resnetfc_bwd_chain_kernel<<<grid_dim, THREADS, smem, stream>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;

  const int H = p.hidden, DL = p.d_latent, k = p.k, m = p.n_blocks - p.k;
  const int n_inj = p.combine_layer < p.n_blocks ? p.combine_layer : p.n_blocks;
  const int mpre = p.sb * p.ns * p.b, mpost = p.sb * p.b;
  const size_t hh = (size_t)H * H;
  // dw_out = relu(x_final)^T bf(g)
  rc = launch_wgrad(p.spost + (size_t)2 * m * mpost * H, H, p.gout, GOUT_LD, dw_out, p.d_out,
                    mpost, H, p.d_out, stream);
  for (int blk = 0; blk < p.n_blocks && !rc; blk++) {
    const bool pre = blk < k;
    const int mrows = pre ? mpre : mpost;
    const bf16* rx = pre ? p.spre + (size_t)blk * mrows * H : p.spost + (size_t)(blk - k) * mrows * H;
    const bf16* rh = pre ? p.spre + (size_t)(k + blk) * mrows * H
                         : p.spost + (size_t)(m + blk - k) * mrows * H;
    const bf16* g1 = pre ? p.gpre + (size_t)blk * mrows * H : p.gpost + (size_t)(blk - k) * mrows * H;
    const bf16* g0 = pre ? p.gpre + (size_t)(k + blk) * mrows * H
                         : p.gpost + (size_t)(m + blk - k) * mrows * H;
    rc = launch_wgrad(rh, H, g1, H, dw1 + blk * hh, H, mrows, H, H, stream);
    if (!rc) rc = launch_wgrad(rx, H, g0, H, dw0 + blk * hh, H, mrows, H, H, stream);
  }
  // dwz_i = z^T Gin_i, with Gin_0 = gin and Gin_i = G1_{i-1} (the
  // cotangent at block i's input is the one at block i-1's output)
  for (int blk = 0; blk < n_inj && !rc; blk++) {
    const bool pre = blk - 1 < k;
    const bf16* gi = blk == 0 ? p.gin
                     : pre    ? p.gpre + (size_t)(blk - 1) * mpre * H
                              : p.gpost + (size_t)(blk - 1 - k) * mpost * H;
    rc = launch_wgrad(p.z, DL, gi, H, dwz + (size_t)blk * DL * H, H, mpre, DL, H, stream);
  }
  if (!rc) rc = launch_wgrad(p.xin, p.d_in, p.gin, H, dw_in, H, mpre, p.d_in, H, stream);
  return rc;
}

}  // extern "C"
