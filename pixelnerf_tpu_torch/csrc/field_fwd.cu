// Fused pixel-aligned field forward: native-pyramid gather -> ResnetFC.
//
// Replaces the TPU kernel pixelnerf_tpu/ops/field_pallas.py:
// pyramid_field_fused (forward, `_field_fwd_kernel` with stash=False),
// whose gather math is pyramid_pallas.py `_fine_coords` / `_axis_pairs`
// and whose MLP is resnetfc_pallas.py `_forward_body`.
//
// What it computes, per scene s and point p, for NS source views:
//   z_v   = sum over the composed <=3x3 taps of each native level of
//           w * feat_l[view v]   (upsample-then-bilinear, border padding,
//           align_corners), concatenated over levels, cast to bf16
//   x     = xin_v @ W_in + b_in                       (f32 residual stream)
//   block i: [mean over views at i == combine_layer]
//            x += z_v @ Wz_i + bz_i                  (i < combine_layer)
//            x += relu(relu(x) @ W0_i + b0_i) @ W1_i + b1_i
//   out   = relu(x) @ W_out + b_out                   (f32)
// Every matmul operand is bf16 (the relu'd activation cast to bf16), every
// accumulation f32, as the TPU kernel's `_dot`.
//
// Bound on the H100: operations. A point at NS=2 costs ~11.6 MFLOP of
// bf16 products (512-wide, 5 blocks, 3 injections) against ~100 bytes of
// input, far above the ~295 FLOP/byte ridge, so the least time is
// FLOP / 989 TFLOP/s.
//
// Design, simple first: one CTA of 8 warps per (scene, tile of TB points
// x NS views), TB = max(1, 32 / NS), so a tile holds NS * TB <= 32 rows
// for NS <= 32 (more rows, one point, beyond), view-major, padded with
// zero rows to a multiple of 16 for the wmma row tiles. The gathered z
// tile (bf16), the f32 residual stream, and two bf16 operand buffers live
// in dynamic shared memory (~168 KB for 32 rows at the flagship width,
// which caps NS at 32 there); the TPU kernel's one-hot gather matrices are
// gone: each thread loads its channel pair of every tap directly, the
// loads of a warp coalesced over C. Weights (one head ~6.8 MB bf16) are
// not resident as on the TPU: they stream from L2 as wmma B fragments,
// each warp owning 4 of the 32 16-wide output column strips of a product.
// Injections are computed per block rather than packed into one product.
// A later change moves the products to wgmma with TMA-fed rings.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define MAX_LEVELS 4
#define WARPS 8
#define THREADS (WARPS * 32)
#define TILE_ROWS 32  // NS * TB rows of one CTA before the view pooling
#define NFW 4    // 16-wide column strips per warp per pass

struct FieldParams {
  const bf16* feats[MAX_LEVELS];
  int lh[MAX_LEVELS], lw[MAX_LEVELS], lc[MAX_LEVELS], lc0[MAX_LEVELS];
  int nlev;
  const float* grid;  // (SB, NS, B, 2) normalized fine-grid coords
  const bf16* xin;    // (SB, NS, B, d_in)
  const bf16* w_in;   // (d_in_pad, H), rows past d_in zero
  const float* b_in;  // (H)
  const bf16* wz;     // (n_inj, DL, H)
  const float* bz;    // (n_inj, H)
  const bf16* w0;     // (n_blocks, H, H)
  const float* b0;    // (n_blocks, H)
  const bf16* w1;
  const float* b1;
  const bf16* w_out;  // (H, d_out)
  const float* b_out; // (d_out)
  float* out;         // (SB, B, d_out)
  int ns, b, tb, rows_pad, d_in, d_in_pad, hidden, d_latent, d_out,
      n_blocks, combine_layer;
};

enum { EPI_STORE_X = 0, EPI_ADD_X = 1, EPI_RELU_BF16 = 2 };

// Composed taps on one native axis of size wn for a fine coordinate cf in
// [0, wf-1]: weights of native indices base, base+1, base+2. Coincident
// taps add (pyramid_pallas.py:_axis_pairs).
__device__ __forceinline__ void axis_taps(float cf, int wn, int wf, int* base,
                                          float w[3]) {
  w[0] = w[1] = w[2] = 0.f;
  if (wn == wf) {
    float j = floorf(cf);
    float t = cf - j;
    *base = (int)j;
    w[0] = 1.f - t;
    w[1] = t;
    return;
  }
  float r = (wn - 1.0f) / (wf - 1.0f);
  float j = fminf(floorf(cf), wf - 2.0f);
  float t = cf - j;
  float xl = j * r;
  float xr = (j + 1.0f) * r;
  float ilf = floorf(xl);
  float irf = fminf(floorf(xr), wn - 1.0f);
  float fl = xl - ilf;
  float fr = xr - irf;
  int il = (int)ilf;
  int d = (int)irf - il;  // 0 or 1: r <= 1
  *base = il;
  w[0] += (1.f - t) * (1.f - fl);
  w[1] += (1.f - t) * fl;
  w[d] += t * (1.f - fr);
  w[d + 1] += t * fr;
}

// C (16*mtiles x ncols) from A (16*mtiles x K, bf16, smem) @ W (K x ncols,
// bf16, global, row-major), two 16-row tiles at a time, with the epilogue
// applied through a per-warp 16x16 staging tile:
//   EPI_STORE_X:   X = acc + bias
//   EPI_ADD_X:     X += acc + bias
//   EPI_RELU_BF16: Hb = bf16(relu(acc + bias))
__device__ void tile_gemm(const bf16* A, int lda, int K, int mtiles,
                          const bf16* W, int ldw, int ncols,
                          const float* bias, int epi, float* X, int ldx,
                          bf16* Hb, int ldh, float* stage) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nfrag = ncols / 16;
  for (int nf0 = warp * NFW; nf0 < nfrag; nf0 += WARPS * NFW)
  for (int m0 = 0; m0 < mtiles; m0 += 2) {
    const int mt = mtiles - m0 < 2 ? mtiles - m0 : 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NFW];
#pragma unroll
    for (int m = 0; m < 2; m++)
#pragma unroll
      for (int j = 0; j < NFW; j++) wmma::fill_fragment(acc[m][j], 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int m = 0; m < 2; m++)
        if (m < mt) wmma::load_matrix_sync(a[m], A + (m0 + m) * 16 * lda + k, lda);
#pragma unroll
      for (int j = 0; j < NFW; j++) {
        if (nf0 + j < nfrag) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, W + (size_t)k * ldw + (nf0 + j) * 16, ldw);
#pragma unroll
          for (int m = 0; m < 2; m++)
            if (m < mt) wmma::mma_sync(acc[m][j], a[m], bf, acc[m][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NFW; j++) {
      if (nf0 + j >= nfrag) continue;
#pragma unroll
      for (int m = 0; m < 2; m++) {
        if (m >= mt) continue;
        wmma::store_matrix_sync(stage, acc[m][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = (m0 + m) * 16 + e / 16, c = (nf0 + j) * 16 + e % 16;
          const float v = stage[e] + bias[c];
          if (epi == EPI_STORE_X) {
            X[r * ldx + c] = v;
          } else if (epi == EPI_ADD_X) {
            X[r * ldx + c] += v;
          } else {
            Hb[r * ldh + c] = __float2bfloat16(fmaxf(v, 0.f));
          }
        }
        __syncwarp();
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) field_fwd_kernel(FieldParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.hidden, DL = p.d_latent;
  const int KA = H > p.d_in_pad ? H : p.d_in_pad;
  const int RP = p.rows_pad;
  float* X = reinterpret_cast<float*>(smem);      // RP x H f32
  bf16* Z = reinterpret_cast<bf16*>(X + RP * H);   // RP x DL
  bf16* A = Z + RP * DL;                           // RP x KA
  bf16* Hb = A + RP * KA;                          // RP x H
  float* stage = reinterpret_cast<float*>(Hb + RP * H) + (threadIdx.x / 32) * 256;

  const int s = blockIdx.y;
  const int ns = p.ns, tb = p.tb, B = p.b;
  const int p0 = blockIdx.x * tb;
  const int rows = ns * tb;
  const int hf = p.lh[0], wf = p.lw[0];

  // 1. gather the latent tile, rows view-major (row = v * tb + point);
  // rows past the last point or past ns * tb are zero
  for (int r = 0; r < RP; r++) {
    const int v = r / tb, pt = p0 + r % tb;
    if (r >= rows || pt >= B) {
      for (int c = threadIdx.x; c < DL; c += THREADS) Z[r * DL + c] = __float2bfloat16(0.f);
      continue;
    }
    const float* g = p.grid + (((size_t)s * ns + v) * B + pt) * 2;
    const float fx = fminf(fmaxf((g[0] + 1.f) * 0.5f * (float)(wf - 1), 0.f), (float)(wf - 1));
    const float fy = fminf(fmaxf((g[1] + 1.f) * 0.5f * (float)(hf - 1), 0.f), (float)(hf - 1));
    for (int c = 2 * threadIdx.x; c < DL; c += 2 * THREADS) {
      int l = 0;
      while (l + 1 < p.nlev && c >= p.lc0[l + 1]) l++;
      const int hn = p.lh[l], wn = p.lw[l], C = p.lc[l];
      int bx, by;
      float wx[3], wy[3];
      axis_taps(fx, wn, wf, &bx, wx);
      axis_taps(fy, hn, hf, &by, wy);
      const bf16* f = p.feats[l] + ((size_t)(s * ns + v) * hn * wn) * C + (c - p.lc0[l]);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int ty = 0; ty < 3; ty++) {
        const int iy = by + ty;
        if (iy >= hn) continue;
#pragma unroll
        for (int tx = 0; tx < 3; tx++) {
          const int ix = bx + tx;
          if (ix >= wn) continue;
          const float w = wy[ty] * wx[tx];
          const __nv_bfloat162 val =
              *reinterpret_cast<const __nv_bfloat162*>(f + ((size_t)iy * wn + ix) * C);
          const float2 vf = __bfloat1622float2(val);
          a0 += w * vf.x;
          a1 += w * vf.y;
        }
      }
      Z[r * DL + c] = __float2bfloat16(a0);
      Z[r * DL + c + 1] = __float2bfloat16(a1);
    }
  }
  // positional-code rows, zero past d_in, past the last point and past
  // ns * tb
  for (int e = threadIdx.x; e < RP * p.d_in_pad; e += THREADS) {
    const int r = e / p.d_in_pad, k = e % p.d_in_pad;
    const int v = r / tb, pt = p0 + r % tb;
    bf16 val = __float2bfloat16(0.f);
    if (k < p.d_in && r < rows && pt < B)
      val = p.xin[(((size_t)s * ns + v) * B + pt) * p.d_in + k];
    A[r * KA + k] = val;
  }
  __syncthreads();

  // 2. x = xin @ W_in + b_in
  tile_gemm(A, KA, p.d_in_pad, RP / 16, p.w_in, H, H, p.b_in, EPI_STORE_X,
            X, H, Hb, H, stage);
  __syncthreads();

  // 3. residual blocks; after the pooling the first tb rows (padded to a
  // multiple of 16) carry the points
  const int n_inj = p.combine_layer < p.n_blocks ? p.combine_layer : p.n_blocks;
  int cur = RP;
  for (int blk = 0; blk < p.n_blocks; blk++) {
    if (blk == p.combine_layer && ns > 1) {
      for (int e = threadIdx.x; e < tb * H; e += THREADS) {
        const int pt = e / H, c = e % H;
        float sum = 0.f;
        for (int v = 0; v < ns; v++) sum += X[(v * tb + pt) * H + c];
        X[pt * H + c] = sum / (float)ns;
      }
      cur = (tb + 15) / 16 * 16;
      __syncthreads();
    }
    if (blk < n_inj) {
      tile_gemm(Z, DL, DL, cur / 16, p.wz + (size_t)blk * DL * H, H, H,
                p.bz + (size_t)blk * H, EPI_ADD_X, X, H, Hb, H, stage);
      __syncthreads();
    }
    for (int e = threadIdx.x; e < cur * H; e += THREADS) {
      const int r = e / H, c = e % H;
      A[r * KA + c] = __float2bfloat16(fmaxf(X[r * H + c], 0.f));
    }
    __syncthreads();
    tile_gemm(A, KA, H, cur / 16, p.w0 + (size_t)blk * H * H, H, H,
              p.b0 + (size_t)blk * H, EPI_RELU_BF16, X, H, Hb, H, stage);
    __syncthreads();
    tile_gemm(Hb, H, H, cur / 16, p.w1 + (size_t)blk * H * H, H, H,
              p.b1 + (size_t)blk * H, EPI_ADD_X, X, H, Hb, H, stage);
    __syncthreads();
  }

  // 4. out = relu(x) @ W_out + b_out for the tile's tb points (d_out is
  // 4: plain FMA; ns == 1 leaves rows == tb)
  for (int e = threadIdx.x; e < tb * H; e += THREADS) {
    const int r = e / H, c = e % H;
    A[r * KA + c] = __float2bfloat16(fmaxf(X[r * H + c], 0.f));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < tb * p.d_out; e += THREADS) {
    const int r = e / p.d_out, o = e % p.d_out;
    const int pt = p0 + r;
    if (pt >= B) continue;
    float acc = 0.f;
    for (int k = 0; k < H; k++)
      acc += __bfloat162float(A[r * KA + k]) * __bfloat162float(p.w_out[k * p.d_out + o]);
    p.out[((size_t)s * B + pt) * p.d_out + o] = acc + p.b_out[o];
  }
}

static int tile_points(int ns) { return ns < TILE_ROWS ? TILE_ROWS / ns : 1; }

static int tile_rows_padded(int ns) { return (ns * tile_points(ns) + 15) / 16 * 16; }

extern "C" {

size_t pnt_field_fwd_smem_bytes(int hidden, int d_latent, int d_in_pad, int ns) {
  const int ka = hidden > d_in_pad ? hidden : d_in_pad;
  const size_t rp = tile_rows_padded(ns);
  return rp * hidden * 4 + rp * d_latent * 2 + rp * ka * 2 + rp * hidden * 2 +
         (size_t)WARPS * 256 * 4;
}

const char* pnt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the kernel on `stream`; returns cudaGetLastError().
int pnt_field_fwd(const void* const* feats, const int* dims, int nlev,
                  const void* grid, const void* xin, const void* w_in,
                  const void* b_in, const void* wz, const void* bz,
                  const void* w0, const void* b0, const void* w1,
                  const void* b1, const void* w_out, const void* b_out,
                  void* out, int sb, int ns, int b, int d_in, int d_in_pad,
                  int hidden, int d_out, int n_blocks, int combine_layer,
                  void* stream) {
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
  p.xin = static_cast<const bf16*>(xin);
  p.w_in = static_cast<const bf16*>(w_in);
  p.b_in = static_cast<const float*>(b_in);
  p.wz = static_cast<const bf16*>(wz);
  p.bz = static_cast<const float*>(bz);
  p.w0 = static_cast<const bf16*>(w0);
  p.b0 = static_cast<const float*>(b0);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w_out = static_cast<const bf16*>(w_out);
  p.b_out = static_cast<const float*>(b_out);
  p.out = static_cast<float*>(out);
  p.ns = ns;
  p.b = b;
  p.tb = tile_points(ns);
  p.rows_pad = tile_rows_padded(ns);
  p.d_in = d_in;
  p.d_in_pad = d_in_pad;
  p.hidden = hidden;
  p.d_latent = c0;
  p.d_out = d_out;
  p.n_blocks = n_blocks;
  p.combine_layer = combine_layer;

  const size_t smem = pnt_field_fwd_smem_bytes(hidden, c0, d_in_pad, ns);
  cudaError_t err = cudaFuncSetAttribute(
      field_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_dim((b + p.tb - 1) / p.tb, sb);
  field_fwd_kernel<<<grid_dim, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
