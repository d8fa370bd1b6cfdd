// The ResnetFC forward block chain of one point tile, shared by the field
// kernel (field_fwd.cu, which gathers z from the pyramid) and the ResnetFC
// kernel (resnetfc_fwd.cu, which loads z), with the optional bf16 stash
// of the VJP forward.
//
// A tile is one CTA of 8 warps over (scene s, TB = max(1, 32/NS) points
// x NS views), rows view-major (row = v * TB + point), zero rows padding
// to a multiple of 16 for the wmma row tiles. Per point:
//   x     = xin_v @ W_in + b_in                       (f32 residual stream)
//   block i: [mean over views at i == combine_layer, NS > 1]
//            x += z_v @ Wz_i + bz_i                  (i < n_inj)
//            x += relu(relu(x) @ W0_i + b0_i) @ W1_i + b1_i
//   out   = relu(x) @ W_out + b_out                   (f32)
// with every matmul operand bf16 and every sum f32 (the TPU kernels'
// `_dot`). The stash holds exactly the bf16 operands the products consumed,
// in the port's own layout (not the TPU tile order):
//   stash_pre  (2k, SB, NS, B, H)  blocks before the pooling (NS > 1):
//              [relu(block_in) for i < k | relu(h1) for i < k]
//   stash_post (2m+1, SB, B, H)    the m = n_blocks - k blocks after it:
//              [relu(block_in) | relu(h1) | relu(x_final)]
// Weights stream from L2 as wmma B fragments (tile_common.cuh:tile_mm).
#pragma once

#include "tile_common.cuh"

struct ChainParams {
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
  bf16* spre;         // (2k, SB, NS, B, H) or null
  bf16* spost;        // (2m+1, SB, B, H) or null: no stash
  int sb, ns, b, tb, rows_pad, d_in, d_in_pad, hidden, d_latent, d_out,
      n_blocks, combine_layer, k;
};

// The tile's dynamic shared memory: the f32 residual stream X, the bf16 z
// tile Z, two bf16 operand buffers A (KA wide) and Hb, and one 16x16 f32
// staging tile per warp.
struct FwdSmem {
  float* X;
  bf16* Z;
  bf16* A;
  bf16* Hb;
  float* stage;
  int KA;
};

__device__ __forceinline__ FwdSmem fwd_smem(unsigned char* smem, const ChainParams& p) {
  FwdSmem m;
  const int H = p.hidden, RP = p.rows_pad;
  m.KA = H > p.d_in_pad ? H : p.d_in_pad;
  m.X = reinterpret_cast<float*>(smem);
  m.Z = reinterpret_cast<bf16*>(m.X + RP * H);
  m.A = m.Z + RP * p.d_latent;
  m.Hb = m.A + RP * m.KA;
  m.stage = reinterpret_cast<float*>(m.Hb + RP * H) + (threadIdx.x / 32) * 256;
  return m;
}

static inline size_t fwd_smem_bytes(int hidden, int d_latent, int d_in_pad, int ns) {
  const int ka = hidden > d_in_pad ? hidden : d_in_pad;
  const size_t rp = tile_rows_padded(ns);
  return rp * hidden * 4 + rp * d_latent * 2 + rp * ka * 2 + rp * hidden * 2 +
         (size_t)WARPS * 256 * 4;
}

static inline ChainParams chain_params(const void* xin, const void* w_in, const void* b_in,
                                       const void* wz, const void* bz, const void* w0,
                                       const void* b0, const void* w1, const void* b1,
                                       const void* w_out, const void* b_out, void* out,
                                       void* spre, void* spost, int sb, int ns, int b,
                                       int d_latent, int d_in, int d_in_pad, int hidden,
                                       int d_out, int n_blocks, int combine_layer) {
  ChainParams p;
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
  p.spre = static_cast<bf16*>(spre);
  p.spost = static_cast<bf16*>(spost);
  p.sb = sb;
  p.ns = ns;
  p.b = b;
  p.tb = tile_points(ns);
  p.rows_pad = tile_rows_padded(ns);
  p.d_in = d_in;
  p.d_in_pad = d_in_pad;
  p.hidden = hidden;
  p.d_latent = d_latent;
  p.d_out = d_out;
  p.n_blocks = n_blocks;
  p.combine_layer = combine_layer;
  p.k = ns > 1 ? (combine_layer < n_blocks ? combine_layer : n_blocks) : 0;
  return p;
}

// copy the tile's rows (stride ld) of `width` bf16 values to their rows of
// `dst`, 16 bytes a thread: pre-pool rows r = v * tb + pt go to row
// (s, v, p0 + pt) of an (SB, NS, B, width) array, post-pool rows r = pt to
// row (s, p0 + pt) of an (SB, B, width) one; rows of points past B are
// skipped
__device__ void write_rows(const ChainParams& p, const bf16* tile, int ld, int width, bool pre,
                           bf16* dst, int s, int p0) {
  const int tb = p.tb;
  const int nrows = pre ? p.ns * tb : tb;
  const int chunks = width / 8;
  for (int e = threadIdx.x; e < nrows * chunks; e += THREADS) {
    const int r = e / chunks, c8 = (e % chunks) * 8;
    const int v = pre ? r / tb : 0, pt = pre ? r % tb : r;
    if (p0 + pt >= p.b) continue;
    const size_t row = pre ? ((size_t)s * p.ns + v) * p.b + p0 + pt : (size_t)s * p.b + p0 + pt;
    *reinterpret_cast<uint4*>(dst + row * width + c8) =
        *reinterpret_cast<const uint4*>(tile + r * ld + c8);
  }
}

// stash slot `slot` of the pre- or post-pool stash
__device__ __forceinline__ void write_stash(const ChainParams& p, const bf16* tile, int ld,
                                            bool pre, int slot, int s, int p0) {
  const size_t rows = (size_t)p.sb * (pre ? p.ns : 1) * p.b;
  write_rows(p, tile, ld, p.hidden, pre, (pre ? p.spre : p.spost) + slot * rows * p.hidden, s,
             p0);
}

// the positional-code rows into A, zero past d_in, past the last point and
// past ns * tb
__device__ void load_xin(const ChainParams& p, const FwdSmem& m, int s, int p0) {
  const int tb = p.tb, rows = p.ns * tb;
  for (int e = threadIdx.x; e < p.rows_pad * p.d_in_pad; e += THREADS) {
    const int r = e / p.d_in_pad, kk = e % p.d_in_pad;
    const int v = r / tb, pt = p0 + r % tb;
    bf16 val = __float2bfloat16(0.f);
    if (kk < p.d_in && r < rows && pt < p.b)
      val = p.xin[(((size_t)s * p.ns + v) * p.b + pt) * p.d_in + kk];
    m.A[r * m.KA + kk] = val;
  }
}

// the chain from the loaded Z and xin (in A) tiles to the output rows;
// starts after a __syncthreads that follows the loads
__device__ void forward_chain(const ChainParams& p, const FwdSmem& m, int s, int p0) {
  const int H = p.hidden, DL = p.d_latent, KA = m.KA;
  const int ns = p.ns, tb = p.tb, B = p.b;
  const bool stash = p.spost != nullptr;
  const int k = p.k, mm = p.n_blocks - p.k;
  float* X = m.X;
  bf16 *A = m.A, *Hb = m.Hb;

  // x = xin @ W_in + b_in
  tile_mm<false>(A, KA, p.d_in_pad, p.rows_pad / 16, p.w_in, H, H, m.stage,
                 [&](int r, int c, float v) { X[r * H + c] = v + p.b_in[c]; });
  __syncthreads();

  // residual blocks; after the pooling the first tb rows (padded to a
  // multiple of 16) carry the points
  const int n_inj = p.combine_layer < p.n_blocks ? p.combine_layer : p.n_blocks;
  int cur = p.rows_pad;
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
      const float* bz = p.bz + (size_t)blk * H;
      tile_mm<false>(m.Z, DL, DL, cur / 16, p.wz + (size_t)blk * DL * H, H, H, m.stage,
                     [&](int r, int c, float v) { X[r * H + c] += v + bz[c]; });
      __syncthreads();
    }
    for (int e = threadIdx.x; e < cur * H; e += THREADS) {
      const int r = e / H, c = e % H;
      A[r * KA + c] = __float2bfloat16(fmaxf(X[r * H + c], 0.f));
    }
    __syncthreads();
    const bool pre = blk < k;
    if (stash) write_stash(p, A, KA, pre, pre ? blk : blk - k, s, p0);
    const float* b0 = p.b0 + (size_t)blk * H;
    tile_mm<false>(A, KA, H, cur / 16, p.w0 + (size_t)blk * H * H, H, H, m.stage,
                   [&](int r, int c, float v) {
                     Hb[r * H + c] = __float2bfloat16(fmaxf(v + b0[c], 0.f));
                   });
    __syncthreads();
    if (stash) write_stash(p, Hb, H, pre, pre ? k + blk : mm + blk - k, s, p0);
    const float* b1 = p.b1 + (size_t)blk * H;
    tile_mm<false>(Hb, H, H, cur / 16, p.w1 + (size_t)blk * H * H, H, H, m.stage,
                   [&](int r, int c, float v) { X[r * H + c] += v + b1[c]; });
    __syncthreads();
  }

  // out = relu(x) @ W_out + b_out for the tile's tb points (d_out is 4:
  // plain FMA; ns == 1 leaves rows == tb)
  for (int e = threadIdx.x; e < tb * H; e += THREADS) {
    const int r = e / H, c = e % H;
    A[r * KA + c] = __float2bfloat16(fmaxf(X[r * H + c], 0.f));
  }
  __syncthreads();
  if (stash) write_stash(p, A, KA, false, 2 * mm, s, p0);
  for (int e = threadIdx.x; e < tb * p.d_out; e += THREADS) {
    const int r = e / p.d_out, o = e % p.d_out;
    const int pt = p0 + r;
    if (pt >= B) continue;
    float acc = 0.f;
    for (int kk = 0; kk < H; kk++)
      acc += __bfloat162float(A[r * KA + kk]) * __bfloat162float(p.w_out[kk * p.d_out + o]);
    p.out[((size_t)s * B + pt) * p.d_out + o] = acc + p.b_out[o];
  }
}
