// ResnetFC forward on a (z, x) pair, with an optional bf16 stash.
//
// Replaces the TPU kernels pixelnerf_tpu/ops/resnetfc_pallas.py:
// `_fwd_kernel` (the primal, `_fused_fwd_impl`) when the stash pointers
// are null, and `_fwd_stash_kernel` (`_fused_fwd_stash_impl`, the forward
// of the custom VJP) when they are given.
//
// What it computes, per scene s and point p, for NS views:
//   x     = xin_v @ W_in + b_in                       (f32 residual stream)
//   block i: [mean over views at i == combine_layer, NS > 1]
//            x += z_v @ Wz_i + bz_i                  (i < n_inj)
//            x += relu(relu(x) @ W0_i + b0_i) @ W1_i + b1_i
//   out   = relu(x) @ W_out + b_out                   (f32)
// with every matmul operand bf16 and every sum f32 (`_dot`). The stash
// holds exactly the bf16 operands the products consumed: relu(x) at each
// block's input, relu(h1) inside it, and relu(x_final). Its layout is the
// port's own, not the TPU tile order:
//   stash_pre  (2k, SB, NS, B, H)  blocks before the pooling (NS > 1):
//              [relu(block_in) for i < k | relu(h1) for i < k]
//   stash_post (2m+1, SB, B, H)    the m = n_blocks - k blocks after it:
//              [relu(block_in) | relu(h1) | relu(x_final)]
//
// Bound on the H100: operations (as field_fwd.cu: ~11.6 MFLOP of bf16
// products a point at the flagship width and NS=2, against ~1 KB of z);
// with the stash it also writes ~17 KB a point, ~1/20 of the time the
// products need at the bf16 peak.
//
// Design: field_fwd.cu's block chain (tile_common.cuh) with the gather
// replaced by a load of the bf16 z tile. One CTA of 8 warps per (scene,
// tile of TB = max(1, 32/NS) points x NS views), rows view-major, zero
// rows padding to a multiple of 16; weights stream from L2 as wmma B
// fragments. The stash rows are written from the same shared-memory
// operand tiles the products read, 16 bytes a thread.

#include "tile_common.cuh"

struct MlpParams {
  const bf16* z;      // (SB, NS, B, DL)
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
  bf16* spost;        // (2m+1, SB, B, H) or null
  int sb, ns, b, tb, rows_pad, d_in, d_in_pad, hidden, d_latent, d_out,
      n_blocks, combine_layer, k;
};

// copy `nrows` tile rows (stride ld) of H bf16 values to their stash rows:
// pre-pool rows r = v * tb + pt go to (slot, s, v, p0 + pt); post-pool rows
// r = pt to (slot, s, p0 + pt); rows of points past B are skipped
__device__ void write_stash(const MlpParams& p, const bf16* tile, int ld, bool pre,
                            int slot, int s, int p0) {
  const int H = p.hidden, tb = p.tb;
  const int nrows = pre ? p.ns * tb : tb;
  const int chunks = H / 8;
  for (int e = threadIdx.x; e < nrows * chunks; e += THREADS) {
    const int r = e / chunks, c8 = (e % chunks) * 8;
    const int v = pre ? r / tb : 0, pt = pre ? r % tb : r;
    if (p0 + pt >= p.b) continue;
    size_t row;
    if (pre)
      row = (((size_t)slot * p.sb + s) * p.ns + v) * p.b + p0 + pt;
    else
      row = ((size_t)slot * p.sb + s) * p.b + p0 + pt;
    bf16* dst = (pre ? p.spre : p.spost) + row * H + c8;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tile + r * ld + c8);
  }
}

__global__ void __launch_bounds__(THREADS, 1) resnetfc_fwd_kernel(MlpParams p) {
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
  const bool stash = p.spost != nullptr;
  const int k = p.k, m = p.n_blocks - p.k;

  // 1. the z and positional-code tiles, rows view-major (row = v * tb +
  // point); rows past the last point or past ns * tb are zero
  for (int e = threadIdx.x; e < RP * (DL / 2); e += THREADS) {
    const int r = e / (DL / 2), c = (e % (DL / 2)) * 2;
    const int v = r / tb, pt = p0 + r % tb;
    __nv_bfloat162 val = __floats2bfloat162_rn(0.f, 0.f);
    if (r < rows && pt < B)
      val = *reinterpret_cast<const __nv_bfloat162*>(
          p.z + (((size_t)s * ns + v) * B + pt) * DL + c);
    *reinterpret_cast<__nv_bfloat162*>(Z + r * DL + c) = val;
  }
  for (int e = threadIdx.x; e < RP * p.d_in_pad; e += THREADS) {
    const int r = e / p.d_in_pad, kk = e % p.d_in_pad;
    const int v = r / tb, pt = p0 + r % tb;
    bf16 val = __float2bfloat16(0.f);
    if (kk < p.d_in && r < rows && pt < B)
      val = p.xin[(((size_t)s * ns + v) * B + pt) * p.d_in + kk];
    A[r * KA + kk] = val;
  }
  __syncthreads();

  // 2. x = xin @ W_in + b_in
  tile_mm<false>(A, KA, p.d_in_pad, RP / 16, p.w_in, H, H, stage,
                 [&](int r, int c, float v) { X[r * H + c] = v + p.b_in[c]; });
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
      const float* bz = p.bz + (size_t)blk * H;
      tile_mm<false>(Z, DL, DL, cur / 16, p.wz + (size_t)blk * DL * H, H, H, stage,
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
    tile_mm<false>(A, KA, H, cur / 16, p.w0 + (size_t)blk * H * H, H, H, stage,
                   [&](int r, int c, float v) {
                     Hb[r * H + c] = __float2bfloat16(fmaxf(v + b0[c], 0.f));
                   });
    __syncthreads();
    if (stash) write_stash(p, Hb, H, pre, pre ? k + blk : m + blk - k, s, p0);
    const float* b1 = p.b1 + (size_t)blk * H;
    tile_mm<false>(Hb, H, H, cur / 16, p.w1 + (size_t)blk * H * H, H, H, stage,
                   [&](int r, int c, float v) { X[r * H + c] += v + b1[c]; });
    __syncthreads();
  }

  // 4. out = relu(x) @ W_out + b_out for the tile's tb points (d_out is
  // 4: plain FMA)
  for (int e = threadIdx.x; e < tb * H; e += THREADS) {
    const int r = e / H, c = e % H;
    A[r * KA + c] = __float2bfloat16(fmaxf(X[r * H + c], 0.f));
  }
  __syncthreads();
  if (stash) write_stash(p, A, KA, false, 2 * m, s, p0);
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

extern "C" {

size_t pnt_resnetfc_fwd_smem_bytes(int hidden, int d_latent, int d_in_pad, int ns) {
  const int ka = hidden > d_in_pad ? hidden : d_in_pad;
  const size_t rp = tile_rows_padded(ns);
  return rp * hidden * 4 + rp * d_latent * 2 + rp * ka * 2 + rp * hidden * 2 +
         (size_t)WARPS * 256 * 4;
}

// Launches the kernel on `stream` (stash written when spost is not null);
// returns cudaGetLastError().
int pnt_resnetfc_fwd(const void* z, const void* xin, const void* w_in,
                     const void* b_in, const void* wz, const void* bz,
                     const void* w0, const void* b0, const void* w1,
                     const void* b1, const void* w_out, const void* b_out,
                     void* out, void* spre, void* spost, int sb, int ns, int b,
                     int d_latent, int d_in, int d_in_pad, int hidden,
                     int d_out, int n_blocks, int combine_layer, void* stream) {
  MlpParams p;
  p.z = static_cast<const bf16*>(z);
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

  const size_t smem = pnt_resnetfc_fwd_smem_bytes(hidden, d_latent, d_in_pad, ns);
  cudaError_t err = cudaFuncSetAttribute(
      resnetfc_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_dim((b + p.tb - 1) / p.tb, sb);
  resnetfc_fwd_kernel<<<grid_dim, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
