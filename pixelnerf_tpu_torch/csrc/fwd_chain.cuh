// The ResnetFC forward block chain of one point tile on Hopper, shared by
// the field kernel (field_fwd.cu, which gathers z from the pyramid) and the
// ResnetFC kernel (resnetfc_fwd.cu, which loads z), with the optional bf16
// stash of the VJP forward. Replaces the MLP of the TPU kernels
// resnetfc_pallas.py `_forward_body` (used by `_fwd_kernel`,
// `_fwd_stash_kernel` and field_pallas.py `_field_fwd_kernel`).
//
// A tile is one CTA over (scene s, P = max(1, 64/NS) points x NS views),
// rows view-major (row = v * P + point) in one 64-row wgmma tile. Per point:
//   x     = xin_v @ W_in + b_in                       (f32 residual stream)
//   block i: [mean over views at i == combine_layer, NS > 1]
//            x += z_v @ Wz_i + bz_i                  (i < n_inj)
//            x += relu(relu(x) @ W0_i + b0_i) @ W1_i + b1_i
//   out   = relu(x) @ W_out + b_out                   (f32)
// with every matmul operand bf16 and every sum f32 (the TPU kernels'
// `_dot`); after the pooling the P points sit in the tile's first rows and
// the other rows idle. The stash holds exactly the bf16 operands the
// products consumed, in the port's own layout (not the TPU tile order):
//   stash_pre  (2k, SB, NS, B, H)  blocks before the pooling (NS > 1):
//              [relu(block_in) for i < k | relu(h1) for i < k]
//   stash_post (2m+1, SB, B, H)    the m = n_blocks - k blocks after it:
//              [relu(block_in) | relu(h1) | relu(x_final)]
//
// Bound on the H100: operations. At the flagship width (hidden 512,
// d_latent 512, d_in 42 padded to 48, 5 blocks, 3 injections, NS=2) a point
// costs ~11.6 MFLOP of bf16 products against ~2 KB of inputs and outputs,
// or ~17 KB with the stash, far above the ~295 FLOP/byte ridge: the least
// time is FLOP / 989 TFLOP/s. What binds in practice is each SM's own
// weight stream: every CTA reads a head's ~6.9 MB of bf16 weights from L2
// (64 rows a CTA: 64 FLOP per L2 byte) through its 64 KB ring, ~70 GB/s an
// SM, whether 33 CTAs run or 132. A tile at NS=2 takes ~110 us, ~105 of
// them with the products taken out and the stream left in, against ~59 us
// of tensor work at the bf16 peak (PERF.md §6). The epilogues, the pooling
// and the output layer, which once took ~45% of a tile, now hide under
// the stream.
//
// Design. 384 threads: two consumer warpgroups and one producer warpgroup
// (setmaxnreg gives the consumers 232 registers, the producer 40).
// - The residual stream x lives in registers as the wgmma f32
//   accumulators: warpgroup w owns x's columns [w*H/2, (w+1)*H/2) of all
//   64 rows (128 registers a thread at H = 512); the injections and
//   h @ W1 accumulate onto it in place.
// - One producer thread streams every weight tile of the chain, in the
//   order the consumers use them, one TMA box a stage (tensor maps over
//   the unchanged row-major (K, N) weights, 128-byte swizzle, 64-byte at
//   H = 64; kept in L2 with evict-last) into a ring of 4 16-KB stages with
//   full/empty mbarriers. The products read them from shared memory as
//   wgmma's transposed (MN-major) B.
// - The A operands are bf16 tiles in shared memory, K-major with the
//   128-byte swizzle, written by the consumer threads (generic stores,
//   then fence.proxy.async): the xin tile, the z tile (resident across the
//   injections), relu(x) (64 x H), and h in chunks of min(H, 256) columns
//   into one buffer: each warpgroup computes half a chunk,
//   h = relu(relu(x) @ W0[:, chunk] + b0) (wgmma n128, or n64 / n32 at
//   hidden 128 / 64), writes it, and
//   both then add chunk @ W1[chunk, :] to their x columns. Relu'd tiles
//   are written with stmatrix (the accumulator fragment is its layout).
// - Schedule: a ring stage's products are one wgmma group, left in flight
//   while the next stage's are issued, the stage freed one behind. The
//   tensor pipe is drained only where an epilogue reads an accumulator:
//   after the input layer, each injection band, each W0 chunk and each
//   block's last W1 chunk; a block's other W1 chunks run on into the next
//   W0 chunk, which reads only relu(x) (fwd_schedule counts 19 drains of a
//   tile's 419 stages at the flagship). Each accumulator takes its
//   products in the same k-order, so the output is bit for bit what a
//   drain after every stage gives.
// - Stash rows are copied from the same shared-memory operand tiles (16
//   bytes a thread, rows past B skipped) by three copier warps of the
//   producer warpgroup, handed each tile through mbarriers, while the
//   tensor cores run the products that read it. (TMA stores would need
//   each view's rows to start on a 1024-byte swizzle atom, which P = 21 or
//   12 rows break.)
// Shared memory at H = d_latent = 512: ring 64 KB, relu(x) 64 KB, z 64 KB,
// h 32 KB (225 KB). The view pooling goes through the relu(x) and z tiles
// as f32 scratch (pool_offset: swizzled to the fewest wavefronts),
// and the output layer keeps W_out in the z tile (z is dead after the last
// injection).
// - A latent wider than the z tile fits (d_latent 640 or 1024 at H = 512:
//   a global latent, or five encoder levels) runs each injection's z @ Wz_i
//   in column bands of the tile's width (`zw`, fwd_z_cols), summed into the
//   same accumulators: the consumers reload the band (the gather again, for
//   the field) before its product, and the z-stash copies each band of the
//   first injection. Where the whole latent fits (the flagship's widths)
//   there is one band, loaded once, and no reload.
#pragma once

#include <type_traits>

#include "sm90.cuh"
#include "tile_common.cuh"

#define FWD_ROWS 64         // rows of one tile: one wgmma M
#define FWD_CONSUMERS 256   // two consumer warpgroups
#define FWD_THREADS 384     // and one producer warpgroup: the TMA thread's
#define FWD_COPIERS 96      // warp and three warps that copy the stash
#define FWD_STAGES 4
#define FWD_STAGE_BYTES 16384

struct ChainParams {
  const bf16* xin;    // (SB, NS, B, d_in)
  const float* b_in;  // (H)
  const float* bz;    // (n_inj, H)
  const float* b0;    // (n_blocks, H)
  const float* b1;
  const bf16* w_out;  // (H, d_out)
  const float* b_out; // (d_out)
  float* out;         // (SB, B, d_out)
  bf16* spre;         // (2k, SB, NS, B, H) or null
  bf16* spost;        // (2m+1, SB, B, H) or null: no stash
  bf16* zstash;       // (SB, NS, B, DL) or null: the z tile's rows
  int sb, ns, b, pts, d_in, d_in_pad, d_latent, d_out, n_blocks, combine_layer, k, n_inj;
  int zw;             // latent columns of the z tile: a band (fwd_z_cols)
};

// TMA maps over w_in (d_in_pad, H), wz (n_inj * DL, H), w0 and w1
// (n_blocks * H, H) in column blocks of the swizzle's width (sm90.cuh:
// weight_map); a box is 16 rows of every block (w0: 64 rows of two)
struct ChainMaps {
  CUtensorMap w_in, wz, w0, w1;
};

// Widths the chain is built for (`hidden`, at compile time).
template <int H>
struct ChainShape {
  static_assert(H == 64 || H == 128 || H == 256 || H == 512,
                "the chain is built for hidden 64, 128, 256 and 512");
  static constexpr int NX = H / 2;              // x columns of one warpgroup
  static constexpr int SWE = NX >= 64 ? 64 : 32;  // B column block: 128- or 64-byte swizzle
  static constexpr int NH = NX >= 128 ? 128 : NX;  // h columns of one warpgroup a chunk
  static constexpr int HC = 2 * NH;             // h chunk
  // W0 rows a stage (16 KB at H = 512)
  static constexpr int KS3 = FWD_STAGE_BYTES / (HC * 2) < H ? FWD_STAGE_BYTES / (HC * 2) : H;
};

// The widths and views both chains take (ops/resnetfc.py
// check_chain_widths): hidden a power of two from 64 to 512 (whole wgmma N
// per warpgroup and whole swizzle blocks: a multiple of 64 such as 192 or
// 384 would need n96 or ragged h chunks), d_latent a multiple of 64, an
// even d_in padded to 16 within hidden, at most 16 outputs, 1 to 64 views
// and at least one latent injection.
static inline bool chain_dims_ok(int hidden, int d_latent, int d_in, int d_in_pad, int d_out,
                                 int ns, int n_inj) {
  const bool width = hidden == 64 || hidden == 128 || hidden == 256 || hidden == 512;
  return width && d_latent % 64 == 0 && d_in % 2 == 0 && d_in_pad % 16 == 0 &&
         d_in_pad <= hidden && d_out <= 16 && ns >= 1 && ns <= FWD_ROWS && n_inj >= 1;
}

// launch(std::integral_constant<int, H>()) for the chain's compiled width
// H == hidden; hidden must have passed chain_dims_ok
template <class Launch>
static inline int dispatch_hidden(int hidden, Launch launch) {
  switch (hidden) {
    case 512: return launch(std::integral_constant<int, 512>());
    case 256: return launch(std::integral_constant<int, 256>());
    case 128: return launch(std::integral_constant<int, 128>());
    case 64: return launch(std::integral_constant<int, 64>());
    default: return (int)cudaErrorInvalidValue;
  }
}

static inline int chain_points(int ns) { return ns < FWD_ROWS ? FWD_ROWS / ns : 1; }

__host__ __device__ inline int chain_chunk(int hidden) { return hidden >= 256 ? 256 : hidden; }

// W0 rows a ring stage holds (ChainShape::KS3)
static inline int chain_w0_rows(int hidden) {
  const int rows = FWD_STAGE_BYTES / (chain_chunk(hidden) * 2);
  return rows < hidden ? rows : hidden;
}

// The dynamic shared memory one Hopper block may use: ops/cuda_build.py's
// SMEM_LIMIT, which every build defines as PNT_SMEM_LIMIT.
#ifndef PNT_SMEM_LIMIT
#error "build with -DPNT_SMEM_LIMIT (ops/cuda_build.py)"
#endif

// Dynamic shared memory of a tile whose z tile holds `zw` latent columns:
// alignment slack, the ring, relu(x), z (at least H wide: it doubles as
// pooling scratch), the h chunk and the barriers. A tile of more than 64
// views would need a 128-row tile.
static inline size_t fwd_tile_bytes(int hidden, int zw, int ns) {
  const size_t tiles = (size_t)(ns + FWD_ROWS - 1) / FWD_ROWS;
  const size_t rows = FWD_ROWS * (tiles < 1 ? 1 : tiles);
  const int zt = zw > hidden ? zw : hidden;
  return 1024 + (size_t)FWD_STAGES * FWD_STAGE_BYTES + rows * 2 * (hidden + zt) +
         rows * chain_chunk(hidden) * 2 + (2 * FWD_STAGES + 6) * 8;
}

// The z tile's width: the whole latent where it fits, else the widest
// multiple of 64 (and at least H) that does; the injections then run in
// bands of that width. The tile's size follows (fwd_smem_bytes); past
// PNT_SMEM_LIMIT the wrappers refuse the launch.
static inline int fwd_z_cols(int hidden, int d_latent, int ns) {
  int zw = d_latent;
  while (zw - 64 >= hidden && fwd_tile_bytes(hidden, zw, ns) > PNT_SMEM_LIMIT) zw -= 64;
  return zw;
}

static inline size_t fwd_smem_bytes(int hidden, int d_latent, int ns) {
  return fwd_tile_bytes(hidden, fwd_z_cols(hidden, d_latent, ns), ns);
}

// The ring stages one tile walks and the drains (wgmma_wait<0>) its
// consumers make, as chain_consume schedules them: every product ends
// drained but a block's W1 chunks before its last, which run on into the
// next chunk's W0 product. So a drain a tile for the input layer, one an
// injection band, and one for each W0 chunk and each block's last W1 chunk.
static inline void fwd_schedule(int hidden, int d_latent, int d_in_pad, int ns, int n_blocks,
                                int n_inj, int* stages, int* drains) {
  const int chunks = hidden / chain_chunk(hidden), zw = fwd_z_cols(hidden, d_latent, ns);
  *stages = d_in_pad / 16 + n_inj * (d_latent / 16) +
            n_blocks * (chunks * (hidden / chain_w0_rows(hidden)) + hidden / 16);
  *drains = 1 + n_inj * ((d_latent + zw - 1) / zw) + n_blocks * (chunks + 1);
}

// The launch's checks and its tensor maps; 0 or a cudaError_t.
static inline int chain_setup(ChainParams* p, ChainMaps* m, const void* xin, const void* w_in,
                              const void* b_in, const void* wz, const void* bz, const void* w0,
                              const void* b0, const void* w1, const void* b1, const void* w_out,
                              const void* b_out, void* out, void* spre, void* spost, int sb,
                              int ns, int b, int d_latent, int d_in, int d_in_pad, int hidden,
                              int d_out, int n_blocks, int combine_layer) {
  if (!chain_dims_ok(hidden, d_latent, d_in, d_in_pad, d_out, ns,
                     combine_layer < n_blocks ? combine_layer : n_blocks))
    return (int)cudaErrorInvalidValue;
  p->xin = static_cast<const bf16*>(xin);
  p->b_in = static_cast<const float*>(b_in);
  p->bz = static_cast<const float*>(bz);
  p->b0 = static_cast<const float*>(b0);
  p->b1 = static_cast<const float*>(b1);
  p->w_out = static_cast<const bf16*>(w_out);
  p->b_out = static_cast<const float*>(b_out);
  p->out = static_cast<float*>(out);
  p->spre = static_cast<bf16*>(spre);
  p->spost = static_cast<bf16*>(spost);
  p->zstash = nullptr;
  p->sb = sb;
  p->ns = ns;
  p->b = b;
  p->pts = chain_points(ns);
  p->d_in = d_in;
  p->d_in_pad = d_in_pad;
  p->d_latent = d_latent;
  p->zw = fwd_z_cols(hidden, d_latent, ns);
  p->d_out = d_out;
  p->n_blocks = n_blocks;
  p->combine_layer = combine_layer;
  p->n_inj = combine_layer < n_blocks ? combine_layer : n_blocks;
  p->k = ns > 1 ? p->n_inj : 0;
  const int swe = hidden / 2 >= 64 ? 64 : 32;
  const int nblk = hidden / swe;
  int err = weight_map(&m->w_in, w_in, d_in_pad, hidden, swe, 16, nblk);
  if (!err) err = weight_map(&m->wz, wz, p->n_inj * d_latent, hidden, swe, 16, nblk);
  const int hc = chain_chunk(hidden);
  if (!err)
    err = weight_map(&m->w0, w0, n_blocks * hidden, hidden, swe, chain_w0_rows(hidden), hc / swe);
  if (!err) err = weight_map(&m->w1, w1, n_blocks * hidden, hidden, swe, 16, nblk);
  return err;
}

// The producer thread: every weight tile of the chain, in the consumers'
// order, into the ring.
template <int H>
__device__ __forceinline__ void chain_produce(const ChainParams& p, const ChainMaps& m, unsigned char* ring,
                              uint64_t* full, uint64_t* empty) {
  typedef ChainShape<H> S;
  const uint64_t keep = l2_evict_last();
  int stage = 0;
  uint32_t phase = 0;
  auto slot = [&](uint32_t bytes) {
    mbar_wait(&empty[stage], phase ^ 1);
    mbar_expect_tx(&full[stage], bytes);
    return ring + stage * FWD_STAGE_BYTES;
  };
  auto next = [&]() {
    if (++stage == FWD_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  // a band of 16 rows x H: H / SWE column blocks of 16 x SWE, one box
  auto band = [&](const CUtensorMap* map, int row) {
    tma_load_3d(slot(16 * H * 2), map, &full[stage], 0, row, 0, keep);
    next();
  };
  for (int kk = 0; kk < p.d_in_pad; kk += 16) band(&m.w_in, kk);
  for (int blk = 0; blk < p.n_blocks; blk++) {
    if (blk < p.n_inj)
      for (int kk = 0; kk < p.d_latent; kk += 16) band(&m.wz, blk * p.d_latent + kk);
    for (int c = 0; c < H; c += S::HC) {
      // KS3 rows of W0's chunk columns (each warpgroup's NH of them in
      // SWE-wide blocks), one box
      for (int kk = 0; kk < H; kk += S::KS3) {
        tma_load_3d(slot(S::KS3 * S::HC * 2), &m.w0, &full[stage], 0, blk * H + kk,
                    c / S::SWE, keep);
        next();
      }
      for (int kk = 0; kk < S::HC; kk += 16) band(&m.w1, blk * H + c + kk);
    }
  }
}

// D (64 x N) += A @ B, B MN-major (TB = 1) or K-major (TB = 0)
template <int N, int TB = 1, int R>
__device__ __forceinline__ void wgmma_n(float (&d)[R], uint64_t da, uint64_t db) {
  static_assert(R == N / 2, "accumulator size");
  if constexpr (N == 256) wgmma_n256<TB>(d, da, db);
  else if constexpr (N == 128) wgmma_n128<TB>(d, da, db);
  else if constexpr (N == 64) wgmma_n64<TB>(d, da, db);
  else wgmma_n32<TB>(d, da, db);
}

// The consumers' view of the ring: stage and phase walk in lockstep with
// the producer's.
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stage;
  uint32_t phase;
};

// acc (64 x N, this warpgroup's columns) += A[:, :K] @ the next K / KS ring
// stages of KS rows each; this warpgroup's B starts `boff` bytes into a
// stage, rows `swb` bytes apart, MN blocks of swb / 2 columns `lbo` apart.
// A stage's products are one wgmma group, left in flight while the next
// stage's are issued; a warp frees a stage once its group has completed.
// `held` is the stage whose group may still run (-1: none). DRAIN ends the
// product with every group complete, for an epilogue that reads acc (or a
// rewrite of A); without it the last group runs on into the caller's next
// product, whose first stage frees it, and acc is not touched until a
// later product drains.
template <int N, bool DRAIN, int R>
__device__ __forceinline__ void ring_product(float (&acc)[R], const unsigned char* A, int K,
                                             int KS, Ring& rg, int& held, uint32_t boff,
                                             uint32_t lbo, uint32_t swb) {
  const uint32_t layout = swb == 128 ? 1 : 2;
  const bool lead = threadIdx.x % 32 == 0;
  fence_regs(acc);
  wgmma_fence();
  for (int k0 = 0; k0 < K; k0 += KS) {
    mbar_wait(&rg.full[rg.stage], rg.phase);
    const unsigned char* B = rg.base + rg.stage * FWD_STAGE_BYTES + boff;
    for (int kk = 0; kk < KS; kk += 16)
      wgmma_n<N>(acc, a_desc(A, k0 + kk), smem_desc(B + kk * swb, lbo, 8 * swb, layout));
    wgmma_commit();
    wgmma_wait<1>();
    if (held >= 0 && lead) mbar_arrive(&rg.empty[held]);
    held = rg.stage;
    if (++rg.stage == FWD_STAGES) {
      rg.stage = 0;
      rg.phase ^= 1;
    }
  }
  if constexpr (DRAIN) {
    wgmma_wait<0>();
    if (lead) mbar_arrive(&rg.empty[held]);
    held = -1;
    fence_regs(acc);
  }
}

// bf16(lo) in the low half, bf16(hi) in the high half
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator fragment of m64nN: register 4j + {0,1} holds row r0, columns
// 8j + 2q + {0,1}; 4j + {2,3} row r0 + 8 (r0 = 16 * warp + lane / 4, q =
// lane % 4, within the warpgroup).
template <int R>
__device__ __forceinline__ void add_bias(float (&x)[R], const float* b, int col0, int q) {
  const float* bq = b + col0 + 2 * q;
#pragma unroll
  for (int j = 0; j < R / 4; j++) {
    const float2 bb = *reinterpret_cast<const float2*>(bq + 8 * j);
    x[4 * j] += bb.x;
    x[4 * j + 1] += bb.y;
    x[4 * j + 2] += bb.x;
    x[4 * j + 3] += bb.y;
  }
}

// bf16(relu(acc (+ b))) into a K-major swizzled tile at columns col0 + ...,
// a pair of 8-column blocks a stmatrix x4: its four 8 x 8 matrices are rows
// 0-7 and 8-15 of the warp's 16 in each block, lane l addressing row
// l % 8 + (l & 8) of block l / 16 (the accumulator fragment is stmatrix's)
template <int R>
__device__ __forceinline__ void store_relu(unsigned char* tile, const float (&x)[R],
                                           const float* b, int col0, int r0, int q) {
  static_assert(R % 8 == 0, "pairs of 8-column blocks");
  // read here, not hoisted: addresses kept live across the chain would spill
  uint32_t lane;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(lane));
  const int row = (r0 & ~15) + (lane & 8) + (lane & 7);
  const uint32_t base = smem_u32(tile);
  const float* bq = b == nullptr ? nullptr : b + col0 + 2 * q;
#pragma unroll
  for (int j = 0; j < R / 4; j += 2) {
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 2; i++) {
      float2 bb = make_float2(0.f, 0.f);
      if (bq != nullptr) bb = *reinterpret_cast<const float2*>(bq + 8 * (j + i));
      const int e = 4 * (j + i);
      v[2 * i] = bf16x2_bits(fmaxf(x[e] + bb.x, 0.f), fmaxf(x[e + 1] + bb.y, 0.f));
      v[2 * i + 1] = bf16x2_bits(fmaxf(x[e + 2] + bb.x, 0.f), fmaxf(x[e + 3] + bb.y, 0.f));
    }
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     base + sw128_offset(row, col0 + 8 * (j + (lane >> 4)))),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// Copy `ncols` columns of a swizzled tile's valid rows to columns dc0 of
// `dst` (rows `width` wide), 16 bytes a copier thread (streaming stores,
// evicted from L2 first: the stash must not push the weights out):
// pre-pool rows r = v * P + pt go to row (s, v, p0 + pt) of an (SB, NS, B,
// width) array, post-pool rows r = pt to row (s, p0 + pt) of an (SB, B,
// width) one; rows of points past B are skipped.
__device__ void stash_rows(const ChainParams& p, const unsigned char* tile, int ncols, bool pre,
                           bf16* dst, int width, int dc0, int s, int p0) {
  const int P = p.pts, nrows = pre ? p.ns * P : P, chunks = ncols / 8;
  for (int e = threadIdx.x - (FWD_THREADS - FWD_COPIERS); e < nrows * chunks; e += FWD_COPIERS) {
    const int r = e / chunks, j = e % chunks;
    const int v = pre ? r / P : 0, pt = pre ? r % P : r;
    if (p0 + pt >= p.b) continue;
    const size_t row = pre ? ((size_t)s * p.ns + v) * p.b + p0 + pt : (size_t)s * p.b + p0 + pt;
    __stcs(reinterpret_cast<int4*>(dst + row * width + dc0 + j * 8),
           *reinterpret_cast<const int4*>(tile + sw128_offset(r, j * 8)));
  }
}

// slot `slot` of the pre- or post-pool stash
__device__ __forceinline__ bf16* stash_slot(const ChainParams& p, int H, bool pre, int slot) {
  const size_t rows = (size_t)p.sb * (pre ? p.ns : 1) * p.b;
  return (pre ? p.spre : p.spost) + slot * rows * H;
}

// the positional-code rows into the A tile, zero past d_in, past the last
// point and past NS * P: column pairs (d_in is even), eight loads in flight
// a thread before their stores
__device__ void load_xin(const ChainParams& p, unsigned char* A, int s, int p0) {
  const int P = p.pts, rows = p.ns * P, pairs = p.d_in_pad / 2;
  for (int e0 = threadIdx.x; e0 < FWD_ROWS * pairs; e0 += 8 * FWD_CONSUMERS) {
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; i++) {
      const int e = e0 + i * FWD_CONSUMERS, r = e / pairs, kk = 2 * (e % pairs);
      const int pt = p0 + r % P;
      v[i] = 0u;
      if (e < FWD_ROWS * pairs && kk < p.d_in && r < rows && pt < p.b)
        v[i] = *reinterpret_cast<const uint32_t*>(
            p.xin + (((size_t)s * p.ns + r / P) * p.b + pt) * p.d_in + kk);
    }
#pragma unroll
    for (int i = 0; i < 8; i++) {
      const int e = e0 + i * FWD_CONSUMERS;
      if (e < FWD_ROWS * pairs)
        *reinterpret_cast<uint32_t*>(A + sw128_offset(e / pairs, 2 * (e % pairs))) = v[i];
    }
  }
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// byte offset of the column pair (r, c) in the pooling's f32 scratch (64 x
// H): its 8-byte units XOR-swizzled by r % 8, so the eight rows of a warp's
// access fall on distinct banks in pairs, the fewest wavefronts
__device__ __forceinline__ uint32_t pool_offset(int r, int c, int H) {
  return (uint32_t)(r * H * 4 + (((c >> 1) ^ ((r & 7) << 2)) << 3));
}

// Shared-memory carve-up of a 64-row tile.
struct ChainSmem {
  unsigned char* ring;
  unsigned char* A;   // relu(x) (64 x H), first the xin tile
  unsigned char* Z;   // the z tile (64 x max(zw, H)); A and Z are the pooling scratch
  unsigned char* Hb;  // an h chunk (64 x HC)
  uint64_t* full;
  uint64_t* empty;
  // stash handoffs, consumers to copiers and back: the z tile, relu(x) in
  // A, an h chunk in Hb
  uint64_t *z_ready, *z_free, *a_ready, *a_free, *h_ready, *h_free;
};

__device__ __forceinline__ ChainSmem chain_smem(unsigned char* raw, int H, int ZW) {
  ChainSmem m;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int zw = ZW > H ? ZW : H;
  m.ring = base;
  m.A = m.ring + FWD_STAGES * FWD_STAGE_BYTES;
  m.Z = m.A + FWD_ROWS * H * 2;
  m.Hb = m.Z + FWD_ROWS * zw * 2;
  m.full = reinterpret_cast<uint64_t*>(m.Hb + FWD_ROWS * chain_chunk(H) * 2);
  m.empty = m.full + FWD_STAGES;
  m.z_ready = m.empty + FWD_STAGES;
  m.z_free = m.z_ready + 1;
  m.a_ready = m.z_ready + 2;
  m.a_free = m.z_ready + 3;
  m.h_ready = m.z_ready + 4;
  m.h_free = m.z_ready + 5;
  return m;
}

// A consumer warp hands a tile it has written (after the barrier that
// completes it) to the stash copiers.
__device__ __forceinline__ void hand_over(uint64_t* ready) {
  if (threadIdx.x % 32 == 0) mbar_arrive(ready);
}

// The consumer warpgroups: the chain from the loaded z tile to the output
// rows. `load_z(Z, s, p0, c0, nc, live)` fills the z tile with latent
// columns [c0, c0 + nc); `live` says the residual stream's registers are
// live (a band reloaded mid-chain), where a loader should keep few. With the stash, each operand tile it belongs to is handed
// to the copiers once written, and rewritten only after they have freed
// it: nz, na, nh count the z band, relu(x) and h handoffs.
template <int H, class LoadZ>
__device__ __forceinline__ void chain_consume(const ChainParams& p, const ChainSmem& m,
                                              LoadZ load_z) {
  typedef ChainShape<H> S;
  constexpr int NX = S::NX, NH = S::NH, HC = S::HC, SWB = S::SWE * 2;
  const int s = blockIdx.y, P = p.pts, p0 = blockIdx.x * P;
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * (warp % 4) + lane / 4, q = lane % 4;
  const int xc0 = wg * NX;  // this warpgroup's x columns
  const bool stash = p.spost != nullptr, zstash = p.zstash != nullptr;
  const int ns = p.ns;
  // products of a 16 x H band stage (x columns) and of a KS3 x HC one (h)
  const uint32_t band_off = wg * 16 * NX * 2, band_lbo = 16 * S::SWE * 2;
  const uint32_t chunk_off = wg * (NH / S::SWE) * S::KS3 * SWB, chunk_lbo = S::KS3 * SWB;
  Ring rg{m.ring, m.full, m.empty, 0, 0};
  int held = -1;  // the ring stage whose wgmma group may still run
  uint32_t nz = 1, na = 0, nh = 0;
  // before rewriting A (or using it as scratch): the last relu(x) copied
  auto a_freed = [&]() {
    if (stash && na > 0) mbar_wait(m.a_free, (na - 1) & 1);
  };
  // before rewriting Z: the last z band copied to the z-stash
  auto z_freed = [&]() {
    if (zstash) mbar_wait(m.z_free, (nz - 1) & 1);
  };
  const bool banded = p.zw < p.d_latent;

  load_z(m.Z, s, p0, 0, p.zw, false);
  load_xin(p, m.A, s, p0);
  fence_async_smem();
  bar_sync(1, FWD_CONSUMERS);
  if (zstash) hand_over(m.z_ready);

  float x[NX / 2];
#pragma unroll
  for (int i = 0; i < NX / 2; i++) x[i] = 0.f;
  ring_product<NX, true>(x, m.A, p.d_in_pad, 16, rg, held, band_off, band_lbo, SWB);
  add_bias(x, p.b_in, xc0, q);

  for (int blk = 0; blk < p.n_blocks; blk++) {
    if (blk == p.combine_layer && ns > 1) {
      // mean over the views through f32 scratch over the A and Z tiles
      // (pool_offset), the views added in order into the rows of the P
      // points; the other rows keep their values
      a_freed();
      z_freed();
      const uint32_t scr = smem_u32(m.A);
#pragma unroll
      for (int j = 0; j < NX / 8; j++)
#pragma unroll
        for (int h = 0; h < 2; h++)
          st_shared_f2(scr + pool_offset(r0 + 8 * h, xc0 + 8 * j + 2 * q, H), x[4 * j + 2 * h],
                       x[4 * j + 2 * h + 1]);
      bar_sync(1, FWD_CONSUMERS);
      const bool live[2] = {r0 < P, r0 + 8 < P};
#pragma unroll
      for (int j = 0; j < NX / 8; j++)
#pragma unroll
        for (int h = 0; h < 2; h++)
          if (live[h]) x[4 * j + 2 * h] = x[4 * j + 2 * h + 1] = 0.f;
      for (int v = 0; v < ns; v++) {
#pragma unroll
        for (int j = 0; j < NX / 8; j++)
#pragma unroll
          for (int h = 0; h < 2; h++) {
            if (!live[h]) continue;
            const float2 t =
                ld_shared_f2(scr + pool_offset(v * P + r0 + 8 * h, xc0 + 8 * j + 2 * q, H));
            x[4 * j + 2 * h] += t.x;
            x[4 * j + 2 * h + 1] += t.y;
          }
      }
#pragma unroll
      for (int j = 0; j < NX / 8; j++)
#pragma unroll
        for (int h = 0; h < 2; h++)
          if (live[h]) {
            x[4 * j + 2 * h] = x[4 * j + 2 * h] / (float)ns;
            x[4 * j + 2 * h + 1] = x[4 * j + 2 * h + 1] / (float)ns;
          }
      bar_sync(1, FWD_CONSUMERS);
    }
    if (blk < p.n_inj) {
      for (int z0 = 0; z0 < p.d_latent; z0 += p.zw) {
        const int nc = p.d_latent - z0 < p.zw ? p.d_latent - z0 : p.zw;
        if (banded && (blk > 0 || z0 > 0)) {
          // the next band: both warpgroups' products on the last are done
          // and it is copied
          z_freed();
          bar_sync(1, FWD_CONSUMERS);
          load_z(m.Z, s, p0, z0, nc, true);
          fence_async_smem();
          bar_sync(1, FWD_CONSUMERS);
          if (zstash && blk == 0) {
            hand_over(m.z_ready);
            nz++;
          }
        }
        // drained: add_bias reads x next, or the next band overwrites Z
        ring_product<NX, true>(x, m.Z, nc, 16, rg, held, band_off, band_lbo, SWB);
      }
      add_bias(x, p.bz + (size_t)blk * H, xc0, q);
    }
    a_freed();
    store_relu(m.A, x, nullptr, xc0, r0, q);
    fence_async_smem();
    bar_sync(1, FWD_CONSUMERS);
    if (stash) hand_over(m.a_ready);
    na++;
    const float* b0 = p.b0 + (size_t)blk * H;
#pragma unroll
    for (int c = 0; c < H; c += HC) {
      float h[NH / 2];
#pragma unroll
      for (int i = 0; i < NH / 2; i++) h[i] = 0.f;
      // issued right behind the previous chunk's W1 product (still in
      // flight onto x); this drain completes both
      ring_product<NH, true>(h, m.A, H, S::KS3, rg, held, chunk_off, chunk_lbo, SWB);
      // both warpgroups are done with the previous chunk (for a block's
      // first, the barrier after relu(x) saw to it) and it is copied
      if (c > 0) bar_sync(1, FWD_CONSUMERS);
      if (stash && nh > 0) mbar_wait(m.h_free, (nh - 1) & 1);
      store_relu(m.Hb, h, b0 + c, wg * NH, r0, q);
      fence_async_smem();
      bar_sync(1, FWD_CONSUMERS);
      if (stash) hand_over(m.h_ready);
      nh++;
      // the block's last chunk drains for add_bias; another runs on into
      // the next chunk's W0 product, which reads only A
      if (c + HC < H)
        ring_product<NX, false>(x, m.Hb, HC, 16, rg, held, band_off, band_lbo, SWB);
      else
        ring_product<NX, true>(x, m.Hb, HC, 16, rg, held, band_off, band_lbo, SWB);
    }
    add_bias(x, p.b1 + (size_t)blk * H, xc0, q);
  }

  // out = relu(x) @ W_out + b_out for the tile's P points: W_out goes to
  // the z tile (dead since the last injection) as f32 [o][k]; one warp a
  // row, lane l summing k = l, l + 32, ... in order, then a butterfly over
  // the lanes
  a_freed();
  z_freed();
  store_relu(m.A, x, nullptr, xc0, r0, q);
  const int d_out = p.d_out;
  float* wo = reinterpret_cast<float*>(m.Z);
  for (int k = tid; k < H; k += FWD_CONSUMERS)
    for (int o = 0; o < d_out; o++) wo[o * H + k] = __bfloat162float(p.w_out[k * d_out + o]);
  bar_sync(1, FWD_CONSUMERS);
  if (stash) hand_over(m.a_ready);
  for (int r = warp; r < P; r += FWD_CONSUMERS / 32) {
    if (p0 + r >= p.b) break;
    float a[H / 32];
#pragma unroll
    for (int i = 0; i < H / 32; i++)
      a[i] = __bfloat162float(*reinterpret_cast<const bf16*>(m.A + sw128_offset(r, lane + 32 * i)));
    for (int o = 0; o < d_out; o++) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < H / 32; i++) v += a[i] * wo[o * H + lane + 32 * i];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) p.out[((size_t)s * p.b + p0 + r) * d_out + o] = v + p.b_out[o];
    }
  }
}

// The stash copiers (three warps of the producer warpgroup): each operand
// tile the consumers hand over goes to its stash slot while the tensor
// cores run the products that read it; a warp frees the tile once its
// copies are issued.
template <int H>
__device__ __forceinline__ void chain_copy(const ChainParams& p, const ChainSmem& m) {
  const int s = blockIdx.y, p0 = blockIdx.x * p.pts, k = p.k, mm = p.n_blocks - p.k;
  const int HC = chain_chunk(H);
  uint32_t na = 0, nh = 0;
  auto free_tile = [&](uint64_t* bar) {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(bar);
  };
  if (p.zstash != nullptr) {
    // the first injection's z bands (one where the latent fits the tile)
    for (int z0 = 0, i = 0; z0 < p.d_latent; z0 += p.zw, i++) {
      mbar_wait(m.z_ready, i & 1);
      stash_rows(p, m.Z, p.d_latent - z0 < p.zw ? p.d_latent - z0 : p.zw, true, p.zstash,
                 p.d_latent, z0, s, p0);
      free_tile(m.z_free);
    }
  }
  for (int blk = 0; blk < p.n_blocks; blk++) {
    const bool pre = blk < k;
    mbar_wait(m.a_ready, na++ & 1);
    stash_rows(p, m.A, H, pre, stash_slot(p, H, pre, pre ? blk : blk - k), H, 0, s, p0);
    free_tile(m.a_free);
    for (int c = 0; c < H; c += HC) {
      mbar_wait(m.h_ready, nh++ & 1);
      stash_rows(p, m.Hb, HC, pre, stash_slot(p, H, pre, pre ? k + blk : mm + blk - k), H, c, s,
                 p0);
      free_tile(m.h_free);
    }
  }
  mbar_wait(m.a_ready, na & 1);
  stash_rows(p, m.A, H, false, stash_slot(p, H, false, 2 * mm), H, 0, s, p0);
}

// The whole tile: barriers, then the producer and consumer roles (which
// never meet at a __syncthreads again).
template <int H, class LoadZ>
__device__ __forceinline__ void run_chain(const ChainParams& p, const ChainMaps& maps,
                                          LoadZ load_z) {
  extern __shared__ __align__(1024) unsigned char chain_raw[];
  const ChainSmem m = chain_smem(chain_raw, H, p.zw);
  if (threadIdx.x == 0) {
    for (int i = 0; i < FWD_STAGES; i++) {
      mbar_init(&m.full[i], 1);
      mbar_init(&m.empty[i], FWD_CONSUMERS / 32);
    }
    for (uint64_t* b = m.z_ready; b <= m.h_free; b += 2) {
      mbar_init(b, FWD_CONSUMERS / 32);    // *_ready: the consumer warps
      mbar_init(b + 1, FWD_COPIERS / 32);  // *_free: the copier warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= FWD_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == FWD_CONSUMERS) chain_produce<H>(p, maps, m.ring, m.full, m.empty);
    if (threadIdx.x >= FWD_THREADS - FWD_COPIERS && p.spost != nullptr) chain_copy<H>(p, m);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    chain_consume<H>(p, m, load_z);
  }
}
