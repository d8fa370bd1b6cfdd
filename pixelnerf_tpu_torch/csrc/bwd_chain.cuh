// The ResnetFC backward block chain of one point tile on Hopper, from the
// forward's bf16 stash (resnetfc_bwd.cu's `chain` kernel). Replaces the
// chain of the TPU kernels resnetfc_pallas.py `_backward_tile` (used by
// `_bwd_kernel`) and field_pallas.py `_field_bwd_kernel`.
//
// A tile is the forward's (fwd_chain.cuh): one CTA over (scene s, P =
// max(1, 64/NS) points x NS views), rows view-major in one 64-row wgmma
// tile. Per row (bf(.) rounds to bf16; masks are stash > 0):
//   gx   = bf(g) @ W_out^T * [relu(x_final) > 0]
//   block i, from the last:  G1_i = bf(gx)
//          gh1 = G1_i @ W1_i^T * [relu(h1_i) > 0]            G0_i = bf(gh1)
//          gx += G0_i @ W0_i^T * [relu(block_in_i) > 0]
//          i == combine_layer, NS > 1: gx = broadcast(gx) / NS
//   Gin  = bf(gx);  dxin = Gin @ W_in^T
//   gz   = [Gin | G1_0 | ... | G1_{n_inj-2}] @ [Wz_0 | ... ]^T   (one K =
//          n_inj * H product after the chain, as the TPU kernel's: the
//          cotangent at injection i's point is the one at block i's input,
//          which is Gin for i = 0 and G1_{i-1} otherwise, bit for bit)
//   db1_i, db0_i, db_in, dbz_i, db_out: column sums of the f32 cotangents
// then either dz = bf(gz), or (the field) bf(gz) times the composed taps
// added into the native level gradients with f32 reductions, or (F32, a
// float32 caller's) dz = gz and dxin unrounded, in float32. G1, G0, Gin and
// bf(g) go to device memory in the stash's layout for the weight-gradient
// products (resnetfc_bwd.cu `wgrad`).
//
// Bound on the H100: operations. At the flagship width a point costs ~23
// MFLOP of bf16 products (twice the forward's) against ~17 KB of stash
// read and ~15 KB of cotangents written: ~6.6 ms of bytes against ~7.7 ms
// of products a cached train step at 3.35 TB/s and 989 TFLOP/s, so bytes
// come close to binding and must stream off the products' path.
//
// Design, the forward chain's parts run backward. 384 threads: two consumer
// warpgroups (224 registers) and a producer warpgroup (56): one TMA thread,
// three copier warps.
// - gx lives in registers, warpgroup w owning its columns [w*H/2,
//   (w+1)*H/2) (128 registers a thread at H = 512). A mask applies to a
//   product, not to the sum, so each product runs in column sub-chunks of
//   64 (n64, 32 registers) into its own accumulator, is masked, and is
//   added to gx (gh1: masked, summed, rounded into the G0 tile).
// - Weights need no transpose: for a @ W^T the B operand is K-major, which
//   the unchanged row-major W already is (row n of W is column n of W^T,
//   contiguous over K). The TMA thread streams boxes of W (W0, W1: 64 rows
//   x 64 K-columns, 128-byte swizzle; W_in, Wz: 32 and 128 rows x 32
//   K-columns, 64-byte swizzle), one for each warpgroup's columns, in the
//   chain's order (W1, W0 per block from the last, W_in, Wz) into the
//   4-stage mbarrier ring; wgmma reads them with tnspB = 0.
// - The A operands are bf16 K-major 128-byte swizzled tiles written by the
//   consumers: G1 (GA) and G0 (GB). The copier warps copy each one out to
//   its cotangent slot while the next products read it, and turn the next
//   block's stash rows into bit masks in shared memory (a word holds 32
//   columns), so neither the stash reads nor the cotangent writes sit on
//   the consumers' path.
// - The first gx is one k16 product too (bf(g) and W_out staged as operand
//   tiles), and the un-pooling runs as short loops: code that runs once a
//   tile is kept small, since its instruction fetches queue behind the
//   weight stream in L2.
// - g_z runs after the chain, when gx's registers are free: 2 x n128
//   accumulators a thread over passes of 512 latent columns. Its A tiles
//   are Gin (in GB) and G1_0 (still in GA), the others reloaded from their
//   cotangent slots (L2-hot) by the consumers. bf(gz) is staged in GB for
//   the dz copy or the level scatter; the F32 chain stores gz from the
//   accumulators instead, and dxin as float2 in place of bf16 pairs. The
//   scatter walks each view's run of the tile's points (consecutive
//   samples of rays) with a warp an item of a level's channels, lanes over
//   channel quads: w * g summed in registers while the points' tap base
//   holds, one 16-byte reduction (8-byte where a
//   level's channels are not quads) a lane and nonzero tap when it changes,
//   in place of one f32 atomic a channel and tap. Shared memory is full, so
//   even the small levels take reductions into device memory.
// - Bias sums: shuffles within a warp, partial rows in shared memory across
//   the warpgroup, one f32 atomic per column per CTA.
// Shared memory at H = d_latent = 512: ring 64 KB, GA 64 KB, GB 64 KB,
// four mask buffers 17 KB, partial sums 16 KB (226 KB). The view un-pooling
// goes through GA as f32 scratch (P <= 32 rows when NS > 1).
#pragma once

#include "fwd_chain.cuh"
#include "scatter_accum.cuh"

#define BWD_KS 32         // K columns of a W_in or Wz box (64-byte swizzle rows)
#define BWD_KW 64         // K columns of a W0 or W1 box (128-byte swizzle rows)
#define BWD_MASKS 4       // mask buffers
#define BWD_ZW 128        // latent columns of a warpgroup in a g_z unit
#define BWD_ZPASS 512     // latent columns of a g_z pass (two units)
#define BWD_IW 32         // dxin columns of a warpgroup in a unit
#define GOUT_LD 16        // columns of the bf16 copy of g (d_out <= 16)
#define BWD_MASK_ITEMS 2  // mask words a copier thread loads at once

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
  bf16* dz;           // (SB, NS, B, DL); null for the field; float for the F32 chain
  bf16* dxin;         // (SB, NS, B, d_in); float for the F32 chain
  float* grads[MAX_LEVELS];  // the field's level gradients (SB*NS, H_l, W_l, C_l)
  int lh[MAX_LEVELS], lw[MAX_LEVELS], lc[MAX_LEVELS], lc0[MAX_LEVELS];
  int nlev;           // 0: no levels, write dz
  const float* grid;  // (SB, NS, B, 2) normalized fine-grid coords
  float* db_in;       // (H)
  float* dbz;         // (n_inj, H)
  float* db0;         // (n_blocks, H)
  float* db1;
  float* db_out;      // (d_out)
  int sb, ns, b, pts, d_in, d_in_pad, hidden, d_latent, d_out, n_blocks, combine_layer, k, n_inj;
};

// TMA maps over the row-major weights: w0, w1 (n_blocks * H, H) in boxes
// of NH rows x BWD_KW columns, w_in (d_in_pad, H) of BWD_IW x BWD_KS, wz
// (n_inj * DL, H) of BWD_ZW x BWD_KS
struct BwdMaps {
  CUtensorMap w_in, wz, w0, w1;
};

template <int H>
struct BwdShape {
  static constexpr int NX = ChainShape<H>::NX;  // gx columns of a warpgroup
  static constexpr int NH = NX >= 64 ? 64 : NX;  // columns of a product sub-chunk
  static constexpr int NSUB = NX / NH;
};

__host__ __device__ inline int bwd_nh(int hidden) { return hidden / 2 >= 64 ? 64 : hidden / 2; }

// columns of the GB tile: a gx tile, or a g_z pass's staged bf16 result
__host__ __device__ inline int bwd_gb_cols(int hidden, int d_latent) {
  const int units = (d_latent + 2 * BWD_ZW - 1) / (2 * BWD_ZW);
  const int pass = units >= 2 ? BWD_ZPASS : 2 * BWD_ZW;
  return hidden > pass ? hidden : pass;
}

// words of one mask row (32 columns a word), padded against bank conflicts
__host__ __device__ inline int bwd_mask_words(int hidden) { return hidden / 32 + 1; }

// Dynamic shared memory of a tile; a tile of more than 64 views would need
// a 128-row tile, so the rows (and the size) grow past 64 views as the
// forward's (fwd_smem_bytes) and the launch refuses them.
static inline size_t bwd_smem_bytes(int hidden, int d_latent, int ns) {
  const size_t tiles = (size_t)(ns + FWD_ROWS - 1) / FWD_ROWS;
  const size_t rows = FWD_ROWS * (tiles < 1 ? 1 : tiles);
  return 1024 + (size_t)FWD_STAGES * FWD_STAGE_BYTES + rows * 2 * hidden +
         rows * 2 * bwd_gb_cols(hidden, d_latent) +
         (size_t)BWD_MASKS * rows * bwd_mask_words(hidden) * 4 + 2 * 4 * (size_t)hidden * 4 +
         (2 * FWD_STAGES + 2 * BWD_MASKS + 4) * 8;
}

struct BwdSmem {
  unsigned char* ring;
  unsigned char* GA;  // G1 (64 x H); at the start W_out as f32; un-pool scratch
  unsigned char* GB;  // G0, Gin, the staged bf16 g_z; at the start g as f32
  uint32_t* masks;    // BWD_MASKS x 64 rows x bwd_mask_words(H)
  float* part;        // 2 x 4 warps x H partial column sums
  uint64_t *full, *empty, *mfull, *mempty;
  uint64_t *ga_ready, *ga_free, *gb_ready, *gb_free;
};

__device__ __forceinline__ BwdSmem bwd_smem(unsigned char* raw, int H, int DL) {
  BwdSmem m;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  m.ring = base;
  m.GA = m.ring + FWD_STAGES * FWD_STAGE_BYTES;
  m.GB = m.GA + FWD_ROWS * H * 2;
  m.masks = reinterpret_cast<uint32_t*>(m.GB + FWD_ROWS * bwd_gb_cols(H, DL) * 2);
  m.part = reinterpret_cast<float*>(m.masks + BWD_MASKS * FWD_ROWS * bwd_mask_words(H));
  m.full = reinterpret_cast<uint64_t*>(m.part + 2 * 4 * H);
  m.empty = m.full + FWD_STAGES;
  m.mfull = m.empty + FWD_STAGES;
  m.mempty = m.mfull + BWD_MASKS;
  m.ga_ready = m.mempty + BWD_MASKS;
  m.ga_free = m.ga_ready + 1;
  m.gb_ready = m.ga_ready + 2;
  m.gb_free = m.ga_ready + 3;
  return m;
}

// global row of tile row r, or -1 past the points: pre-pool rows r = v * P
// + pt index (SB, NS, B) arrays, post-pool rows r = pt (SB, B) ones. The
// input side (Gin, dxin, dz, the injections) is pre-pool indexing, which
// at NS = 1 (P = 64) is the post-pool one.
__device__ __forceinline__ long long bwd_row(const BwdParams& p, bool pre, int s, int p0, int r) {
  const int P = p.pts;
  if (pre) {
    if (r >= p.ns * P || p0 + r % P >= p.b) return -1;
    return ((long long)s * p.ns + r / P) * p.b + p0 + r % P;
  }
  if (r >= P || p0 + r >= p.b) return -1;
  return (long long)s * p.b + p0 + r;
}

__device__ __forceinline__ size_t bwd_slot_rows(const BwdParams& p, bool pre) {
  return (size_t)p.sb * (pre ? p.ns : 1) * p.b;
}

// slot `i` of the stash (act) or of the cotangents, pre- or post-pool
__device__ __forceinline__ const bf16* stash_at(const BwdParams& p, bool pre, int i) {
  return (pre ? p.spre : p.spost) + i * bwd_slot_rows(p, pre) * p.hidden;
}
__device__ __forceinline__ bf16* cot_at(const BwdParams& p, bool pre, int i) {
  return (pre ? p.gpre : p.gpost) + i * bwd_slot_rows(p, pre) * p.hidden;
}

// stash slots of block blk: relu(block_in) (h1 = 0) or relu(h1) (h1 = 1);
// cotangent slots: G1 (h1 = 0) or G0 (h1 = 1)
__device__ __forceinline__ int block_slot(const BwdParams& p, int blk, int h1) {
  const int k = p.k, m = p.n_blocks - p.k;
  return blk < k ? h1 * k + blk : h1 * m + blk - k;
}

// ---------------------------------------------------------------- producer

template <int H>
__device__ __forceinline__ void bwd_produce(const BwdParams& p, const BwdMaps& m,
                                            unsigned char* ring, uint64_t* full,
                                            uint64_t* empty) {
  typedef BwdShape<H> S;
  const uint64_t keep = l2_evict_last();
  int stage = 0;
  uint32_t phase = 0;
  // one stage: a box of `rows` weight rows at r0 (the first warpgroup's)
  // and at r1 (the second's), K columns [kk, kk + ks)
  auto pair = [&](const CUtensorMap* map, int rows, int ks, int r0, int r1, int kk) {
    mbar_wait(&empty[stage], phase ^ 1);
    mbar_expect_tx(&full[stage], 2 * rows * ks * 2);
    unsigned char* dst = ring + stage * FWD_STAGE_BYTES;
    tma_load_3d(dst, map, &full[stage], 0, r0, kk / ks, keep);
    tma_load_3d(dst + rows * ks * 2, map, &full[stage], 0, r1, kk / ks, keep);
    if (++stage == FWD_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  for (int blk = p.n_blocks - 1; blk >= 0; blk--)
    for (int w = 0; w < 2; w++)  // W1, then W0
      for (int j = 0; j < S::NSUB; j++)
        for (int kk = 0; kk < H; kk += BWD_KW)
          pair(w == 0 ? &m.w1 : &m.w0, S::NH, BWD_KW, blk * H + j * S::NH,
               blk * H + S::NX + j * S::NH, kk);
  for (int u = 0; u < p.d_in_pad; u += 2 * BWD_IW)
    for (int kk = 0; kk < H; kk += BWD_KS) pair(&m.w_in, BWD_IW, BWD_KS, u, u + BWD_IW, kk);
  const int DL = p.d_latent, units = (DL + 2 * BWD_ZW - 1) / (2 * BWD_ZW);
  for (int u0 = 0; u0 < units; u0 += 2)
    for (int i = 0; i < p.n_inj; i++)
      for (int kk = 0; kk < H; kk += BWD_KS)
        for (int u = u0; u < units && u < u0 + 2; u++)
          pair(&m.wz, BWD_ZW, BWD_KS, i * DL + u * 2 * BWD_ZW, i * DL + u * 2 * BWD_ZW + BWD_ZW,
               kk);
}

// ---------------------------------------------------------------- consumers

__device__ __forceinline__ void ring_next(Ring& rg) {
  if (++rg.stage == FWD_STAGES) {
    rg.stage = 0;
    rg.phase ^= 1;
  }
}

// acc (64 x N) += A[:, :K] @ the next K / KS ring stages read as K-major
// B (KS = BWD_KW: 128-byte swizzled rows; BWD_KS: 64-byte), this
// warpgroup's box `boff` bytes into a stage. One stage's products stay in
// flight while the next stage's are issued; a warp frees a stage once its
// products on it have completed.
template <int N, int KS, int R>
__device__ __forceinline__ void ring_product_k(float (&acc)[R], const unsigned char* A, int K,
                                               Ring& rg, uint32_t boff) {
  const bool lead = threadIdx.x % 32 == 0;
  int prev = -1;
  fence_regs(acc);
  wgmma_fence();
  for (int k0 = 0; k0 < K; k0 += KS) {
    mbar_wait(&rg.full[rg.stage], rg.phase);
    const unsigned char* B = rg.base + rg.stage * FWD_STAGE_BYTES + boff;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16)
      wgmma_n<N, 0>(acc, a_desc(A, k0 + kk),
                    smem_desc(B + kk * 2, 16, 8 * KS * 2, KS == BWD_KW ? 1 : 2));
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && lead) mbar_arrive(&rg.empty[prev]);
    prev = rg.stage;
    ring_next(rg);
  }
  wgmma_wait<0>();
  if (prev >= 0 && lead) mbar_arrive(&rg.empty[prev]);
  fence_regs(acc);
}

// the g_z product of one injection over a pass of `nu` (1 or 2) units:
// acc[u] += A[:, :K] @ Wz_i^T rows of unit u, stages ordered (k, unit)
__device__ __forceinline__ void ring_product_z(float (&acc)[2][64], const unsigned char* A, int K,
                                               int nu, Ring& rg, uint32_t boff) {
  const bool lead = threadIdx.x % 32 == 0;
  int prev = -1;
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  wgmma_fence();
  for (int k0 = 0; k0 < K; k0 += BWD_KS) {
#pragma unroll
    for (int u = 0; u < 2; u++) {
      if (u >= nu) break;
      mbar_wait(&rg.full[rg.stage], rg.phase);
      const unsigned char* B = rg.base + rg.stage * FWD_STAGE_BYTES + boff;
      wgmma_n<128, 0>(acc[u], a_desc(A, k0), smem_desc(B, 16, 512, 2));
      wgmma_n<128, 0>(acc[u], a_desc(A, k0 + 16), smem_desc(B + 32, 16, 512, 2));
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && lead) mbar_arrive(&rg.empty[prev]);
      prev = rg.stage;
      ring_next(rg);
    }
  }
  wgmma_wait<0>();
  if (prev >= 0 && lead) mbar_arrive(&rg.empty[prev]);
  fence_regs(acc[0]);
  fence_regs(acc[1]);
}

// bf16(acc) into a K-major swizzled tile at columns col0 + ... (accumulator
// fragment: fwd_chain.cuh add_bias)
template <int R>
__device__ __forceinline__ void store_bf16(unsigned char* tile, const float (&x)[R], int col0,
                                           int r0, int q) {
#pragma unroll
  for (int j = 0; j < R / 4; j++) {
    const int c = col0 + 8 * j + 2 * q;
    *reinterpret_cast<__nv_bfloat162*>(tile + sw128_offset(r0, c)) =
        __floats2bfloat162_rn(x[4 * j], x[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(tile + sw128_offset(r0 + 8, c)) =
        __floats2bfloat162_rn(x[4 * j + 2], x[4 * j + 3]);
  }
}

// zero every element whose mask bit is clear
template <int R>
__device__ __forceinline__ void apply_mask(float (&x)[R], const uint32_t* mk, int mw, int col0,
                                           int r0, int q) {
#pragma unroll
  for (int j = 0; j < R / 4; j++) {
    const int c = col0 + 8 * j + 2 * q, sh = c & 31;
    const uint32_t a = mk[r0 * mw + (c >> 5)] >> sh, b = mk[(r0 + 8) * mw + (c >> 5)] >> sh;
    if (!(a & 1u)) x[4 * j] = 0.f;
    if (!(a & 2u)) x[4 * j + 1] = 0.f;
    if (!(b & 1u)) x[4 * j + 2] = 0.f;
    if (!(b & 2u)) x[4 * j + 3] = 0.f;
  }
}

// this warp's column sums of x (its 16 rows) into its partial row; a
// barrier over both warpgroups must come before flush_sums reads them
template <int R>
__device__ __forceinline__ void part_sums(const float (&x)[R], float* part, int H, int col0,
                                          int warp, int lane, int q) {
#pragma unroll
  for (int j = 0; j < R / 4; j++) {
    float a = x[4 * j] + x[4 * j + 2], b = x[4 * j + 1] + x[4 * j + 3];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane < 4) {
      float* d = part + (warp % 4) * H + col0 + 8 * j + 2 * q;
      d[0] = a;
      d[1] = b;
    }
  }
}

// the four warps' partial rows summed, one f32 atomic a column into dst
// (and dst2 when given)
__device__ __forceinline__ void flush_sums(const float* part, int H, float* dst, float* dst2) {
  for (int c = threadIdx.x; c < H; c += FWD_CONSUMERS) {
    const float v = part[c] + part[H + c] + part[2 * H + c] + part[3 * H + c];
    atomicAdd(dst + c, v);
    if (dst2 != nullptr) atomicAdd(dst2 + c, v);
  }
}

// rows of a cotangent slot (H wide, pre- or post-pool indexing) into a
// K-major swizzled A tile, zero past the points; four loads in flight a
// thread before their stores
__device__ __forceinline__ void load_g_tile(const BwdParams& p, unsigned char* T, const bf16* src, bool pre,
                            int H, int s, int p0) {
  const int chunks = H / 8;
  for (int e0 = threadIdx.x; e0 < FWD_ROWS * chunks; e0 += 4 * FWD_CONSUMERS) {
    int4 v[4];
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int e = e0 + i * FWD_CONSUMERS, r = e / chunks;
      const long long row = e < FWD_ROWS * chunks ? bwd_row(p, pre, s, p0, r) : -1;
      v[i] = make_int4(0, 0, 0, 0);
      if (row >= 0) v[i] = *reinterpret_cast<const int4*>(src + row * H + (e % chunks) * 8);
    }
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int e = e0 + i * FWD_CONSUMERS;
      if (e < FWD_ROWS * chunks)
        *reinterpret_cast<int4*>(T + sw128_offset(e / chunks, (e % chunks) * 8)) = v[i];
    }
  }
}

// V channels of one point's bf16 g_z from the swizzled GB tile (row r,
// pass column col, a multiple of V: 8 or 4 bytes within one 16-byte chunk)
template <int V>
__device__ __forceinline__ void gz_load(const unsigned char* GZ, int r, int col, float* g) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(GZ + sw128_offset(r, col));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    g[0] = a.x;
    g[1] = a.y;
    g[2] = b.x;
    g[3] = b.y;
  } else {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(GZ + sw128_offset(r, col)));
    g[0] = a.x;
    g[1] = a.y;
  }
}

// One warp item of the field's epilogue: the tile's nq points of view v
// (rows v * P + i, consecutive points of map s * ns + v) onto level l, for
// the 32 x V pass columns [cs, cs + 32 V) within [cs, ce). Lane i computes
// the taps of point q0 + i once (32 points at a time); the warp walks the
// points reading them by shuffle, sums w * g in registers while the tap
// base holds (consecutive samples of a ray) and flushes one reduction of V
// floats a lane and nonzero tap when it changes (scatter_accum.cuh:
// flush_run), as the standalone scatter's global units do.
template <int V>
__device__ __forceinline__ void level_run(const BwdParams& p, const unsigned char* GZ, int c0, int l, int cs,
                                          int ce, int v, int s, int p0, int nq) {
  const int lane = threadIdx.x % 32, P = p.pts, hf = p.lh[0], wf = p.lw[0];
  const int hn = p.lh[l], wn = p.lw[l], C = p.lc[l];
  const size_t map = (size_t)s * p.ns + v;
  const ScatterSeg seg = {p.grads[l] + map * hn * wn * C, hn, wn, C};  // what flush_run reads
  const int col = cs + lane * V;  // latent column
  const bool on = col < ce;
  const int ch = col - p.lc0[l];
  float acc[9][V];
#pragma unroll
  for (int t = 0; t < 9; t++)
#pragma unroll
    for (int i = 0; i < V; i++) acc[t][i] = 0.f;
  unsigned touched = 0;
  int cur = -1;
  for (int q0 = 0; q0 < nq; q0 += 32) {
    const int nb = min(32, nq - q0);
    int my_base = 0;
    float my_w[9];
    {
      float fx = 0.f, fy = 0.f;
      if (lane < nb) fine_coords(p.grid + (map * p.b + p0 + q0 + lane) * 2, hf, wf, &fx, &fy);
      int bx, by;
      float w[3][3];
      level_taps(fx, fy, hn, wn, hf, wf, &bx, &by, w);
      my_base = by * wn + bx;
#pragma unroll
      for (int t = 0; t < 9; t++) my_w[t] = lane < nb ? w[t / 3][t % 3] : 0.f;
    }
    for (int u = 0; u < nb; u += SC_LOADS) {
      float g[SC_LOADS][V];
#pragma unroll
      for (int k = 0; k < SC_LOADS; k++) {
        if (u + k < nb && on) {
          gz_load<V>(GZ, v * P + q0 + u + k, col - c0, g[k]);
        } else {
#pragma unroll
          for (int i = 0; i < V; i++) g[k][i] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < SC_LOADS; k++) {
        if (u + k >= nb) break;  // the same in every lane
        const int base = __shfl_sync(0xffffffffu, my_base, u + k);
        if (base != cur) {
          flush_run<3, V>(seg.grad, seg, cur, ch, on, acc, touched);
          cur = base;
        }
#pragma unroll
        for (int t = 0; t < 9; t++) {
          const float wt = __shfl_sync(0xffffffffu, my_w[t], u + k);
          touched |= (unsigned)(wt != 0.f) << t;
#pragma unroll
          for (int i = 0; i < V; i++) acc[t][i] = fmaf(wt, g[k][i], acc[t][i]);  // w * g exact
        }
      }
    }
  }
  flush_run<3, V>(seg.grad, seg, cur, ch, on, acc, touched);
}

// the field's epilogue: each row's bf16 g_z (staged in GB, latent columns
// [c0, c0 + ncols)) times its composed taps, added into the level gradients
// of its map (s, v). The warps share the items of every view and level:
// 32 x 4 columns an item where a level's channel count and offset allow
// 16-byte reductions, else 32 x 2 (any even count).
__device__ __forceinline__ void scatter_gz(const BwdParams& p, const unsigned char* GZ, int c0, int ncols, int s,
                           int p0) {
  const int warp = threadIdx.x / 32;
  const int nq = min(p.pts, p.b - p0);  // the points of each view's run
  int items = 0;  // a view's items
  for (int l = 0; l < p.nlev; l++) {
    const int lo = max(p.lc0[l], c0), hi = min(p.lc0[l] + p.lc[l], c0 + ncols);
    const int V = p.lc[l] % 4 == 0 && p.lc0[l] % 4 == 0 ? 4 : 2;
    if (lo < hi) items += (hi - lo + 32 * V - 1) / (32 * V);
  }
  for (int it = warp; it < p.ns * items; it += FWD_CONSUMERS / 32) {
    const int v = it / items;
    int k = it % items;
    for (int l = 0; l < p.nlev; l++) {
      const int lo = max(p.lc0[l], c0), hi = min(p.lc0[l] + p.lc[l], c0 + ncols);
      if (lo >= hi) continue;
      const bool v4 = p.lc[l] % 4 == 0 && p.lc0[l] % 4 == 0;
      const int span = v4 ? 128 : 64, groups = (hi - lo + span - 1) / span;
      if (k < groups) {
        if (v4) {
          level_run<4>(p, GZ, c0, l, lo + k * span, hi, v, s, p0, nq);
        } else {
          level_run<2>(p, GZ, c0, l, lo + k * span, hi, v, s, p0, nq);
        }
        break;
      }
      k -= groups;
    }
  }
}

template <int H, bool FIELD, bool F32>
__device__ __forceinline__ void bwd_consume(const BwdParams& p, const BwdSmem& m) {
  typedef BwdShape<H> S;
  constexpr int NX = S::NX, NH = S::NH, NSUB = S::NSUB;
  const int s = blockIdx.y, P = p.pts, p0 = blockIdx.x * P, ns = p.ns;
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * (warp % 4) + lane / 4, q = lane % 4;
  const int xc0 = wg * NX, mw = bwd_mask_words(H);
  const bool lead = lane == 0;
  Ring rg{m.ring, m.full, m.empty, 0, 0};
  uint32_t nga = 0, ngb = 0, nmask = 0;
  int cur = 0;  // partial-sum buffer
  auto mask_acquire = [&]() {
    const int i = nmask % BWD_MASKS;
    mbar_wait(&m.mfull[i], (nmask / BWD_MASKS) & 1);
    return m.masks + i * FWD_ROWS * mw;
  };
  auto mask_release = [&]() {
    if (lead) mbar_arrive(&m.mempty[nmask % BWD_MASKS]);
    nmask++;
  };
  auto ga_freed = [&]() {
    if (nga > 0) mbar_wait(m.ga_free, (nga - 1) & 1);
  };
  auto gb_freed = [&]() {
    if (ngb > 0) mbar_wait(m.gb_free, (ngb - 1) & 1);
  };

  // 1. gx = bf(g) @ W_out^T * [relu(x_final) > 0] as one k16 product: W_out
  //    as a K-major B tile in GA (row c, columns o < 16, zero past d_out),
  //    bf(g) as the A tile in GB (zero past d_out and the points); g in f32
  //    beside it for db_out, and its bf16 copy. Short loops, not unrolled
  //    code: this runs once a tile, and straight-line code there costs
  //    instruction fetches from an L2 the weight stream keeps busy.
  float gx[NX / 2];
  {
    const int d_out = p.d_out;
    float* gs = reinterpret_cast<float*>(m.GB + 8192);  // [64][GOUT_LD]
    // item e: half a row (8 columns) of W_out (e < 2H) or of g; every
    // load issued before the first store
    constexpr int ITEMS = (2 * H + 2 * FWD_ROWS + FWD_CONSUMERS - 1) / FWD_CONSUMERS;
    float v[ITEMS][8];
#pragma unroll
    for (int i = 0; i < ITEMS; i++) {
      const int e = tid + i * FWD_CONSUMERS, o0 = 8 * (e % 2);
      const bool wrow = e < 2 * H;
      const int r = wrow ? e / 2 : (e - 2 * H) / 2;
      const long long row = wrow ? 0 : bwd_row(p, false, s, p0, r);
#pragma unroll
      for (int t = 0; t < 8; t++) {
        const int o = o0 + t;
        v[i][t] = 0.f;
        if (o < d_out && wrow) v[i][t] = __bfloat162float(p.w_out[r * d_out + o]);
        if (o < d_out && !wrow && row >= 0 && r < FWD_ROWS) v[i][t] = p.g[row * d_out + o];
      }
    }
#pragma unroll
    for (int i = 0; i < ITEMS; i++) {
      const int e = tid + i * FWD_CONSUMERS, o0 = 8 * (e % 2);
      const bool wrow = e < 2 * H;
      const int r = wrow ? e / 2 : (e - 2 * H) / 2;
      if (r >= (wrow ? H : FWD_ROWS)) break;
      __align__(16) bf16 h[8];
#pragma unroll
      for (int t = 0; t < 8; t++) h[t] = __float2bfloat16(v[i][t]);
      *reinterpret_cast<int4*>((wrow ? m.GA : m.GB) + sw128_offset(r, o0)) =
          *reinterpret_cast<const int4*>(h);
      if (!wrow) {
        const long long row = bwd_row(p, false, s, p0, r);
#pragma unroll
        for (int t = 0; t < 8; t++) gs[r * GOUT_LD + o0 + t] = v[i][t];
        if (row >= 0)
          *reinterpret_cast<int4*>(p.gout + row * GOUT_LD + o0) = *reinterpret_cast<const int4*>(h);
      }
    }
    fence_async_smem();
    bar_sync(1, FWD_CONSUMERS);
    for (int o = tid; o < d_out; o += FWD_CONSUMERS) {
      float sum = 0.f;
      for (int r = 0; r < P; r++) sum += gs[r * GOUT_LD + o];
      atomicAdd(p.db_out + o, sum);
    }
#pragma unroll
    for (int i = 0; i < NX / 2; i++) gx[i] = 0.f;
    fence_regs(gx);
    wgmma_fence();
    wgmma_n<NX, 0>(gx, a_desc(m.GB, 0), smem_desc(m.GA + wg * NX * 128, 16, 1024, 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(gx);
    apply_mask(gx, mask_acquire(), mw, xc0, r0, q);
    mask_release();
    bar_sync(1, FWD_CONSUMERS);  // the operand tiles read before GA and GB are rewritten
  }

  // 2. the blocks, from the last
  for (int blk = p.n_blocks - 1; blk >= 0; blk--) {
    // G1 = bf(gx) into GA; db1 (and dbz of the injection whose input this is)
    ga_freed();
    store_bf16(m.GA, gx, xc0, r0, q);
    part_sums(gx, m.part + cur * 4 * H, H, xc0, warp, lane, q);
    fence_async_smem();
    bar_sync(1, FWD_CONSUMERS);
    hand_over(m.ga_ready);
    nga++;
    flush_sums(m.part + cur * 4 * H, H, p.db1 + (size_t)blk * H,
               blk + 1 < p.n_inj ? p.dbz + (size_t)(blk + 1) * H : nullptr);
    cur ^= 1;

    // gh1 = G1 @ W1^T * [relu(h1) > 0] into GB, a sub-chunk at a time; db0
    const uint32_t* mk = mask_acquire();
#pragma unroll
    for (int j = 0; j < NSUB; j++) {
      float h[NH / 2];
#pragma unroll
      for (int i = 0; i < NH / 2; i++) h[i] = 0.f;
      ring_product_k<NH, BWD_KW>(h, m.GA, H, rg, wg * NH * BWD_KW * 2);
      const int c0 = xc0 + j * NH;
      apply_mask(h, mk, mw, c0, r0, q);
      if (j == 0) gb_freed();
      store_bf16(m.GB, h, c0, r0, q);
      part_sums(h, m.part + cur * 4 * H, H, c0, warp, lane, q);
    }
    mask_release();
    fence_async_smem();
    bar_sync(1, FWD_CONSUMERS);
    hand_over(m.gb_ready);
    ngb++;
    flush_sums(m.part + cur * 4 * H, H, p.db0 + (size_t)blk * H, nullptr);
    cur ^= 1;

    // gx += G0 @ W0^T * [relu(block_in) > 0]
    mk = mask_acquire();
#pragma unroll
    for (int j = 0; j < NSUB; j++) {
      float t[NH / 2];
#pragma unroll
      for (int i = 0; i < NH / 2; i++) t[i] = 0.f;
      ring_product_k<NH, BWD_KW>(t, m.GB, H, rg, wg * NH * BWD_KW * 2);
      apply_mask(t, mk, mw, xc0 + j * NH, r0, q);
#pragma unroll
      for (int i = 0; i < NH / 2; i++) gx[j * NH / 2 + i] += t[i];
    }
    mask_release();

    if (blk == p.combine_layer && ns > 1) {
      // un-pool the view average through GA as f32 scratch: row v * P + pt
      // gets gx[pt] / NS, rows past NS * P or the points zero
      ga_freed();
      bar_sync(1, FWD_CONSUMERS);  // both warpgroups' products on GA done
      float* scr = reinterpret_cast<float*>(m.GA);
#pragma unroll
      for (int j = 0; j < NX / 8; j++) {
        const int c = xc0 + 8 * j + 2 * q;
        if (r0 < P) *reinterpret_cast<float2*>(scr + r0 * H + c) = make_float2(gx[4 * j], gx[4 * j + 1]);
        if (r0 + 8 < P)
          *reinterpret_cast<float2*>(scr + (r0 + 8) * H + c) = make_float2(gx[4 * j + 2], gx[4 * j + 3]);
      }
      bar_sync(1, FWD_CONSUMERS);
      for (int e = tid; e < P * H; e += FWD_CONSUMERS) scr[e] /= (float)ns;
      bar_sync(1, FWD_CONSUMERS);
      // row v * P + pt takes pooled row pt; rows past NS * P or the points 0
      const int s0 = r0 % P, s1 = (r0 + 8) % P;
      const float k0 = (r0 < ns * P && p0 + s0 < p.b) ? 1.f : 0.f;
      const float k1 = (r0 + 8 < ns * P && p0 + s1 < p.b) ? 1.f : 0.f;
#pragma unroll
      for (int j = 0; j < NX / 8; j++) {
        const int c = xc0 + 8 * j + 2 * q;
        const float2 a = *reinterpret_cast<const float2*>(scr + s0 * H + c);
        const float2 b = *reinterpret_cast<const float2*>(scr + s1 * H + c);
        gx[4 * j] = a.x * k0;
        gx[4 * j + 1] = a.y * k0;
        gx[4 * j + 2] = b.x * k1;
        gx[4 * j + 3] = b.y * k1;
      }
      bar_sync(1, FWD_CONSUMERS);  // scratch read before GA is rewritten
    }
  }

  // 3. Gin = bf(gx) into GB; db_in and dbz_0
  gb_freed();
  bar_sync(1, FWD_CONSUMERS);  // both warpgroups' W0^T products on GB done
  store_bf16(m.GB, gx, xc0, r0, q);
  part_sums(gx, m.part + cur * 4 * H, H, xc0, warp, lane, q);
  fence_async_smem();
  bar_sync(1, FWD_CONSUMERS);
  hand_over(m.gb_ready);
  ngb++;
  flush_sums(m.part + cur * 4 * H, H, p.db_in, p.n_inj > 0 ? p.dbz : nullptr);

  // 4. dxin = Gin @ W_in^T, 2 x BWD_IW columns a unit, from registers
  for (int u = 0; u < p.d_in_pad; u += 2 * BWD_IW) {
    float a[BWD_IW / 2];
#pragma unroll
    for (int i = 0; i < BWD_IW / 2; i++) a[i] = 0.f;
    ring_product_k<BWD_IW, BWD_KS>(a, m.GB, H, rg, wg * BWD_IW * BWD_KS * 2);
#pragma unroll
    for (int j = 0; j < BWD_IW / 8; j++) {
      const int c = u + wg * BWD_IW + 8 * j + 2 * q;
      if (c >= p.d_in) continue;
#pragma unroll
      for (int h = 0; h < 2; h++) {
        const long long row = bwd_row(p, true, s, p0, r0 + 8 * h);
        if constexpr (F32) {
          if (row >= 0)
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.dxin) + row * p.d_in + c) =
                make_float2(a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
        } else if (row >= 0)
          *reinterpret_cast<__nv_bfloat162*>(p.dxin + row * p.d_in + c) =
              __floats2bfloat162_rn(a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
      }
    }
  }

  // 5. g_z = [Gin | G1_0 | ...] @ Wz^T in passes of up to two units, then
  //    the dz copy or the level scatter from bf(g_z) staged in GB (F32: dz
  //    from the accumulators)
  const int DL = p.d_latent, units = (DL + 2 * BWD_ZW - 1) / (2 * BWD_ZW);
  for (int u0 = 0; u0 < units; u0 += 2) {
    const int nu = units - u0 < 2 ? units - u0 : 2;
    float zacc[2][64];
#pragma unroll
    for (int u = 0; u < 2; u++)
#pragma unroll
      for (int i = 0; i < 64; i++) zacc[u][i] = 0.f;
    for (int i = 0; i < p.n_inj; i++) {
      unsigned char* A = i % 2 == 0 ? m.GB : m.GA;
      if (u0 > 0 || i >= 2) {
        // reload the injection's cotangent: Gin, or G1_{i-1}, from its slot
        if (i % 2 == 0) gb_freed();
        else ga_freed();
        bar_sync(1, FWD_CONSUMERS);  // the products on A's last content done
        const bf16* src = i == 0 ? p.gin : cot_at(p, i - 1 < p.k, block_slot(p, i - 1, 0));
        load_g_tile(p, A, src, i == 0 || i - 1 < p.k, H, s, p0);
        fence_async_smem();
        bar_sync(1, FWD_CONSUMERS);
      }
      ring_product_z(zacc, A, H, nu, rg, wg * BWD_ZW * BWD_KS * 2);
    }
    if constexpr (F32) {
      // the float32 sums unrounded, from the accumulators (fragment as
      // store_bf16's): 8 bytes a thread and row, a quad's 32 bytes in a row
      const int c0 = u0 * 2 * BWD_ZW, ncols = min(DL - c0, nu * 2 * BWD_ZW);
      float* dz = reinterpret_cast<float*>(p.dz);
#pragma unroll
      for (int u = 0; u < 2; u++) {
        if (u >= nu) break;
#pragma unroll
        for (int j = 0; j < 16; j++) {
          const int c = u * 2 * BWD_ZW + wg * BWD_ZW + 8 * j + 2 * q;
          if (c >= ncols) continue;
#pragma unroll
          for (int h = 0; h < 2; h++) {
            const long long row = bwd_row(p, true, s, p0, r0 + 8 * h);
            if (row >= 0)
              *reinterpret_cast<float2*>(dz + row * DL + c0 + c) =
                  make_float2(zacc[u][4 * j + 2 * h], zacc[u][4 * j + 2 * h + 1]);
          }
        }
      }
      continue;  // GB untouched: the next pass's reloads wait on its own barriers
    }
    gb_freed();
    bar_sync(1, FWD_CONSUMERS);  // every product on GB and GA done
#pragma unroll
    for (int u = 0; u < 2; u++)
      if (u < nu) store_bf16(m.GB, zacc[u], u * 2 * BWD_ZW + wg * BWD_ZW, r0, q);
    bar_sync(1, FWD_CONSUMERS);
    const int c0 = u0 * 2 * BWD_ZW, ncols = min(DL - c0, nu * 2 * BWD_ZW);
    if constexpr (FIELD) {
      scatter_gz(p, m.GB, c0, ncols, s, p0);
    } else {
      const int chunks = ncols / 8;
      for (int e = tid; e < FWD_ROWS * chunks; e += FWD_CONSUMERS) {
        const int r = e / chunks, j = e % chunks;
        const long long row = bwd_row(p, true, s, p0, r);
        if (row >= 0)
          *reinterpret_cast<int4*>(p.dz + row * DL + c0 + j * 8) =
              *reinterpret_cast<const int4*>(m.GB + sw128_offset(r, j * 8));
      }
    }
    bar_sync(1, FWD_CONSUMERS);  // GB read before the next pass rewrites it
  }
}

// ---------------------------------------------------------------- copiers

// the valid rows of a swizzled tile to rows of `dst` (H wide), 16 bytes a
// copier thread
__device__ __forceinline__ void bwd_copy_out(const BwdParams& p, const unsigned char* tile, bool pre, bf16* dst,
                             int H, int s, int p0) {
  const int chunks = H / 8;
  for (int e = threadIdx.x - (FWD_THREADS - FWD_COPIERS); e < FWD_ROWS * chunks; e += FWD_COPIERS) {
    const int r = e / chunks, j = e % chunks;
    const long long row = bwd_row(p, pre, s, p0, r);
    if (row >= 0)
      __stcs(reinterpret_cast<int4*>(dst + row * H + j * 8),
             *reinterpret_cast<const int4*>(tile + sw128_offset(r, j * 8)));
  }
}

// bit c of word (r, c / 32): stash row r, column c > 0 (a relu'd bf16 is
// positive exactly when its bits, read as a signed 16-bit integer, are);
// rows past the points are zero. BWD_MASK_ITEMS words' loads in flight a
// thread (streaming loads: the stash is read once).
__device__ __forceinline__ uint32_t mask_bits(const int4 (&v)[4]) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(v);
  uint32_t bits = 0;
#pragma unroll
  for (int t = 0; t < 16; t++) {
    bits |= (uint32_t)((short)(u[t] & 0xffffu) > 0) << (2 * t);
    bits |= (uint32_t)((short)(u[t] >> 16) > 0) << (2 * t + 1);
  }
  return bits;
}

__device__ __forceinline__ void bwd_fill_mask(const BwdParams& p, const bf16* src, bool pre,
                                              uint32_t* mk, int H, int s, int p0) {
  const int words = H / 32, mw = bwd_mask_words(H), n = FWD_ROWS * words;
  for (int e0 = threadIdx.x - (FWD_THREADS - FWD_COPIERS); e0 < n; e0 += BWD_MASK_ITEMS * FWD_COPIERS) {
    int4 v[BWD_MASK_ITEMS][4];
#pragma unroll
    for (int i = 0; i < BWD_MASK_ITEMS; i++) {
      const int e = e0 + i * FWD_COPIERS;
      const long long row = e < n ? bwd_row(p, pre, s, p0, e / words) : -1;
      const int4* at = reinterpret_cast<const int4*>(src + row * H + (e % words) * 32);
#pragma unroll
      for (int t = 0; t < 4; t++) v[i][t] = row >= 0 ? __ldcs(at + t) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < BWD_MASK_ITEMS; i++) {
      const int e = e0 + i * FWD_COPIERS;
      if (e < n) mk[(e / words) * mw + e % words] = mask_bits(v[i]);
    }
  }
}

// The copier warps: every mask the consumers read, in their order, and every
// cotangent tile they hand over, to its slot. A tile or mask is released
// (one arrival a warp) once the warp's own copies are issued and fenced.
template <int H>
__device__ __forceinline__ void bwd_copy(const BwdParams& p, const BwdSmem& m) {
  const int s = blockIdx.y, p0 = blockIdx.x * p.pts, mw = bwd_mask_words(H);
  uint32_t nmask = 0, nga = 0, ngb = 0;
  auto release = [&](uint64_t* bar) {
    __threadfence_block();
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(bar);
  };
  auto mask = [&](const bf16* src, bool pre) {
    const int i = nmask % BWD_MASKS;
    mbar_wait(&m.mempty[i], ((nmask / BWD_MASKS) & 1) ^ 1);
    bwd_fill_mask(p, src, pre, m.masks + i * FWD_ROWS * mw, H, s, p0);
    release(&m.mfull[i]);
    nmask++;
  };
  auto block_masks = [&](int blk) {
    const bool pre = blk < p.k;
    mask(stash_at(p, pre, block_slot(p, blk, 1)), pre);  // relu(h1)
    mask(stash_at(p, pre, block_slot(p, blk, 0)), pre);  // relu(block_in)
  };
  mask(stash_at(p, false, 2 * (p.n_blocks - p.k)), false);  // relu(x_final)
  block_masks(p.n_blocks - 1);
  for (int blk = p.n_blocks - 1; blk >= 0; blk--) {
    const bool pre = blk < p.k;
    mbar_wait(m.ga_ready, nga++ & 1);
    bwd_copy_out(p, m.GA, pre, cot_at(p, pre, block_slot(p, blk, 0)), H, s, p0);
    release(m.ga_free);
    mbar_wait(m.gb_ready, ngb++ & 1);
    bwd_copy_out(p, m.GB, pre, cot_at(p, pre, block_slot(p, blk, 1)), H, s, p0);
    release(m.gb_free);
    if (blk > 0) block_masks(blk - 1);
  }
  mbar_wait(m.gb_ready, ngb & 1);
  bwd_copy_out(p, m.GB, true, p.gin, H, s, p0);
  release(m.gb_free);
}

// The whole tile: barriers, then the producer, copier and consumer roles.
template <int H, bool FIELD, bool F32>
__device__ __forceinline__ void run_bwd_chain(const BwdParams& p, const BwdMaps& maps) {
  extern __shared__ __align__(1024) unsigned char bwd_raw[];
  const BwdSmem m = bwd_smem(bwd_raw, H, p.d_latent);
  if (threadIdx.x == 0) {
    for (int i = 0; i < FWD_STAGES; i++) {
      mbar_init(&m.full[i], 1);
      mbar_init(&m.empty[i], FWD_CONSUMERS / 32);
    }
    for (int i = 0; i < BWD_MASKS; i++) {
      mbar_init(&m.mfull[i], FWD_COPIERS / 32);
      mbar_init(&m.mempty[i], FWD_CONSUMERS / 32);
    }
    mbar_init(m.ga_ready, FWD_CONSUMERS / 32);
    mbar_init(m.ga_free, FWD_COPIERS / 32);
    mbar_init(m.gb_ready, FWD_CONSUMERS / 32);
    mbar_init(m.gb_free, FWD_COPIERS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= FWD_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == FWD_CONSUMERS) bwd_produce<H>(p, maps, m.ring, m.full, m.empty);
    if (threadIdx.x >= FWD_THREADS - FWD_COPIERS) bwd_copy<H>(p, m);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    bwd_consume<H, FIELD, F32>(p, m);
  }
}
