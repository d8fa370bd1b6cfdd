// The layered ResnetFC path: one launch a product, for the widths the block
// chains (fwd_chain.cuh, bwd_chain.cuh) are not built for: hidden (or the
// padded d_in) past 512, whose f32 residual stream no longer fits the
// registers of two consumer warpgroups (64 rows x H/2 columns a warpgroup:
// 256 registers a thread at 1024), and more than 64 views, whose rows no
// longer fit one 64-row tile before the pooling.
//
// Replaces, at those widths, the same TPU kernels as the chains:
// pixelnerf_tpu/ops/resnetfc_pallas.py `_fwd_kernel`, `_fwd_stash_kernel`,
// `_bwd_kernel` (`_backward_tile`), and the ResnetFC part of
// pixelnerf_tpu/ops/field_pallas.py `_field_fwd_kernel` / `_field_bwd_kernel`
// (the field composes the pyramid gather and scatter of pyramid.cu around
// it). ops/layer_chain.py sequences the launches; each has a plain version
// there. bf(.) rounds to bf16, every product is f32-accumulated:
//
// 1. `layer_fwd`: v = bf(A) @ W + b for A (M, K) bf16 and W (K, N) bf16
//    row-major, then the epilogue:   v += x (add)   x = v (x given)
//    y = bf(relu(v)) or bf(v) (y given). The residual stream x is f32 in
//    device memory; y is the next product's operand and the stash slot.
// 2. `layer_bwd`: v = bf(A) @ W^T * [mask > 0] for W (N, K) row-major (the
//    weight as the forward reads it, so W^T's rows are W's), then the same
//    epilogue without relu and with the column sums of v added into an f32
//    vector (the bias gradients).
// 3. `view_pool_fwd`: the mean over the NS views at combine_layer, (SB, NS,
//    B, H) f32 to (SB, B, H), and bf(relu(mean)) into the next block's stash
//    slot (a stream at its bytes bound: the design is at the kernel);
//    `view_pool_bwd`: the broadcast of the cotangent / NS back over the
//    views, its bf16 copy (zero past C up to the copy's width) and its column
//    sums (per row-block sums, added in a fixed order by a second launch).
//    With NS = 1 it is also the copy bf(g) the weight gradients read.
// 4. The weight gradients: wgrad.cuh's grouped products and fixed-order
//    reduction, unchanged, on the cotangents the products wrote in the
//    chain's layout (`pnt_layer_wgrad`).
//
// Memory at hidden 1024 and bench.py's batch (a coarse query: 4 x 1024 rays
// x 64 samples x 2 views = 524,288 pre-pool rows): the f32 residual 2 GiB,
// each pre-pool bf16 stash slot 1 GiB (6 of them at combine_layer 3), each
// post-pool slot 0.5 GiB (5 of them).
//
// Bound on the H100: bytes. A block product at K = N = 1024 that adds into
// the residual does 2 MFLOP a row against 10-12 KB a row (bf16 A, the f32
// residual read and written, bf16 y where the next product reads it): under
// 210 FLOP a byte, below the card's ~295 ridge, so 1.6-1.9 ms of bytes at
// 3.35 TB/s against 1.1 ms of products at 989 TFLOP/s a call of 524,288
// rows; a stash forward's 15 products are bytes-bound in sum
// (chip_smoke.py's `layered` lines), and every product at 80 views and
// hidden 64 is the epilogue's bytes with a small product beside it. So the
// residual's round trip and the copies must stream while the tensor cores
// run, not after them.
//
// Design of the products (`layer_kernel<BN, WT>`), five warpgroups:
// - A persistent grid: each CTA keeps one N tile of BN columns (64 where N
//   <= 64, else 128) and walks row tiles of 128 rows, a 64-bit walk; the
//   CTAs of one row slot hold consecutive N tiles (N tiles fastest), so the
//   CTAs that share an A row tile run together and read it from L2. About
//   one CTA an SM (the row slots fill the SMs in whole N-tile groups).
// - Warpgroup 2, one producer thread: a ring of 4 (BN 128) or 6 (BN 64)
//   stages kept full through TMA on mbarriers, a 128-row x 64-K box of A
//   and the W box of the CTA's columns, both with the 128-byte swizzle; TMA
//   zero-fills K past its end (48, 16) and rows past M. W (K, N) is read as
//   MN-major wgmma B (tnspB = 1, 64-column boxes), W (N, K) as K-major B
//   (tnspB = 0).
// - Warpgroups 0-1, MMA: `wgmma` m64nBNk16, 64 rows each, a stage freed once
//   the next stage's products are in flight; at a tile's end the f32
//   accumulators go to a padded staging tile in shared memory, and the MMA
//   warpgroups start the next tile. They never wait on device memory.
// - Warpgroups 3-4, epilogue: each thread finishes 8-column chunks of fixed
//   columns (the bias loaded once: a CTA's columns never change). It loads
//   half a tile's residual and mask rows ahead with 16-byte loads (the
//   first half while the tile's K loop still runs), reads the staged
//   accumulators, applies bias, mask and residual, and stores x and y 16
//   bytes at a time; the stores drain while the MMA warpgroups run the next
//   tile. Two mbarriers hand the staging tile back and forth. Strides off
//   16 bytes (never on the path) and a ragged last chunk of `cols` take
//   element accesses.
// - Column sums: each epilogue thread sums its chunk's columns over every
//   row it finishes; at the end the CTA adds its threads' sums in a fixed
//   order into its own workspace row, and `layer_colsum` (a second launch)
//   adds each column's CTA rows in slot order into the vector. No atomics:
//   the bias gradients are bit-identical from run to run.
// - BN stays at most 128: the staging tile of 128 x 128 f32 (68 KB with its
//   padding) and a 4-stage ring of 32 KB fill shared memory; a 256-wide
//   tile would need twice the staging and 48 KB stages.
// Two earlier drafts ran slower at hidden 512 and 1024 and no faster at
// 80 views (PERF.md, PR 16): the MMA warpgroups finishing their own tiles
// (the residual prefetched in their registers; the stores' drain then
// holds the tensor cores idle), and the same with x and y leaving by TMA
// stores from shared memory.

#include "wgrad.cuh"

#define LC_BM 128           // rows of a tile: two MMA warpgroups of 64
#define LC_BK 64            // K columns of a ring stage (one 128-byte row)
#define LC_MMA 256          // the two MMA warpgroups' threads (0-255)
#define LC_EPI0 384         // the epilogue's first thread, after the producer warpgroup
#define LC_EPILOGUE 256     // the two epilogue warpgroups' threads
#define LC_THREADS (LC_EPI0 + LC_EPILOGUE)
#define LC_PAD 8            // floats of padding a staging row (no bank conflicts)

template <int BN>
struct LcShape {
  static_assert(BN == 64 || BN == 128, "N tiles of 64 or 128 columns");
  static constexpr int STAGES = BN == 64 ? 6 : 4;
  static constexpr int A_BYTES = LC_BM * LC_BK * 2;  // 16 KB
  static constexpr int W_BYTES = BN * LC_BK * 2;     // 8 or 16 KB
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int SP = BN + LC_PAD;             // staging row pitch, floats
  static constexpr int CH = BN / 8;                  // 8-column chunks a row
  static constexpr int RPT = LC_EPILOGUE / CH;       // rows the epilogue finishes at once
  static constexpr int P = LC_BM / RPT;              // chunks a thread finishes a tile
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * STAGE + (size_t)LC_BM * SP * 4 + (2 * STAGES + 2) * 8;
};

struct LayerParams {
  CUtensorMap a_map;    // A (M, K): boxes of 64 K x 128 rows
  CUtensorMap w_map;    // W (K, N): 64 N x 64 K; W (N, K): 64 K x BN rows
  const float* bias;    // (N) or null
  const bf16* mask;     // (M, ldm) or null: v *= [mask > 0]
  float* x;             // (M, ldx) f32 or null
  bf16* y;              // (M, ldy) bf16 or null
  float* ws;            // (grid, BN) column sums a CTA, or null
  long long row_tiles;
  int m, n, k, ldm, ldx, ldy, cols, add_x, relu_y;
  int ntn, slots;       // N tiles, row slots (grid = slots * ntn)
  int vx, vy, vm;       // x, y, mask rows take 16-byte vectors
};

__device__ __forceinline__ void lc_tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0, int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

template <int BN, int TB, int R>
__device__ __forceinline__ void lc_mma(float (&d)[R], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_n128<TB>(d, da, db);
  else wgmma_n64<TB>(d, da, db);
}

// The producer thread: every tile's A and W boxes, K box by K box.
template <int BN, int WT>
__device__ __forceinline__ void lc_produce(const LayerParams& p, unsigned char* ring,
                                           uint64_t* full, uint64_t* empty) {
  typedef LcShape<BN> S;
  const uint64_t stream = l2_evict_normal(), keep = l2_evict_last();
  const int n0 = (int)(blockIdx.x % p.ntn) * BN, kb = (p.k + LC_BK - 1) / LC_BK;
  int stage = 0;
  uint32_t phase = 0;
  for (long long rt = blockIdx.x / p.ntn; rt < p.row_tiles; rt += p.slots) {
    const int m0 = (int)(rt * LC_BM);
    for (int b = 0; b < kb; b++) {
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_expect_tx(&full[stage], S::STAGE);
      unsigned char* st = ring + stage * S::STAGE;
      lc_tma_2d(st, &p.a_map, &full[stage], b * LC_BK, m0, stream);
      if constexpr (WT) {
        lc_tma_2d(st + S::A_BYTES, &p.w_map, &full[stage], b * LC_BK, n0, keep);
      } else {
#pragma unroll
        for (int j = 0; j < BN / 64; j++)
          lc_tma_2d(st + S::A_BYTES + j * 8192, &p.w_map, &full[stage], n0 + 64 * j, b * LC_BK,
                    keep);
      }
      if (++stage == S::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// The residual's 8 columns [col, col + 8) of `row` (zeros where not added)
__device__ __forceinline__ void lc_load_x(const LayerParams& p, int row, int col, float (&r)[8]) {
#pragma unroll
  for (int e = 0; e < 8; e++) r[e] = 0.f;
  if (p.add_x && row < p.m) {
    const float* src = p.x + (size_t)row * p.ldx + col;
    if (p.vx && col + 8 <= p.cols) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(src));
      const float4 b = __ldcs(reinterpret_cast<const float4*>(src) + 1);
      r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w, r[4] = b.x, r[5] = b.y, r[6] = b.z,
      r[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; e++)
        if (col + e < p.cols) r[e] = src[e];
    }
  }
}

// The mask's 8 columns [col, col + 8) of `row` as 8 bf16 bit patterns
__device__ __forceinline__ uint4 lc_load_mask(const LayerParams& p, int row, int col) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (p.mask && row < p.m) {
    const bf16* src = p.mask + (size_t)row * p.ldm + col;
    if (p.vm && col + 8 <= p.cols) {
      r = __ldcs(reinterpret_cast<const uint4*>(src));
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; e++)
        if (col + e < p.cols) w[e / 2] |= (uint32_t)__bfloat16_as_ushort(src[e]) << (16 * (e % 2));
      r = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  return r;
}

__device__ __forceinline__ uint32_t lc_word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

__device__ __forceinline__ uint32_t lc_pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return (uint32_t)__bfloat16_as_ushort(h.x) | ((uint32_t)__bfloat16_as_ushort(h.y) << 16);
}

// Warpgroups 0-1 (MMA): each tile's products into registers, then, once
// the epilogue has read the last tile's, the accumulators into the staging
// tile. They never touch device memory.
template <int BN, int WT>
__device__ __forceinline__ void lc_mma_role(const LayerParams& p, unsigned char* ring, float* stg,
                                            uint64_t* full, uint64_t* empty, uint64_t* sfull,
                                            uint64_t* sfree) {
  typedef LcShape<BN> S;
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const bool lead = lane == 0;
  const int kb = (p.k + LC_BK - 1) / LC_BK;
  // the accumulator fragment of m64nBN: register 4j + {0,1} row r0, columns
  // 8j + 2q + {0,1}; 4j + {2,3} row r0 + 8
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4, q = lane % 4;
  int stage = 0;
  uint32_t phase = 0, t = 0;
  for (long long rt = blockIdx.x / p.ntn; rt < p.row_tiles; rt += p.slots, t++) {
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; i++) acc[i] = 0.f;
    int prev = -1;
    for (int b = 0; b < kb; b++) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = ring + stage * S::STAGE;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < LC_BK; kk += 16) {
        const uint64_t da = a_desc(st + wg * 8192, kk);
        if constexpr (WT)
          lc_mma<BN, 0>(acc, da, smem_desc(st + S::A_BYTES + kk * 2, 16, 1024, 1));
        else
          lc_mma<BN, 1>(acc, da, smem_desc(st + S::A_BYTES + kk * 128, 8192, 1024, 1));
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (prev >= 0 && lead) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == S::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0 && lead) mbar_arrive(&empty[prev]);
    mbar_wait(sfree, (t & 1) ^ 1);  // the epilogue has read the last tile
#pragma unroll
    for (int j = 0; j < BN / 8; j++)
#pragma unroll
      for (int h = 0; h < 2; h++)
        *reinterpret_cast<float2*>(stg + (r0 + 8 * h) * S::SP + 8 * j + 2 * q) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    mbar_arrive(sfull);  // every thread's writes, released to the epilogue
  }
}

// Warpgroups 3-4 (epilogue): each tile's 8-column chunks of fixed columns,
// half a tile's residual and mask rows loaded ahead at a time (the first
// half while the MMA warpgroups still run the tile's K loop), finished from
// the staging tile and stored 16 bytes at a time; then the CTA's column
// sums into its workspace row.
template <int BN>
__device__ __forceinline__ void lc_epilogue(const LayerParams& p, float* stg, uint64_t* sfull,
                                            uint64_t* sfree) {
  typedef LcShape<BN> S;
  constexpr int H = S::P / 2;  // chunks a thread loads ahead at once
  const int et = threadIdx.x - LC_EPI0;
  const int n0 = (int)(blockIdx.x % p.ntn) * BN;
  // this thread's chunk: columns [col, col + 8) of rows rr + RPT * i
  const int c = et % S::CH, rr = et / S::CH, col = n0 + 8 * c;
  const int sw = (c >> 2) & 1;  // which half of the chunk it reads first
  float bias[8], cs[8];
#pragma unroll
  for (int e = 0; e < 8; e++) {
    bias[e] = p.bias && col + e < p.n ? p.bias[col + e] : 0.f;
    cs[e] = 0.f;
  }
  uint32_t t = 0;
  for (long long rt = blockIdx.x / p.ntn; rt < p.row_tiles; rt += p.slots, t++) {
    const int m0 = (int)(rt * LC_BM);
#pragma unroll
    for (int half = 0; half < 2; half++) {
      float xr[H][8];
      uint4 mr[H];
#pragma unroll
      for (int i = 0; i < H; i++) {
        const int row = m0 + rr + (half * H + i) * S::RPT;
        lc_load_x(p, row, col, xr[i]);
        mr[i] = lc_load_mask(p, row, col);
      }
      if (half == 0) mbar_wait(sfull, t & 1);  // the tile's accumulators are staged
#pragma unroll
      for (int i = 0; i < H; i++) {
        const int lr = rr + (half * H + i) * S::RPT, row = m0 + lr;
        const float* sr = stg + lr * S::SP + 8 * c;
        const float4 f0 = *reinterpret_cast<const float4*>(sr + 4 * sw);
        const float4 f1 = *reinterpret_cast<const float4*>(sr + 4 - 4 * sw);
        const float4 lo = sw ? f1 : f0, hi = sw ? f0 : f1;
        float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int e = 0; e < 8; e++) {
          if (p.bias) v[e] = v[e] + bias[e];
          if (p.mask) {
            const uint32_t bits = (lc_word(mr[i], e / 2) >> (16 * (e % 2))) << 16;
            v[e] = v[e] * (__uint_as_float(bits) > 0.f ? 1.f : 0.f);
          }
          if (p.add_x) v[e] = xr[i][e] + v[e];
        }
        if (row >= p.m) continue;
        const bool whole = col + 8 <= p.cols;
        if (p.x) {
          float* xd = p.x + (size_t)row * p.ldx + col;
          if (p.vx && whole) {
            reinterpret_cast<float4*>(xd)[0] = make_float4(v[0], v[1], v[2], v[3]);
            reinterpret_cast<float4*>(xd)[1] = make_float4(v[4], v[5], v[6], v[7]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; e++)
              if (col + e < p.cols) xd[e] = v[e];
          }
        }
        if (p.y) {
          float u[8];
#pragma unroll
          for (int e = 0; e < 8; e++) u[e] = p.relu_y ? fmaxf(v[e], 0.f) : v[e];
          bf16* yd = p.y + (size_t)row * p.ldy + col;
          if (p.vy && whole) {
            *reinterpret_cast<uint4*>(yd) =
                make_uint4(lc_pack(u[0], u[1]), lc_pack(u[2], u[3]), lc_pack(u[4], u[5]),
                           lc_pack(u[6], u[7]));
          } else {
#pragma unroll
            for (int e = 0; e < 8; e++)
              if (col + e < p.cols) yd[e] = __float2bfloat16(u[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < 8; e++) cs[e] += v[e];
      }
    }
    mbar_arrive(sfree);  // this thread's reads of the staging tile are done
  }
  if (p.ws == nullptr) return;
  // the CTA's column sums: its threads' sums of a column in row order (the
  // MMA warpgroups are done with the staging tile once its last tile is read)
  bar_sync(1, LC_EPILOGUE);
#pragma unroll
  for (int e = 0; e < 8; e++) stg[rr * BN + 8 * c + e] = cs[e];
  bar_sync(1, LC_EPILOGUE);
  if (et < BN) {
    float s = 0.f;
    for (int r = 0; r < S::RPT; r++) s += stg[r * BN + et];
    p.ws[(size_t)blockIdx.x * BN + et] = s;
  }
}

template <int BN, int WT>
__global__ void __launch_bounds__(LC_THREADS, 1) layer_kernel(const __grid_constant__ LayerParams p) {
  typedef LcShape<BN> S;
  extern __shared__ __align__(1024) unsigned char lc_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(lc_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* stg = reinterpret_cast<float*>(ring + S::STAGES * S::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + LC_BM * S::SP);
  uint64_t* empty = full + S::STAGES;
  uint64_t* sfull = empty + S::STAGES;
  uint64_t* sfree = sfull + 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; i++) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], LC_MMA / 32);
    }
    mbar_init(sfull, LC_MMA);
    mbar_init(sfree, LC_EPILOGUE);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int role = threadIdx.x / 128;  // 0-1 MMA, 2 producer, 3-4 epilogue
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == LC_MMA) lc_produce<BN, WT>(p, ring, full, empty);
  } else if (role < 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 104;\n");
    lc_mma_role<BN, WT>(p, ring, stg, full, empty, sfull, sfree);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n");
    lc_epilogue<BN>(p, stg, sfull, sfree);
  }
}

// colsum[c] += the CTAs' sums of column c, in row-slot order
__global__ void __launch_bounds__(256) layer_colsum(const float* ws, float* colsum, int cols,
                                                    int bn, int ntn, int slots) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int nt = c / bn, j = c % bn;
  float s = 0.f;
  for (int i = 0; i < slots; i++) s += ws[((size_t)i * ntn + nt) * bn + j];
  colsum[c] += s;
}

// The launch plan of a product: N tile, N tiles, row slots, grid, row tiles.
struct LayerPlan {
  int bn, ntn, slots, grid;
  long long row_tiles;
};

static inline LayerPlan layer_plan(int m, int n, int sms) {
  LayerPlan l;
  l.bn = n <= 64 ? 64 : 128;
  l.ntn = (n + l.bn - 1) / l.bn;
  l.row_tiles = ((long long)m + LC_BM - 1) / LC_BM;
  long long slots = sms / l.ntn;
  if (slots > l.row_tiles) slots = l.row_tiles;
  l.slots = (int)(slots > 0 ? slots : 1);
  l.grid = l.slots * l.ntn;
  return l;
}

// a row-major bf16 matrix (rows, inner) with rows `ld` elements apart, in
// boxes of box_inner x box_rows with the 128-byte swizzle; past the edges
// reads zeros
static inline int lc_map(CUtensorMap* map, const void* base, int inner, int ld, int rows,
                         int box_inner, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                          strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, int WT>
static inline int layer_launch(const LayerParams& p, int grid, cudaStream_t stream) {
  typedef LcShape<BN> S;
  cudaError_t err = cudaFuncSetAttribute(layer_kernel<BN, WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err != cudaSuccess) return (int)err;
  layer_kernel<BN, WT><<<grid, LC_THREADS, S::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// view_pool_fwd: out[s, p, :] = (the sum of x[s, v, p, :] over v = 0..NS-1,
// added in view order from 0) / NS; y = bf(relu(out)). Bound: bytes (x read
// once, out and y written once, one add a float read; no products), so the
// design keeps HBM busy and enough bytes in flight:
// - An item is 8 consecutive columns of one post-pool row: two 16-byte
//   streaming loads a view (`__ldcs`: x is read once), two 16-byte stores of
//   out and one of y's 8 bf16 (left cached: the next product reads y). An
//   item off 16 bytes (a pointer, or rows of x and out off 16 bytes; y's
//   rows off 16 bytes) or ragged (the last of a row where H % 8 != 0) takes
//   element accesses in the same kernel.
// - A 1-D grid of 256-thread blocks over the items (no grid.y, which stops
//   at 65,535); a thread finds its row, (s, p) and columns once, never in
//   the view loop, and issues the loads of VP_GROUP views before adding any.
//   The views are added in order from 0, so out and y are bit-equal to a
//   plain loop over the views in order. With 16-byte loads of VP_GROUP
//   views in flight the stream fills the card from about one block an SM
//   (80 views at hidden 64 and 6,552 rows: 205 blocks).
#define VP_THREADS 256
#define VP_GROUP 4  // views whose loads are in flight before any is added

struct PoolParams {
  const float* x;    // (SB, NS, B, H)
  float* out;        // (SB * B, H)
  bf16* y;           // (SB * B, H) or null
  long long items;   // rows x chunks
  int ns, b, h, chunks;
  int vx, vo, vy;    // x, out, y take 16-byte accesses
};

// x's columns [col, col + 8) of one row, zeros past `left` columns
__device__ __forceinline__ void vp_load(const float* src, bool vec, int left, float (&r)[8]) {
  if (vec && left >= 8) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(src));
    const float4 c = __ldcs(reinterpret_cast<const float4*>(src) + 1);
    r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w, r[4] = c.x, r[5] = c.y, r[6] = c.z,
    r[7] = c.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; e++) r[e] = e < left ? __ldcs(src + e) : 0.f;
  }
}

__global__ void __launch_bounds__(VP_THREADS) view_pool_fwd_kernel(const PoolParams p) {
  const long long item = (long long)blockIdx.x * VP_THREADS + threadIdx.x;
  if (item >= p.items) return;
  const long long row = item / p.chunks;
  const int col = (int)(item - row * p.chunks) * 8, left = p.h - col;
  const long long s = row / p.b, pt = row - s * p.b;
  const size_t view = (size_t)p.b * p.h;  // floats between two views of a row
  const float* src = p.x + ((size_t)s * p.ns * p.b + pt) * p.h + col;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; e++) acc[e] = 0.f;
  for (int v = 0; v < p.ns; v += VP_GROUP) {
    float r[VP_GROUP][8];
#pragma unroll
    for (int g = 0; g < VP_GROUP; g++)
      if (v + g < p.ns) vp_load(src + (v + g) * view, p.vx, left, r[g]);
#pragma unroll
    for (int g = 0; g < VP_GROUP; g++)
      if (v + g < p.ns) {
#pragma unroll
        for (int e = 0; e < 8; e++) acc[e] += r[g][e];
      }
  }
  float m[8];
#pragma unroll
  for (int e = 0; e < 8; e++) m[e] = acc[e] / (float)p.ns;
  float* od = p.out + row * p.h + col;
  if (p.vo && left >= 8) {
    reinterpret_cast<float4*>(od)[0] = make_float4(m[0], m[1], m[2], m[3]);
    reinterpret_cast<float4*>(od)[1] = make_float4(m[4], m[5], m[6], m[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; e++)
      if (e < left) od[e] = m[e];
  }
  if (p.y == nullptr) return;
  bf16* yd = p.y + row * p.h + col;
  if (p.vy && left >= 8) {
    *reinterpret_cast<uint4*>(yd) =
        make_uint4(lc_pack(fmaxf(m[0], 0.f), fmaxf(m[1], 0.f)), lc_pack(fmaxf(m[2], 0.f), fmaxf(m[3], 0.f)),
                   lc_pack(fmaxf(m[4], 0.f), fmaxf(m[5], 0.f)), lc_pack(fmaxf(m[6], 0.f), fmaxf(m[7], 0.f)));
  } else {
#pragma unroll
    for (int e = 0; e < 8; e++)
      if (e < left) yd[e] = __float2bfloat16(fmaxf(m[e], 0.f));
  }
}

// view_pool_bwd: for g (SB, B, C) f32, v = g / ns broadcast over the views:
// gx (SB, NS, B, C) f32 = v (if given), y (SB, NS, B, ldy) = bf(v), zero at
// columns C..ldy-1. A block: 32 columns x 8 row lanes, rows (s, p) strided
// over blockIdx.y. With ws, the block's sums of v (its row lanes' in lane
// order) go to its row blockIdx.y of ws (row blocks, C), which
// view_pool_colsum then adds into colsum in a fixed order: no atomics, so
// the column sums are bit-identical from run to run.
__global__ void __launch_bounds__(256) view_pool_bwd_kernel(const float* g, float* gx, bf16* y,
                                                            float* ws, int sb, int ns, int b,
                                                            int cc, int ldy) {
  __shared__ float part[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int width = y ? ldy : cc;
  const long long rows = (long long)sb * b;
  float sum = 0.f;
  if (c < width) {
    for (long long r = (long long)blockIdx.y * 8 + threadIdx.y; r < rows;
         r += (long long)gridDim.y * 8) {
      const long long s = r / b, pt = r % b;
      const float v = c < cc ? g[r * cc + c] / (float)ns : 0.f;
      for (int vw = 0; vw < ns; vw++) {
        const long long o = (s * ns + vw) * b + pt;
        if (gx && c < cc) gx[o * cc + c] = v;
        if (y) y[o * ldy + c] = __float2bfloat16(v);
        sum += v;
      }
    }
  }
  if (!ws) return;
  part[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && c < cc) {
    float t = 0.f;
    for (int i = 0; i < 8; i++) t += part[i][threadIdx.x];
    ws[(size_t)blockIdx.y * cc + c] = t;
  }
}

// colsum[c] += the row blocks' sums of column c (ws (blocks, cols), one row
// a row block of view_pool_bwd_kernel) in a fixed order: lane l of 32 adds
// row blocks l, l + 32, ... in order, then lane 0 adds the lanes' sums in
// lane order. A block: 32 columns x 32 lanes (the 4,096 row blocks of a
// long backward in 128 loads a thread: layer_colsum's one thread a column
// would walk them all).
__global__ void __launch_bounds__(1024) view_pool_colsum(const float* __restrict__ ws,
                                                         float* __restrict__ colsum, int cols,
                                                         int blocks) {
  __shared__ float part[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < cols) {
#pragma unroll 8
    for (int i = threadIdx.y; i < blocks; i += 32) s += ws[(size_t)i * cols + c];
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = 0.f;
    for (int l = 0; l < 32; l++) t += part[l][threadIdx.x];
    colsum[c] += t;
  }
}

static int lc_row_blocks(long long rows) {
  long long blocks = (rows + 63) / 64;
  return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

extern "C" {

// The plan pnt_layer launches for ints (as pnt_layer's) on the current
// device: out = N tile, N tiles, row slots, grid, workspace floats (grid x
// N tile, for the column sums), row tiles.
int pnt_layer_plan(const int* ints, int* out) {
  int sms = 0;
  const int rc = wgrad_sms(&sms);
  if (rc) return rc;
  const LayerPlan l = layer_plan(ints[0], ints[1], sms);
  out[0] = l.bn;
  out[1] = l.ntn;
  out[2] = l.slots;
  out[3] = l.grid;
  out[4] = l.grid * l.bn;
  out[5] = (int)l.row_tiles;
  return 0;
}

// ptrs: a, w, bias, mask, x, y, colsum, ws (null where unused; ws, of
// pnt_layer_plan's floats, where colsum is given); ints: m, n, k, lda, ldw,
// ldm, ldx, ldy, cols, add_x, relu_y. wt: 0 launches layer_fwd (W (K, N)),
// 1 layer_bwd (W (N, K), the product with W^T). K, N and the leading dims
// of A and W must be multiples of 8 elements and A and W start on 16
// bytes (TMA's rows); returns cudaGetLastError() or cudaErrorInvalidValue.
// With colsum (and M, cols > 0) a second launch, layer_colsum, adds the
// column sums.
int pnt_layer(void* const* ptrs, const int* ints, int wt, void* stream) {
  LayerParams p;
  memset(&p, 0, sizeof(p));
  const void* a = ptrs[0];
  const void* w = ptrs[1];
  p.bias = static_cast<const float*>(ptrs[2]);
  p.mask = static_cast<const bf16*>(ptrs[3]);
  p.x = static_cast<float*>(ptrs[4]);
  p.y = static_cast<bf16*>(ptrs[5]);
  float* colsum = static_cast<float*>(ptrs[6]);
  p.ws = colsum ? static_cast<float*>(ptrs[7]) : nullptr;
  p.m = ints[0];
  p.n = ints[1];
  p.k = ints[2];
  const int lda = ints[3], ldw = ints[4];
  p.ldm = ints[5];
  p.ldx = ints[6];
  p.ldy = ints[7];
  p.cols = ints[8];
  p.add_x = ints[9];
  p.relu_y = ints[10];
  const auto on16 = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (p.k % 8 || p.n % 8 || lda % 8 || ldw % 8 || !on16(a) || !on16(w) || p.cols > p.n ||
      p.m < 0 || p.k <= 0 || (colsum && !p.ws))
    return (int)cudaErrorInvalidValue;
  if (p.m == 0) return 0;
  p.vx = p.x && p.ldx % 4 == 0 && on16(p.x);
  p.vy = p.y && p.ldy % 8 == 0 && on16(p.y);
  p.vm = p.mask && p.ldm % 8 == 0 && on16(p.mask);
  int sms = 0;
  int rc = wgrad_sms(&sms);
  if (rc) return rc;
  const LayerPlan l = layer_plan(p.m, p.n, sms);
  p.ntn = l.ntn;
  p.slots = l.slots;
  p.row_tiles = l.row_tiles;
  rc = lc_map(&p.a_map, a, p.k, lda, p.m, LC_BK, LC_BM);
  if (!rc)
    rc = wt ? lc_map(&p.w_map, w, p.k, ldw, p.n, LC_BK, l.bn) : lc_map(&p.w_map, w, p.n, ldw, p.k, 64, LC_BK);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l.bn == 64)
    rc = wt ? layer_launch<64, 1>(p, l.grid, s) : layer_launch<64, 0>(p, l.grid, s);
  else
    rc = wt ? layer_launch<128, 1>(p, l.grid, s) : layer_launch<128, 0>(p, l.grid, s);
  if (rc || colsum == nullptr || p.cols == 0) return rc;
  layer_colsum<<<(p.cols + 255) / 256, 256, 0, s>>>(p.ws, colsum, p.cols, l.bn, l.ntn, l.slots);
  return (int)cudaGetLastError();
}

// view_pool_fwd: x (sb, ns, b, h) f32 -> xo (sb, b, h) f32 and, if y is
// not null, y (sb, b, h) bf16 = bf(relu(xo)), the views added in order. Any
// h and any start: vector accesses where aligned, element ones otherwise.
int pnt_view_pool_fwd(const void* x, void* xo, void* y, int sb, int ns, int b, int h,
                      void* stream) {
  if (sb < 0 || b < 0 || ns < 1 || h < 1) return (int)cudaErrorInvalidValue;
  PoolParams p;
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(xo);
  p.y = static_cast<bf16*>(y);
  p.ns = ns;
  p.b = b;
  p.h = h;
  p.chunks = (h + 7) / 8;
  p.items = (long long)sb * b * p.chunks;
  if (p.items == 0) return 0;
  const auto on16 = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  p.vx = h % 4 == 0 && on16(x);
  p.vo = h % 4 == 0 && on16(xo);
  p.vy = h % 8 == 0 && on16(y);
  const long long blocks = (p.items + VP_THREADS - 1) / VP_THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  view_pool_fwd_kernel<<<(unsigned)blocks, VP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The floats of view_pool_bwd's column-sum workspace: a row of c a row block.
long long pnt_view_pool_bwd_workspace(int sb, int b, int c) {
  return (long long)lc_row_blocks((long long)sb * b) * (c > 0 ? c : 0);
}

// view_pool_bwd: g (sb, b, c) f32 -> gx (sb, ns, b, c) f32 = g / ns (if not
// null), y (sb, ns, b, ldy) bf16 (if not null), colsum (c) += sums (if not
// null: ws holds pnt_view_pool_bwd_workspace's floats, and a second launch,
// view_pool_colsum, adds the row blocks' sums in a fixed order).
int pnt_view_pool_bwd(const void* g, void* gx, void* y, void* colsum, void* ws, int sb, int ns,
                      int b, int c, int ldy, void* stream) {
  const long long rows = (long long)sb * b;
  if (rows <= 0) return 0;
  const bool sums = colsum != nullptr && c > 0;
  if (sums && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int width = y ? ldy : c, blocks = lc_row_blocks(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((width + 31) / 32, blocks);
  view_pool_bwd_kernel<<<grid, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(g), static_cast<float*>(gx), static_cast<bf16*>(y),
      sums ? static_cast<float*>(ws) : nullptr, sb, ns, b, c, ldy);
  const int rc = (int)cudaGetLastError();
  if (rc || !sums) return rc;
  view_pool_colsum<<<(c + 31) / 32, dim3(32, 32), 0, s>>>(static_cast<const float*>(ws),
                                                          static_cast<float*>(colsum), c, blocks);
  return (int)cudaGetLastError();
}

// wgrad.cuh's products and reduction on the layered path's cotangents.
// dims as bwd_dims (the workspace: pnt_wgrad_workspace). ptrs: z
// (sb*ns*b, d_latent), xin_pad (.., d_in_pad), spre, spost, gpre, gpost,
// gin, gout (sb*b, gout_ld), dw_in, dwz, dw0, dw1, dw_out, ws.
// Gradients are added to; launched[0] += the kernels launched.
int pnt_layer_wgrad(void* const* ptrs, const int* dims, int gout_ld, void* stream, int* launched) {
  BwdParams p = {};
  bwd_dims(&p, dims);
  p.z = static_cast<const bf16*>(ptrs[0]);
  p.spre = static_cast<const bf16*>(ptrs[2]);
  p.spost = static_cast<const bf16*>(ptrs[3]);
  p.gpre = static_cast<bf16*>(ptrs[4]);
  p.gpost = static_cast<bf16*>(ptrs[5]);
  p.gin = static_cast<bf16*>(ptrs[6]);
  p.gout = static_cast<bf16*>(ptrs[7]);
  if (p.hidden % 64 || p.d_latent % 8 || p.d_in_pad % 8 || gout_ld % 8 || gout_ld < p.d_out)
    return (int)cudaErrorInvalidValue;
  return wgrad_launch(p, static_cast<const bf16*>(ptrs[1]), static_cast<float*>(ptrs[13]),
                      static_cast<float*>(ptrs[8]), static_cast<float*>(ptrs[9]),
                      static_cast<float*>(ptrs[10]), static_cast<float*>(ptrs[11]),
                      static_cast<float*>(ptrs[12]), static_cast<cudaStream_t>(stream), launched,
                      gout_ld);
}

}  // extern "C"
