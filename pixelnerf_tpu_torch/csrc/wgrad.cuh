// The ResnetFC backward's weight-gradient products on Hopper, from the
// forward's bf16 stash and the cotangents the chain wrote (bwd_chain.cuh):
// one grouped launch of every product, then one fixed-order reduction.
//
// Replaces the weight-gradient sums of the TPU kernels: the `_dot_g`
// products of resnetfc_pallas.py `_backward_tile`, summed over
// `_fused_bwd_impl`'s sequential grid, and the same sums in field_pallas.py
// `_field_bwd_kernel`. Per backward call (bf(.) rounds to bf16; every
// operand is bf16 in device memory, every sum f32):
//   dw_out   = relu(x_f)^T bf(g)                        (H x d_out)
//   dw1_i    = relu(h1_i)^T G1_i, dw0_i = relu(bin_i)^T G0_i   (H x H)
//   dwz      = z^T [Gin | G1_0 | ... | G1_{n_inj-2}]     (DL x n_inj*H, one
//              packed product as the TPU kernel's, z read once a column tile)
//   dw_in    = xin^T Gin                                  (d_in x H)
// Each is D (ka x n) = A^T G over the point axis: A (M, ka) and G (M, n)
// row-major in device memory, the point axis being the products' K.
//
// Bound on the H100: operations. At the flagship shapes (bench.py's batch,
// hidden 512) the products are ~7.6 TFLOP a cached train step, 7.70 ms at
// 989 TFLOP/s, against ~8 GB of operands read once; bf16 torch.matmul runs
// the same 15 products at ~690 TFLOP/s (PERF.md).
//
// Design, against the split-K wmma kernel this replaces (64x64 tiles fed
// by thread loads with a barrier a step, f32 atomics, 15 launches a call):
// - A row-major (points, cols) matrix is the MN-major operand layout for
//   both sides of A^T G, so wgmma reads A and G straight from TMA boxes
//   (transposed A and B, tnspA = tnspB = 1): 64 points x 64 columns, the
//   128-byte swizzle, one tensor map a stash or cotangent array (its slots
//   the third coordinate; columns and points past the edge read as zeros).
// - A CTA owns a unit: a 128 (ka) x 256 (n) output tile of one product over
//   one split of the point axis. Two consumer warpgroups each hold 64 x 256
//   f32 accumulators (m64n256k16; n128 or n64 where fewer columns are
//   left); one producer thread keeps a 4-stage ring of 48 KB stages full
//   (each a 64-point A box a warpgroup and up to four G boxes).
// - Every product's units go into one launch; the host plans the splits so
//   that the units fill the SMs in whole waves and each carries about the
//   same number of points (post-pool products get half the splits).
// - Determinism: each unit stores its f32 partial tile with plain stores
//   into a workspace slot of its own; `wgrad_reduce` then sums each output
//   element's splits in split order and adds the sum into the gradient.
//   Two runs on the same inputs give bit-identical weight gradients.
#pragma once

#include <string.h>

#include "bwd_chain.cuh"

#define WG_THREADS 384      // two consumer warpgroups and a producer warpgroup
#define WG_CONSUMERS 256
#define WG_STAGES 4
#define WG_PTS 64           // points a ring stage (K of four k16 products)
#define WG_BK 128           // output rows (A columns) of a unit
#define WG_BN 256           // output columns (G columns) of a unit
#define WG_BOX 8192         // one 64-point x 64-column bf16 box
#define WG_STAGE_BYTES (6 * WG_BOX)  // two A boxes and four G boxes
#define WG_MAX_PRODUCTS 32
#define WG_UNIT_STEPS 16    // a unit's fill, drain and store, in ring steps (the planner's cost)
#define WG_MAX_WAVES 8      // at most this many waves of units (the workspace grows with them)

// the operand arrays, one tensor map each
enum { WG_SPRE, WG_SPOST, WG_GPRE, WG_GPOST, WG_Z, WG_XIN, WG_GIN, WG_GOUT, WG_MAPS };

// One weight gradient: D (ka x n) = A^T G over m points, added to `out`
// at element (r, c) -> (c / seg) * ka * seg + r * seg + c % seg.
struct WgProduct {
  float* out;
  long long ws;        // its first float in the workspace: splits x ka x n
  int a_map, a_slot;   // A's map and slot
  int g_map, g_slot;   // G's; g_map < 0: the packed injection cotangents
  int m, ka, n, seg;
  int tiles_n, splits, rows, unit0;  // rows: points a split, a multiple of WG_PTS
};

struct WgradParams {
  CUtensorMap maps[WG_MAPS];
  WgProduct prod[WG_MAX_PRODUCTS];
  float* ws;
  long long elems;     // output elements of all products
  int n_prod, units, hidden, k;
};

__host__ __device__ inline int wg_tiles(const WgProduct& q) {
  return (q.ka + WG_BK - 1) / WG_BK * q.tiles_n;
}

// The products of one backward call, in launch order, and the split plan
// for `sms` SMs; the workspace's floats. Pointers may be null (a query).
static inline long long wgrad_plan(WgradParams* w, const BwdParams& p, float* dw_in, float* dwz,
                                   float* dw0, float* dw1, float* dw_out, int sms) {
  const int H = p.hidden, k = p.k, m = p.n_blocks - p.k;
  const int mpre = p.sb * p.ns * p.b, mpost = p.sb * p.b;
  w->n_prod = 0;
  w->hidden = H;
  w->k = k;
  auto add = [&](int a_map, int a_slot, int g_map, int g_slot, int rows, int ka, int n, int seg,
                 float* out) {
    WgProduct& q = w->prod[w->n_prod++];
    q = WgProduct{out, 0, a_map, a_slot, g_map, g_slot, rows, ka, n, seg,
                  (n + WG_BN - 1) / WG_BN, 1, 0, 0};
  };
  if (2 * p.n_blocks + 3 > WG_MAX_PRODUCTS) return -1;
  const size_t hh = (size_t)H * H;
  // dwz_i = z^T Gin_i, Gin_0 = gin and Gin_i = G1_{i-1} (bwd_chain.cuh)
  add(WG_Z, 0, -1, 0, mpre, p.d_latent, p.n_inj * H, H, dwz);
  for (int pass = 0; pass < 2; pass++) {
    // the pre-pool blocks first, dw_in after them, then the post-pool ones
    for (int blk = 0; blk < p.n_blocks; blk++) {
      const bool pre = blk < k;
      if (pre != (pass == 0)) continue;
      const int rows = pre ? mpre : mpost, am = pre ? WG_SPRE : WG_SPOST;
      const int gm = pre ? WG_GPRE : WG_GPOST;
      const int rx = pre ? blk : blk - k, rh = pre ? k + blk : m + blk - k;
      add(am, rh, gm, rx, rows, H, H, H, dw1 ? dw1 + blk * hh : nullptr);
      add(am, rx, gm, rh, rows, H, H, H, dw0 ? dw0 + blk * hh : nullptr);
    }
    if (pass == 0) add(WG_XIN, 0, WG_GIN, 0, mpre, p.d_in, H, H, dw_in);
  }
  add(WG_SPOST, 2 * m, WG_GOUT, 0, mpost, H, p.d_out, p.d_out, dw_out);

  // Splits: units of about `steps` ring steps each; the step count that
  // fills whole waves of `sms` units best, a unit's fixed cost included.
  long long total = 0;
  for (int i = 0; i < w->n_prod; i++) {
    const WgProduct& q = w->prod[i];
    total += (long long)wg_tiles(q) * ((q.m + WG_PTS - 1) / WG_PTS);
  }
  long long best_cost = -1, best_steps = 1;
  for (int waves = 1; waves <= WG_MAX_WAVES; waves++) {
    const long long steps = total > 0 ? (total + (long long)waves * sms - 1) / (waves * sms) : 1;
    long long units = 0, longest = 0;
    for (int i = 0; i < w->n_prod; i++) {
      const WgProduct& q = w->prod[i];
      const long long qs = (q.m + WG_PTS - 1) / WG_PTS;
      const long long sp = qs > 0 ? (qs + steps - 1) / steps : 1;
      const long long per = sp > 0 ? (qs + sp - 1) / sp : 0;
      units += wg_tiles(q) * sp;
      longest = per > longest ? per : longest;
    }
    const long long cost = (units + sms - 1) / sms * (longest + WG_UNIT_STEPS);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_steps = steps;
    }
  }
  long long ws = 0;
  int units = 0;
  w->elems = 0;
  for (int i = 0; i < w->n_prod; i++) {
    WgProduct& q = w->prod[i];
    const int qs = (q.m + WG_PTS - 1) / WG_PTS;
    const int sp = qs > 0 ? (int)((qs + best_steps - 1) / best_steps) : 1;
    q.rows = (qs + sp - 1) / sp * WG_PTS;
    if (q.rows == 0) q.rows = WG_PTS;
    q.splits = q.m > 0 ? (q.m + q.rows - 1) / q.rows : 1;
    q.unit0 = units;
    units += wg_tiles(q) * q.splits;
    q.ws = ws;
    ws += ((long long)q.splits * q.ka * q.n + 3) / 4 * 4;
    w->elems += (long long)q.ka * q.n;
  }
  w->units = units;
  return ws;
}

// A unit's product, output tile and points.
struct WgUnit {
  int prod, ka0, n0, m0, steps;
};

__device__ __forceinline__ WgUnit wg_unit(const WgradParams& p, int u) {
  WgUnit t;
  t.prod = 0;
  while (t.prod + 1 < p.n_prod && u >= p.prod[t.prod + 1].unit0) t.prod++;
  const WgProduct& q = p.prod[t.prod];
  const int local = u - q.unit0, tiles = wg_tiles(q);
  // tiles innermost: the units that run together read the same points
  const int tile = local % tiles, split = local / tiles;
  t.ka0 = tile / q.tiles_n * WG_BK;
  t.n0 = tile % q.tiles_n * WG_BN;
  t.m0 = split * q.rows;
  const int m1 = min(q.m, t.m0 + q.rows);
  t.steps = m1 > t.m0 ? (m1 - t.m0 + WG_PTS - 1) / WG_PTS : 0;
  return t;
}

// The producer thread: every unit's A and G boxes, step by step, into the
// ring. Warpgroup w's A box (columns ka0 + 64w) is loaded while those
// columns exist, G's 64-column boxes while theirs do.
__device__ __forceinline__ void wg_produce(const WgradParams& p, unsigned char* ring,
                                           uint64_t* full, uint64_t* empty) {
  const uint64_t policy = l2_evict_normal();
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const WgUnit t = wg_unit(p, u);
    const WgProduct& q = p.prod[t.prod];
    const int na = t.ka0 + 64 < q.ka ? 2 : 1;
    const int ng = min(4, (q.n - t.n0 + 63) / 64);
    for (int s = 0; s < t.steps; s++) {
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_expect_tx(&full[stage], (uint32_t)(na + ng) * WG_BOX);
      unsigned char* st = ring + stage * WG_STAGE_BYTES;
      const int row = t.m0 + s * WG_PTS;
      for (int a = 0; a < na; a++)
        tma_load_3d(st + a * WG_BOX, &p.maps[q.a_map], &full[stage], t.ka0 + 64 * a, row,
                    q.a_slot, policy);
      for (int j = 0; j < ng; j++) {
        const int c = t.n0 + 64 * j;
        int map = q.g_map, slot = q.g_slot, col = c;
        if (map < 0) {
          // packed injection cotangents: column block c lies in injection i
          const int i = c / p.hidden;
          col = c % p.hidden;
          map = i == 0 ? WG_GIN : i - 1 < p.k ? WG_GPRE : WG_GPOST;
          slot = i == 0 ? 0 : i - 1 < p.k ? i - 1 : i - 1 - p.k;
        }
        tma_load_3d(st + (2 + j) * WG_BOX, &p.maps[map], &full[stage], col, row, slot, policy);
      }
      if (++stage == WG_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// D (64 x NW) += A^T G, both operands MN-major in the ring's boxes
template <int NW, int R>
__device__ __forceinline__ void wg_mma(float (&acc)[R], uint64_t da, uint64_t db) {
  static_assert(R == NW / 2, "accumulator size");
  if constexpr (NW == 256) wgmma_n256<1, 1>(acc, da, db);
  else if constexpr (NW == 128) wgmma_n128<1, 1>(acc, da, db);
  else wgmma_n64<1, 1>(acc, da, db);
}

// One warpgroup's part of a unit: its 64 output rows x NW columns over the
// unit's steps, then its partial tile into the unit's workspace slot. Each
// warp frees a stage once the products that read it have completed: the
// next stage's products are issued first. A warpgroup whose rows do not
// exist (its A box was not loaded) runs the products all the same and
// stores nothing: wgmma under a branch on the thread index would be
// serialized.
template <int NW>
__device__ __forceinline__ void wg_consume(const WgradParams& p, const WgUnit& t,
                                           unsigned char* ring, uint64_t* full, uint64_t* empty,
                                           int& stage, uint32_t& phase) {
  const WgProduct& q = p.prod[t.prod];
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool lead = lane == 0;
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; i++) acc[i] = 0.f;
  int prev = -1;
  for (int s = 0; s < t.steps; s++) {
    mbar_wait(&full[stage], phase);
    const unsigned char* st = ring + stage * WG_STAGE_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_PTS / 16; kk++)
      wg_mma<NW>(acc, smem_desc(st + wg * WG_BOX + kk * 2048, WG_BOX, 1024, 1),
                 smem_desc(st + 2 * WG_BOX + kk * 2048, WG_BOX, 1024, 1));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (prev >= 0 && lead) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == WG_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (prev >= 0 && lead) mbar_arrive(&empty[prev]);
  if (t.ka0 + 64 * wg >= q.ka) return;
  // fragment of m64nNW: register 4j + {0,1} row r0, columns 8j + 2q + {0,1};
  // 4j + {2,3} row r0 + 8
  const int r0 = 16 * (warp % 4) + lane / 4, qd = lane % 4;
  const int split = t.m0 / q.rows;
  float* slot = p.ws + q.ws + (long long)split * q.ka * q.n;
#pragma unroll
  for (int j = 0; j < NW / 8; j++) {
    const int c = t.n0 + 8 * j + 2 * qd;
    if (c >= q.n) continue;
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int r = t.ka0 + 64 * wg + r0 + 8 * h;
      if (r >= q.ka) continue;
      float* d = slot + (long long)r * q.n + c;
      if (q.n % 2 == 0) {
        *reinterpret_cast<float2*>(d) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        d[0] = acc[4 * j + 2 * h];
        if (c + 1 < q.n) d[1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
    wgrad_products(const __grid_constant__ WgradParams p) {
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_STAGES * WG_STAGE_BYTES);
  uint64_t* empty = full + WG_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < WG_STAGES; i++) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= WG_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == WG_CONSUMERS) wg_produce(p, ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const WgUnit t = wg_unit(p, u);
    const int left = p.prod[t.prod].n - t.n0;
    if (left > 128) wg_consume<256>(p, t, ring, full, empty, stage, phase);
    else if (left > 64) wg_consume<128>(p, t, ring, full, empty, stage, phase);
    else wg_consume<64>(p, t, ring, full, empty, stage, phase);
  }
}

// Each output element: its splits summed in split order, added into the
// gradient (one thread an element: no atomics, the same sum every run).
__global__ void __launch_bounds__(256) wgrad_reduce(const __grid_constant__ WgradParams p) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < p.elems;
       e += (long long)gridDim.x * blockDim.x) {
    int i = 0;
    long long r = e;
    while ((long long)p.prod[i].ka * p.prod[i].n <= r) {
      r -= (long long)p.prod[i].ka * p.prod[i].n;
      i++;
    }
    const WgProduct& q = p.prod[i];
    const long long kn = (long long)q.ka * q.n;
    const float* src = p.ws + q.ws + r;
    float sum = 0.f;
    for (int s = 0; s < q.splits; s++) sum += src[s * kn];
    const int row = (int)(r / q.n), col = (int)(r % q.n);
    q.out[(long long)(col / q.seg) * q.ka * q.seg + (long long)row * q.seg + col % q.seg] += sum;
  }
}

static inline size_t wgrad_smem_bytes() {
  return 1024 + (size_t)WG_STAGES * WG_STAGE_BYTES + 2 * WG_STAGES * 8;
}

// tensor map over `slots` row-major (rows, cols) bf16 matrices `ld`
// elements a row, one after the other, in boxes of 64 points x 64 columns
// (128-byte swizzle); points and columns past the edge read as zeros
static inline int operand_map(CUtensorMap* map, const void* base, int cols, int ld, int rows,
                              int slots) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)slots};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)rows * ld * 2};
  const cuuint32_t box[3] = {64, WG_PTS, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                          strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

static inline int wgrad_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// Launch the products and the reduction on `stream`: the chain's
// cotangents (p.gpre, ...), the stash, z and `xin_pad` (xin's columns
// padded to d_in_pad, rows of a multiple of 16 bytes as TMA needs) in;
// the f32 gradients added to. `ws` holds the workspace floats that
// wgrad_plan gives; gout's rows are gout_ld columns (GOUT_LD from the
// chain, d_out padded to 16 from the layered path). Adds each kernel
// launched to *launched.
static inline int wgrad_launch(const BwdParams& p, const bf16* xin_pad, float* ws, float* dw_in,
                               float* dwz, float* dw0, float* dw1, float* dw_out,
                               cudaStream_t stream, int* launched, int gout_ld = GOUT_LD) {
  int sms = 0;
  int rc = wgrad_sms(&sms);
  if (rc) return rc;
  WgradParams w;
  if (wgrad_plan(&w, p, dw_in, dwz, dw0, dw1, dw_out, sms) < 0) return (int)cudaErrorInvalidValue;
  w.ws = ws;
  const int H = p.hidden, k = p.k, m = p.n_blocks - p.k;
  const int mpre = p.sb * p.ns * p.b, mpost = p.sb * p.b;
  memset(w.maps, 0, sizeof(w.maps));
  if (k) rc = operand_map(&w.maps[WG_SPRE], p.spre, H, H, mpre, 2 * k);
  if (!rc && k) rc = operand_map(&w.maps[WG_GPRE], p.gpre, H, H, mpre, 2 * k);
  if (!rc) rc = operand_map(&w.maps[WG_SPOST], p.spost, H, H, mpost, 2 * m + 1);
  if (!rc) rc = operand_map(&w.maps[WG_GPOST], p.gpost, H, H, mpost, 2 * m);
  if (!rc) rc = operand_map(&w.maps[WG_Z], p.z, p.d_latent, p.d_latent, mpre, 1);
  if (!rc) rc = operand_map(&w.maps[WG_XIN], xin_pad, p.d_in_pad, p.d_in_pad, mpre, 1);
  if (!rc) rc = operand_map(&w.maps[WG_GIN], p.gin, H, H, mpre, 1);
  if (!rc) rc = operand_map(&w.maps[WG_GOUT], p.gout, gout_ld, gout_ld, mpost, 1);
  if (rc) return rc;
  const size_t smem = wgrad_smem_bytes();
  cudaError_t err =
      cudaFuncSetAttribute(wgrad_products, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wgrad_products<<<w.units, WG_THREADS, smem, stream>>>(w);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  (*launched)++;
  long long blocks = (w.elems + 255) / 256;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  wgrad_reduce<<<(int)(blocks > 0 ? blocks : 1), 256, 0, stream>>>(w);
  rc = (int)cudaGetLastError();
  if (!rc) (*launched)++;
  return rc;
}

// The widths of a call (dims: sb, ns, b, d_latent, d_in, d_in_pad, hidden,
// d_out, n_blocks, combine_layer) and what follows from them.
static inline void bwd_dims(BwdParams* p, const int* dims) {
  p->sb = dims[0];
  p->ns = dims[1];
  p->b = dims[2];
  p->d_latent = dims[3];
  p->d_in = dims[4];
  p->d_in_pad = dims[5];
  p->hidden = dims[6];
  p->d_out = dims[7];
  p->n_blocks = dims[8];
  p->combine_layer = dims[9];
  p->pts = chain_points(p->ns);
  p->n_inj = p->combine_layer < p->n_blocks ? p->combine_layer : p->n_blocks;
  p->k = p->ns > 1 ? p->n_inj : 0;
}

extern "C" {

// The weight-gradient workspace of a call with these dims (as
// pnt_resnetfc_bwd's and pnt_layer_wgrad's), in floats, on the current
// device; info gets the units of the products' launch, the most and fewest
// splits of a product and the bytes of the TMA boxes the launch loads. -1
// if the call has more blocks than the products take.
long long pnt_wgrad_workspace(const int* dims, long long* info) {
  BwdParams p = {};
  bwd_dims(&p, dims);
  int sms = 0;
  if (wgrad_sms(&sms)) return -1;
  WgradParams w;
  const long long ws = wgrad_plan(&w, p, nullptr, nullptr, nullptr, nullptr, nullptr, sms);
  if (ws < 0) return -1;
  info[0] = w.units;
  info[1] = info[2] = w.prod[0].splits;
  info[3] = 0;
  for (int i = 0; i < w.n_prod; i++) {
    const WgProduct& q = w.prod[i];
    info[1] = q.splits > info[1] ? q.splits : info[1];
    info[2] = q.splits < info[2] ? q.splits : info[2];
    // every tile loads its A boxes and G boxes once a 64-point step
    long long boxes = 0;
    for (int ka0 = 0; ka0 < q.ka; ka0 += WG_BK)
      for (int n0 = 0; n0 < q.n; n0 += WG_BN)
        boxes += (ka0 + 64 < q.ka ? 2 : 1) + (q.n - n0 >= WG_BN ? 4 : (q.n - n0 + 63) / 64);
    info[3] += boxes * ((q.m + WG_PTS - 1) / WG_PTS) * WG_BOX;
  }
  return ws;
}

}  // extern "C"
