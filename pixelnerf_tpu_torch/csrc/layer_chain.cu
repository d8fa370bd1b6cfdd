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
//    vector (the bias gradients: f32 atomics, one a column and warp).
// 3. `view_pool_fwd`: the mean over the NS views at combine_layer, (SB, NS,
//    B, H) f32 to (SB, B, H), and bf(relu(mean)) into the next block's stash
//    slot; `view_pool_bwd`: the broadcast of the cotangent / NS back over the
//    views, its bf16 copy (zero past C up to the copy's width) and its column
//    sums. With NS = 1 it is also the copy bf(g) the weight gradients read.
// 4. The weight gradients: wgrad.cuh's grouped products and fixed-order
//    reduction, unchanged, on the cotangents the products wrote in the
//    chain's layout (`pnt_layer_wgrad`).
//
// Memory at hidden 1024 and bench.py's batch (a coarse query: 4 x 1024 rays
// x 64 samples x 2 views = 524,288 pre-pool rows): the f32 residual 2 GiB,
// each pre-pool bf16 stash slot 1 GiB (6 of them at combine_layer 3), each
// post-pool slot 0.5 GiB (5 of them).
//
// Bound on the H100: a block product at K = N = 1024 that adds into the
// residual does 2 MFLOP a row against ~12 KB a row (bf16 A, the f32
// residual read and written, bf16 y): 170 FLOP a byte, under the card's
// ~295 ridge, so bytes at 3.35 TB/s; one without the residual (fc_0's,
// ~4 KB a row) is operations-bound at 989 TFLOP/s. A stash forward's 15
// products at bench.py's batch are bytes-bound in sum (chip_smoke.py's
// `layered` lines), and so is every product at 80 views and hidden 64.
// The pooling and its backward move bytes only.
//
// Design (simple and right first; making it fast is later work): 128 x 128
// output tiles on a 1-D grid, N tiles fastest (the CTAs that share an A row
// tile run together, and any row count below 2^31 launches: a grid's y axis
// would stop at 65,535 row tiles, 8.4M rows), a CTA of eight warps, each
// warp 64 x 32 of m16n8k16
// `mma.sync` products from `ldmatrix` fragments (`.trans` for the (K, N)
// weight), K in steps of 32 through a 3-stage `cp.async` ring with padded
// rows (no bank conflicts for ldmatrix). Edges are zero-filled by the
// copies (K and N multiples of 8) and masked in the epilogue.

#include "wgrad.cuh"

#define LC_BM 128
#define LC_BN 128
#define LC_BK 32
#define LC_THREADS 256
#define LC_STAGES 3
#define LC_LD (LC_BK + 8)   // row of the A tile and of the (N, K) weight tile
#define LC_LDB (LC_BN + 8)  // row of the (K, N) weight tile

struct LayerParams {
  const bf16* a;        // (M, lda)
  const bf16* w;        // (K, ldw) for layer_fwd, (N, ldw) for layer_bwd
  const float* bias;    // (N) or null
  const bf16* mask;     // (M, ldm) or null: v *= [mask > 0]
  float* x;             // (M, ldx) f32 or null
  bf16* y;              // (M, ldy) bf16 or null
  float* colsum;        // (cols) or null: += column sums of v
  int m, n, k, lda, ldw, ldm, ldx, ldy, cols, add_x, relu_y;
};

__device__ __forceinline__ void lc_cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void lc_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void lc_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool TRANS>
__device__ __forceinline__ void lc_ldm4(uint32_t (&r)[4], const bf16* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void lc_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// WT: the weight is (N, K) row-major (layer_bwd's W^T), else (K, N)
template <bool WT>
__device__ __forceinline__ void lc_load(const LayerParams& p, bf16* As, bf16* Ws, int stage,
                                        int k0, int m0, int n0) {
  const int tid = threadIdx.x;
  bf16* A = As + stage * LC_BM * LC_LD;
#pragma unroll
  for (int i = tid; i < LC_BM * (LC_BK / 8); i += LC_THREADS) {
    const int r = i / (LC_BK / 8), c = i % (LC_BK / 8) * 8;
    const bool ok = m0 + r < p.m && k0 + c < p.k;
    lc_cp16(A + r * LC_LD + c, ok ? p.a + (size_t)(m0 + r) * p.lda + k0 + c : p.a, ok);
  }
  if constexpr (WT) {
    bf16* W = Ws + stage * LC_BN * LC_LD;
#pragma unroll
    for (int i = tid; i < LC_BN * (LC_BK / 8); i += LC_THREADS) {
      const int r = i / (LC_BK / 8), c = i % (LC_BK / 8) * 8;
      const bool ok = n0 + r < p.n && k0 + c < p.k;
      lc_cp16(W + r * LC_LD + c, ok ? p.w + (size_t)(n0 + r) * p.ldw + k0 + c : p.w, ok);
    }
  } else {
    bf16* W = Ws + stage * LC_BK * LC_LDB;
#pragma unroll
    for (int i = tid; i < LC_BK * (LC_BN / 8); i += LC_THREADS) {
      const int r = i / (LC_BN / 8), c = i % (LC_BN / 8) * 8;
      const bool ok = k0 + r < p.k && n0 + c < p.n;
      lc_cp16(W + r * LC_LDB + c, ok ? p.w + (size_t)(k0 + r) * p.ldw + n0 + c : p.w, ok);
    }
  }
}

template <bool WT>
__device__ __forceinline__ void layer_tile(const LayerParams& p) {
  extern __shared__ __align__(16) unsigned char lc_raw[];
  bf16* As = reinterpret_cast<bf16*>(lc_raw);
  bf16* Ws = As + LC_STAGES * LC_BM * LC_LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int ntn = (p.n + LC_BN - 1) / LC_BN;
  const int m0 = (int)(blockIdx.x / ntn) * LC_BM, n0 = (int)(blockIdx.x % ntn) * LC_BN;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; i++)
#pragma unroll
    for (int j = 0; j < 4; j++)
#pragma unroll
      for (int e = 0; e < 4; e++) acc[i][j][e] = 0.f;

  const int ktiles = (p.k + LC_BK - 1) / LC_BK;
#pragma unroll
  for (int s = 0; s < LC_STAGES - 1; s++) {
    if (s < ktiles) lc_load<WT>(p, As, Ws, s, s * LC_BK, m0, n0);
    lc_commit();
  }
  for (int kt = 0; kt < ktiles; kt++) {
    lc_wait<LC_STAGES - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1's stage
    const int nk = kt + LC_STAGES - 1;
    if (nk < ktiles) lc_load<WT>(p, As, Ws, nk % LC_STAGES, nk * LC_BK, m0, n0);
    lc_commit();
    const int st = kt % LC_STAGES;
    const bf16* A = As + st * LC_BM * LC_LD;
#pragma unroll
    for (int kk = 0; kk < LC_BK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; mi++)
        lc_ldm4<false>(af[mi], A + (wm * 64 + mi * 16 + lane % 16) * LC_LD + kk + lane / 16 * 8);
#pragma unroll
      for (int nj = 0; nj < 2; nj++) {
        const int nb = wn * 32 + nj * 16;
        if constexpr (WT)
          lc_ldm4<false>(bfr[nj], Ws + st * LC_BN * LC_LD +
                                      (nb + lane % 8 + lane / 16 * 8) * LC_LD + kk +
                                      (lane / 8) % 2 * 8);
        else
          lc_ldm4<true>(bfr[nj], Ws + st * LC_BK * LC_LDB +
                                     (kk + lane % 8 + (lane / 8) % 2 * 8) * LC_LDB + nb +
                                     lane / 16 * 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; mi++)
#pragma unroll
        for (int ni = 0; ni < 4; ni++)
          lc_mma(acc[mi][ni], af[mi], bfr[ni / 2][ni % 2 * 2], bfr[ni / 2][ni % 2 * 2 + 1]);
    }
  }
  lc_wait<0>();

  // epilogue: fragment (mi, ni) holds rows r0 + {0, 8}, columns c, c + 1
  float cs[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ni++) cs[ni][0] = cs[ni][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 4; mi++) {
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int r = m0 + wm * 64 + mi * 16 + lane / 4 + 8 * h;
      if (r >= p.m) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ni++) {
        const int c = n0 + wn * 32 + ni * 8 + lane % 4 * 2;
#pragma unroll
        for (int e = 0; e < 2; e++) {
          if (c + e >= p.cols) continue;
          float v = acc[mi][ni][2 * h + e];
          if (p.bias) v = v + p.bias[c + e];
          if (p.mask) v = v * (__bfloat162float(p.mask[(size_t)r * p.ldm + c + e]) > 0.f ? 1.f : 0.f);
          if (p.x) {
            float* xp = p.x + (size_t)r * p.ldx + c + e;
            if (p.add_x) v = *xp + v;
            *xp = v;
          }
          if (p.y) p.y[(size_t)r * p.ldy + c + e] = __float2bfloat16(p.relu_y ? fmaxf(v, 0.f) : v);
          cs[ni][e] += v;
        }
      }
    }
  }
  if (p.colsum) {
    // the rows of a warp's fragments: lanes of one lane % 4 share columns
#pragma unroll
    for (int ni = 0; ni < 4; ni++)
#pragma unroll
      for (int e = 0; e < 2; e++) {
        float s = cs[ni][e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        const int c = n0 + wn * 32 + ni * 8 + lane % 4 * 2 + e;
        if (lane < 4 && c < p.cols) atomicAdd(p.colsum + c, s);
      }
  }
}

__global__ void __launch_bounds__(LC_THREADS) layer_fwd_kernel(const __grid_constant__ LayerParams p) {
  layer_tile<false>(p);
}

__global__ void __launch_bounds__(LC_THREADS) layer_bwd_kernel(const __grid_constant__ LayerParams p) {
  layer_tile<true>(p);
}

// view_pool_fwd: xo[s, p, c] = sum_v x[s, v, p, c] / ns; y = bf(relu(xo)).
// A block: 32 columns x 8 row lanes; rows (s, p) strided over blockIdx.y.
__global__ void __launch_bounds__(256) view_pool_fwd_kernel(const float* x, float* xo, bf16* y,
                                                            int sb, int ns, int b, int h) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  if (c >= h) return;
  const long long rows = (long long)sb * b;
  for (long long r = (long long)blockIdx.y * 8 + threadIdx.y; r < rows;
       r += (long long)gridDim.y * 8) {
    const long long s = r / b, pt = r % b;
    float sum = 0.f;
    for (int v = 0; v < ns; v++) sum += x[((s * ns + v) * b + pt) * h + c];
    const float mean = sum / (float)ns;
    xo[r * h + c] = mean;
    if (y) y[r * h + c] = __float2bfloat16(fmaxf(mean, 0.f));
  }
}

// view_pool_bwd: for g (SB, B, C) f32, v = g / ns broadcast over the views:
// gx (SB, NS, B, C) f32 = v (if given), y (SB, NS, B, ldy) = bf(v), zero at
// columns C..ldy-1, colsum (C) += the sum of v over every (s, view, p).
__global__ void __launch_bounds__(256) view_pool_bwd_kernel(const float* g, float* gx, bf16* y,
                                                            float* colsum, int sb, int ns, int b,
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
  if (!colsum) return;
  part[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && c < cc) {
    float t = 0.f;
    for (int i = 0; i < 8; i++) t += part[i][threadIdx.x];
    atomicAdd(colsum + c, t);
  }
}

static int lc_row_blocks(long long rows) {
  long long blocks = (rows + 63) / 64;
  return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

extern "C" {

// ptrs: a, w, bias, mask, x, y, colsum (null where unused); ints: m, n, k,
// lda, ldw, ldm, ldx, ldy, cols, add_x, relu_y. wt: 0 launches layer_fwd
// (W (K, N)), 1 layer_bwd (W (N, K), the product with W^T). K, N, the
// leading dims and the operands' addresses must be multiples of 8 elements
// (16-byte copies); returns cudaGetLastError() or cudaErrorInvalidValue.
int pnt_layer(void* const* ptrs, const int* ints, int wt, void* stream) {
  LayerParams p;
  p.a = static_cast<const bf16*>(ptrs[0]);
  p.w = static_cast<const bf16*>(ptrs[1]);
  p.bias = static_cast<const float*>(ptrs[2]);
  p.mask = static_cast<const bf16*>(ptrs[3]);
  p.x = static_cast<float*>(ptrs[4]);
  p.y = static_cast<bf16*>(ptrs[5]);
  p.colsum = static_cast<float*>(ptrs[6]);
  p.m = ints[0];
  p.n = ints[1];
  p.k = ints[2];
  p.lda = ints[3];
  p.ldw = ints[4];
  p.ldm = ints[5];
  p.ldx = ints[6];
  p.ldy = ints[7];
  p.cols = ints[8];
  p.add_x = ints[9];
  p.relu_y = ints[10];
  const bool aligned = reinterpret_cast<uintptr_t>(p.a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.w) % 16 == 0;
  if (p.k % 8 || p.n % 8 || p.lda % 8 || p.ldw % 8 || !aligned || p.cols > p.n || p.m < 0)
    return (int)cudaErrorInvalidValue;
  if (p.m == 0) return 0;
  const size_t smem = wt ? (size_t)LC_STAGES * 2 * LC_BM * LC_LD * sizeof(bf16)
                         : (size_t)LC_STAGES * (LC_BM * LC_LD + LC_BK * LC_LDB) * sizeof(bf16);
  auto kernel = wt ? layer_bwd_kernel : layer_fwd_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((p.n + LC_BN - 1) / LC_BN) * ((p.m + LC_BM - 1) / LC_BM);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, LC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// view_pool_fwd: x (sb, ns, b, h) f32 -> xo (sb, b, h) f32 and, if y is
// not null, y (sb, b, h) bf16 = bf(relu(xo)).
int pnt_view_pool_fwd(const void* x, void* xo, void* y, int sb, int ns, int b, int h,
                      void* stream) {
  if (sb * b == 0) return 0;
  dim3 grid((h + 31) / 32, lc_row_blocks((long long)sb * b));
  view_pool_fwd_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(xo), static_cast<bf16*>(y), sb, ns, b, h);
  return (int)cudaGetLastError();
}

// view_pool_bwd: g (sb, b, c) f32 -> gx (sb, ns, b, c) f32 = g / ns (if not
// null), y (sb, ns, b, ldy) bf16 (if not null), colsum (c) += sums.
int pnt_view_pool_bwd(const void* g, void* gx, void* y, void* colsum, int sb, int ns, int b, int c,
                      int ldy, void* stream) {
  if (sb * b == 0) return 0;
  const int width = y ? ldy : c;
  dim3 grid((width + 31) / 32, lc_row_blocks((long long)sb * b));
  view_pool_bwd_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(gx), static_cast<bf16*>(y),
      static_cast<float*>(colsum), sb, ns, b, c, ldy);
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
