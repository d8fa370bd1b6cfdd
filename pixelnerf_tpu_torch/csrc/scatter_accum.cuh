// Accumulation shared by the scatter-add kernels (pyramid.cu, bilerp.cu):
// w * g from (B, N) points, each with its K x K taps, added onto f32
// (B, H, W, C) gradients. One launch a call, one block a unit of the plan
// that the host makes (ops/scatter_plan.py); each segment of the plan is
// one map's units.
//
// Why: one f32 atomic into device memory a channel and tap makes ~1.5 G
// atomics a train step, and the small maps' addresses receive thousands
// each. Here:
// - a shared-memory unit (map b, a channel slice, a chunk of points) holds
//   its slice's (H, W, slice) f32 block in shared memory, adds w * g there
//   and flushes the block once, one vector reduction of `vec` floats a
//   thread and pixel, zeros skipped. Shared-memory f32 atomics are
//   compare-and-swap loops on sm_90, so each entry has one owning warp
//   instead (smem_unit);
// - a global unit (map b, WARPS x run points) is for a map too large for
//   that. Each warp walks runs of `run` consecutive points for 32 x V
//   channels, V = 4 where the rows allow 16-byte vectors, else 2 (any even
//   channel count). It sums w * g in registers while the points' tap base
//   (bx, by) stays the same, as it does for consecutive samples of a ray,
//   and adds them with one vector reduction a lane and tap when it changes
//   (atomicAdd on a float4 or float2, sm_90: one RED of 16 or 8 bytes).
// Each product w * g of two bf16 values is exact in f32 (bilerp.cu's maps
// past 8,192 pixels take float32 weights: the FMA that adds a product
// rounds it once), the dual cotangent is rounded to bf16 once, as before:
// only the order of the f32 sums differs from one atomic a channel and tap.

#pragma once

#include "tile_common.cuh"

#define SC_MIN_BLOCKS 2  // blocks an SM holds: at most 128 registers a thread
#define SC_LOADS 4       // points whose loads a global unit's warp has in flight
#define SC_STAGE 32768   // bytes of a shared-memory unit's bf16 cotangent stage
#define SC_SLOTS 8       // cotangent words a lane of a shared-memory unit loads at once
#define SC_SPASSES 4     // a shared-memory unit's lane: channel pairs 2l + 64k, k < 4 (slice <= 256)
#define SC_PLAN_HEAD 4   // nseg, run, units, smem bytes
#define SC_PLAN_SEG 8    // map, smem, slice, nslices, chunk, nchunks, vec, first

struct ScatterSeg {
  float* grad;          // (B, h, w, c) f32, added to
  int h, w, c;          // the map
  int c0;               // its first channel in the cotangent row
  int smem;             // 1: shared-memory units, 0: global units
  int slice, nslices;   // channels a unit takes
  int chunk, nchunks;   // points a unit takes
  int vec;              // floats a vector reduction adds: 4 or 2
  int first;            // the segment's first unit
};

struct ScatterPlan {
  ScatterSeg seg[MAX_LEVELS];
  int nseg, n, csum, run;
  int hf, wf;           // the grid the normalized uv address (pyramid: the finest level)
  const float* uv;      // (B, N, 2)
  const bf16* dz;       // (B, N, csum)
  const bf16* dz2;      // (B, N, csum), or null: the dual cotangent
};

template <int V>
__device__ __forceinline__ void load_bf16(const bf16* src, float* g) {
  if constexpr (V == 4) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(src));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    g[0] = a.x;
    g[1] = a.y;
    g[2] = b.x;
    g[3] = b.y;
  } else if constexpr (V == 2) {
    const float2 a = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(src)));
    g[0] = a.x;
    g[1] = a.y;
  } else {
    g[0] = __bfloat162float(__ldg(src));
  }
}

// V channels of a point's cotangent; with the dual one, the two summed in
// f32 and rounded to bf16 as the TPU kernel's bf16 add
template <int V>
__device__ __forceinline__ void load_cot(const ScatterPlan& p, size_t off, float* g) {
  load_bf16<V>(p.dz + off, g);
  if (p.dz2 != nullptr) {
    float g2[V];
    load_bf16<V>(p.dz2 + off, g2);
#pragma unroll
    for (int i = 0; i < V; i++) g[i] = round_bf16(g[i] + g2[i]);
  }
}

// one reduction of V floats into device memory (16- or 8-byte aligned)
template <int V>
__device__ __forceinline__ void red_add(float* dst, const float* v) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  }
}

// a run's sums: one reduction a lane and tap that some point weighted, then
// zero; `base` is the tap base's flat pixel
template <int K, int V>
__device__ __forceinline__ void flush_run(float* grad, const ScatterSeg& s, int base, int c, bool on,
                                          float (&acc)[K * K][V], unsigned& touched) {
  if (touched == 0) return;  // the same in every lane
#pragma unroll
  for (int t = 0; t < K * K; t++) {
    if (on && (touched >> t & 1u))
      red_add<V>(grad + ((size_t)base + t / K * s.w + t % K) * s.c + c, acc[t]);
#pragma unroll
    for (int i = 0; i < V; i++) acc[t][i] = 0.f;
  }
  touched = 0;
}

// A global unit: points [p0, p1) of map b, runs of `run` <= 32 points x
// groups of 32 x V channels over the warps. Lane i computes the taps of
// the run's point i once; the warp walks the run reading them with
// shuffles.
template <int K, int V, class Taps>
__device__ __forceinline__ void global_unit(const ScatterPlan& p, const ScatterSeg& s, int b,
                                            int p0, int p1, Taps taps) {
  const int lane = threadIdx.x % 32;
  const int groups = (s.c + 32 * V - 1) / (32 * V);
  const int items = (p1 - p0 + p.run - 1) / p.run * groups;
  float* grad = s.grad + (size_t)b * s.h * s.w * s.c;
  const float2* uv = reinterpret_cast<const float2*>(p.uv) + (size_t)b * p.n;
  for (int item = threadIdx.x / 32; item < items; item += WARPS) {
    const int c = item % groups * 32 * V + lane * V;
    const bool on = c < s.c;
    const int q0 = p0 + item / groups * p.run, nq = min(p.run, p1 - q0);
    int my_base = 0;
    float my_w[K * K];
    {
      const float2 pt = lane < nq ? __ldg(uv + q0 + lane) : make_float2(-1.f, -1.f);
      int bx, by;
      float w[K][K];
      taps(s, pt.x, pt.y, &bx, &by, w);
      my_base = by * s.w + bx;
#pragma unroll
      for (int t = 0; t < K * K; t++) my_w[t] = w[t / K][t % K];
    }
    float acc[K * K][V];
#pragma unroll
    for (int t = 0; t < K * K; t++)
#pragma unroll
      for (int i = 0; i < V; i++) acc[t][i] = 0.f;
    unsigned touched = 0;
    int cur = -1;
    for (int u = 0; u < nq; u += SC_LOADS) {
      float g[SC_LOADS][V];
#pragma unroll
      for (int v = 0; v < SC_LOADS; v++) {
        if (u + v < nq && on) {
          load_cot<V>(p, ((size_t)b * p.n + q0 + u + v) * p.csum + s.c0 + c, g[v]);
        } else {
#pragma unroll
          for (int i = 0; i < V; i++) g[v][i] = 0.f;
        }
      }
#pragma unroll
      for (int v = 0; v < SC_LOADS; v++) {
        if (u + v >= nq) break;  // the same in every lane
        const int base = __shfl_sync(0xffffffffu, my_base, u + v);
        if (base != cur) {
          flush_run<K, V>(grad, s, cur, c, on, acc, touched);
          cur = base;
        }
#pragma unroll
        for (int t = 0; t < K * K; t++) {
          const float wt = __shfl_sync(0xffffffffu, my_w[t], u + v);
          touched |= (unsigned)(wt != 0.f) << t;
#pragma unroll
          for (int i = 0; i < V; i++) acc[t][i] = fmaf(wt, g[v][i], acc[t][i]);
        }
      }
    }
    flush_run<K, V>(grad, s, cur, c, on, acc, touched);
  }
}

// A shared-memory unit: points [p0, p1) of map b onto channels [s0, s0 + S)
// held in `sm` as (h * w, S) f32. Shared-memory f32 atomics are
// compare-and-swap loops on sm_90 (ATOMS.CAST.SPIN), so every entry has
// one owner instead: warp w adds every channel of the rows in band w (h /
// WARPS rows, rounded up), lane l channels 2l + 64k, with plain loads and
// stores. Points go in batches (sc_batch), each strided across the chunk.
// The block first puts each point's taps into a table (sc_rec<K> floats a
// point: base pixel, base row, the mask of its nonzero taps, K * K
// weights), the point into the work list of each warp whose rows it
// touches (integer shared atomics, which are native), and its cotangent
// slice, the dual pair summed and rounded, into a bf16 stage; then each
// warp walks its own list, adding the point's taps in its rows.
template <int K>
constexpr int sc_rec = (K * K + 3 + 3) / 4 * 4;

// points a batch of a slice of S channels: its bf16 stage within SC_STAGE
// bytes, whole warps, at most a thread a point (ops/scatter_plan.py:_batch)
__host__ __device__ inline int sc_batch(int S) {
  const int nb = SC_STAGE / (2 * S) / 32 * 32;
  return nb < THREADS ? (nb > 32 ? nb : 32) : THREADS;
}

template <int K, class Taps>
__device__ __forceinline__ void smem_unit(const ScatterPlan& p, const ScatterSeg& s, int b, int s0,
                                          int S, int p0, int p1, Taps taps, float* sm) {
  constexpr int REC = sc_rec<K>;
  const int hw = s.h * s.w, nb = sc_batch(s.slice);
  float* tab = sm + (s.slice * hw + 3) / 4 * 4;  // 16-byte rows
  __nv_bfloat162* stage = reinterpret_cast<__nv_bfloat162*>(tab + nb * REC);
  int* count = reinterpret_cast<int*>(stage + nb * (s.slice / 2));  // a warp's list length
  unsigned short* list = reinterpret_cast<unsigned short*>(count + WARPS);  // (WARPS, nb)
  const int pairs = S / 2;  // a staged point's slice: bf16 pairs, the row pitch of the stage
  const int lp = pairs > 64 ? 2 : pairs > 32 ? 1 : 0;  // log2 of a lane's passes over a slice
  for (int i = threadIdx.x; i < hw * S; i += THREADS) sm[i] = 0.f;
  if (threadIdx.x < WARPS) count[threadIdx.x] = 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rows = (s.h + WARPS - 1) / WARPS, r0 = warp * rows, r1 = min(r0 + rows, s.h);
  const float2* uv = reinterpret_cast<const float2*>(p.uv) + (size_t)b * p.n;
  const size_t col = (size_t)s.c0 + s0;
  __syncthreads();
  // batch j takes points p0 + j, p0 + j + nbat, ...: consecutive points are
  // samples of one ray and tap the same rows, so a batch of them would load
  // only the warps of those rows
  const int nbat = (p1 - p0 + nb - 1) / nb;
  for (int j = 0; j < nbat; j++) {
    const int q0 = p0 + j, nq = (p1 - q0 + nbat - 1) / nbat;  // batch entry e: point q0 + e * nbat
    if (threadIdx.x < nq) {
      const float2 pt = __ldg(uv + q0 + threadIdx.x * nbat);
      int bx, by;
      float w[K][K];
      taps(s, pt.x, pt.y, &bx, &by, w);
      float* rec = tab + threadIdx.x * REC;
      unsigned nz = 0;
#pragma unroll
      for (int t = 0; t < K * K; t++) {
        rec[3 + t] = w[t / K][t % K];
        nz |= (unsigned)(w[t / K][t % K] != 0.f) << t;
      }
      rec[0] = __int_as_float(by * s.w + bx);
      rec[1] = __int_as_float(by);
      rec[2] = __int_as_float((int)nz);
      // the warps of the rows with a nonzero tap
      int top = -1, bottom = -1;
#pragma unroll
      for (int t = 0; t < K * K; t++)
        if (nz >> t & 1u) {
          bottom = by + t / K;
          if (top < 0) top = bottom;
        }
      for (int v = top < 0 ? WARPS : top / rows; v <= bottom / rows && v < WARPS; v++)
        list[v * nb + atomicAdd(count + v, 1)] = (unsigned short)threadIdx.x;
    }
    // the stage: each warp SC_SLOTS words a lane at once, rounds of
    // SC_SLOTS / passes consecutive points (passes a power of two)
    for (int i = warp * (SC_SLOTS >> lp); i < nq; i += WARPS * (SC_SLOTS >> lp)) {
      float g[SC_SLOTS][2];
#pragma unroll
      for (int m = 0; m < SC_SLOTS; m++) {
        const int q = i + (m >> lp), pair = lane + 32 * (m & ((1 << lp) - 1));
        if (q < nq && pair < pairs)
          load_cot<2>(p, ((size_t)b * p.n + q0 + q * nbat) * p.csum + col + 2 * pair, g[m]);
      }
#pragma unroll
      for (int m = 0; m < SC_SLOTS; m++) {
        const int q = i + (m >> lp), pair = lane + 32 * (m & ((1 << lp) - 1));
        if (q < nq && pair < pairs) stage[q * pairs + pair] = __floats2bfloat162_rn(g[m][0], g[m][1]);
      }
    }
    __syncthreads();
    const int mine_n = count[warp];
    for (int e = 0; e < mine_n; e++) {
      const int i = list[warp * nb + e];
      const int4 head = *reinterpret_cast<const int4*>(tab + i * REC);  // base, row, mask
      const float* wt = tab + i * REC + 3;
      float2 g[SC_SPASSES];
#pragma unroll
      for (int k = 0; k < SC_SPASSES; k++)
        g[k] = lane + 32 * k < pairs ? __bfloat1622float2(stage[i * pairs + lane + 32 * k])
                                     : make_float2(0.f, 0.f);
      // the nonzero taps in this warp's rows
      const int lo = max(r0 - head.y, 0), hi = min(r1 - head.y, K);  // tap rows [lo, hi)
      unsigned mine = (unsigned)head.z & (((1u << (hi * K)) - 1u) & ~((1u << (lo * K)) - 1u));
      while (mine) {
        const int t = __ffs(mine) - 1;
        mine &= mine - 1;
        const float w = wt[t];
        float2* acc = reinterpret_cast<float2*>(sm + (head.x + t / K * s.w + t % K) * S + 2 * lane);
        float2 v[SC_SPASSES];
#pragma unroll
        for (int k = 0; k < SC_SPASSES; k++)
          if (lane + 32 * k < pairs) v[k] = acc[32 * k];
#pragma unroll
        for (int k = 0; k < SC_SPASSES; k++)
          if (lane + 32 * k < pairs)
            acc[32 * k] = make_float2(fmaf(w, g[k].x, v[k].x), fmaf(w, g[k].y, v[k].y));
      }
    }
    __syncwarp();
    if (lane == 0) count[warp] = 0;  // only this warp reads it; the next batch adds after the barrier
    __syncthreads();
  }
  const int vecs = S / s.vec;
  float* grad = s.grad + (size_t)b * hw * s.c + s0;
  for (int i = threadIdx.x; i < hw * vecs; i += THREADS) {
    const int pix = i / vecs, cc = i % vecs * s.vec;
    const float* v = sm + pix * S + cc;
    float* dst = grad + (size_t)pix * s.c + cc;
    if (s.vec == 4) {
      const float4 x = *reinterpret_cast<const float4*>(v);
      if (x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f) red_add<4>(dst, v);
    } else {
      const float2 x = *reinterpret_cast<const float2*>(v);
      if (x.x != 0.f || x.y != 0.f) red_add<2>(dst, v);
    }
  }
}

// The unit of this block: its segment, map, slice and chunk.
template <int K, class Taps>
__device__ __forceinline__ void scatter_block(const ScatterPlan& p, Taps taps) {
  extern __shared__ float4 sc_smem[];
  int u = blockIdx.x;
  ScatterSeg s = p.seg[0];
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; i++)
    if (i < p.nseg && u >= p.seg[i].first) s = p.seg[i];
  u -= s.first;
  const int chunk = u % s.nchunks;
  u /= s.nchunks;
  const int slice = u % s.nslices, b = u / s.nslices;
  const int p0 = chunk * s.chunk, p1 = min(p0 + s.chunk, p.n);
  if (s.smem) {
    const int s0 = slice * s.slice;
    smem_unit<K>(p, s, b, s0, min(s.slice, s.c - s0), p0, p1, taps,
                 reinterpret_cast<float*>(sc_smem));
  } else if (s.vec == 4) {
    global_unit<K, 4>(p, s, b, p0, p1, taps);
  } else {
    global_unit<K, 2>(p, s, b, p0, p1, taps);
  }
}

// Fill p's segments from the host's plan (ops/scatter_plan.py:
// ScatterPlan.as_ints) for `b` maps of `n` points, K x K taps a point, and
// the maps' gradients, (h, w, c) and channel offsets; the launch's units
// and shared-memory bytes. Returns cudaErrorInvalidValue for a plan that
// does not cover them or does not fit.
static inline int scatter_plan(ScatterPlan* p, const int* plan, float* const* grads,
                               const int* dims, const int* c0, int nmaps, int b, int n, int k,
                               int* units, int* smem) {
  const int nseg = plan[0];
  if (nseg < 1 || nseg > MAX_LEVELS || plan[1] < 1 || plan[1] > 32) return (int)cudaErrorInvalidValue;
  p->nseg = nseg;
  p->run = plan[1];
  *units = plan[2];
  *smem = plan[3];
  long long first = 0;
  for (int i = 0; i < nseg; i++) {
    const int* q = plan + SC_PLAN_HEAD + SC_PLAN_SEG * i;
    const int m = q[0];
    if (m < 0 || m >= nmaps || q[2] < 1 || q[3] < 1 || q[4] < 1) return (int)cudaErrorInvalidValue;
    ScatterSeg& s = p->seg[i];
    s = ScatterSeg{grads[m], dims[3 * m], dims[3 * m + 1], dims[3 * m + 2], c0[m],
                   q[1], q[2], q[3], q[4], q[5], q[6], q[7]};
    const bool covers = s.first == first && (long long)s.chunk * s.nchunks >= n &&
                        (long long)s.slice * s.nslices >= s.c && (s.smem || s.slice == s.c);
    const int nb = sc_batch(s.slice);
    // sc_rec<k> floats a point, its bf16 stage, the warps' list lengths and lists
    const long long batch = 4LL * nb * ((k * k + 3 + 3) / 4 * 4) + 2LL * nb * s.slice +
                            4 * WARPS + 2LL * WARPS * nb;
    const bool fits = !s.smem || (s.slice <= 64 * SC_SPASSES &&
                                  16LL * ((s.h * s.w * s.slice + 3) / 4) + batch <= *smem);
    const bool vec = (s.vec == 4 || s.vec == 2) && s.c % s.vec == 0 && s.slice % s.vec == 0;
    if (!covers || !fits || !vec) return (int)cudaErrorInvalidValue;
    first += (long long)b * s.nslices * s.nchunks;
  }
  return first == *units ? 0 : (int)cudaErrorInvalidValue;
}

template <class Kernel>
static inline int scatter_launch(Kernel kernel, const ScatterPlan& p, int units, int smem,
                                 cudaStream_t stream) {
  if (units < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<units, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
