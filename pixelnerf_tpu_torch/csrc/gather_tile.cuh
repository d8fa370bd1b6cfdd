// The gather shared by the two lookup kernels (pyramid.cu: pyramid_gather;
// bilerp.cu: bilerp_gather): for each of (B, N) points and each map l of
// the call, the sum of w * row over the point's K x K taps of map l (bf16
// rows, f32 sums), stored as bf16 at channels [c0_l, c0_l + C_l) of the
// point's output row. One launch a call, one block a unit of the plan that
// the host makes (ops/gather_plan.py): one map b and a chunk of its points.
//
// Bound on the H100: bytes. The (N, sum C) bf16 output (1 KB a point at the
// flagship) is written once; the maps (a few MB) stay in L2. The earlier
// design loaded all K x K taps of every map, zero or not, a bf16 pair a
// lane, one point a warp, every point's rows anew: ~9 KB of tap rows a
// pyramid point to write 1 KB. Here:
// - only taps with a nonzero weight are loaded and summed (past the map's
//   edge, or with a zero axis weight, a tap adds nothing);
// - a lane moves V = 8 bf16 channels (16-byte loads and stores) where every
//   map's channel count is a multiple of 8 and the maps start on 16 bytes,
//   else V = 2 (4 bytes: any even channel count, any row alignment);
// - a group of LANES lanes takes a point (LANES = 16: two points a warp).
//   Each group walks a stream of consecutive points, so the samples of one
//   ray, which share their tap rows, stay in one group. Lane j of a group
//   computes the taps of the batch's point j once, and every lane reads
//   each point's taps from it (GtBatch: by shuffle, or from a table in
//   shared memory);
// - level 0 (the fine grid, a 2 x 2 window) keeps the rows it loaded in
//   registers while the points' tap base holds and loads only rows it does
//   not hold yet (`cached`); its loads go out before the other levels'
//   work and are summed after it;
// - a map whose bf16 (H, W, C) block fits the unit's shared memory (the
//   pyramid's 16x16x128 and 8x8x256 levels at the flagship) is copied there
//   once a unit (cp.async) and read from there;
// - the level loop is unrolled at compile time (a template on the level
//   count), so the parameter block is never indexed at run time.
// What is left is mostly issue: an unpack and an FMA a channel and tap.
// Products of two bf16 values are exact in f32, and each point's taps are
// summed in the plain version's order: the result is the plain version's,
// zero taps aside (which add +0).

#pragma once

#include <type_traits>

#include "tile_common.cuh"

#define GT_MIN_BLOCKS 2  // blocks an SM holds: at most 128 registers a thread
#define GT_PLAN_HEAD 6   // chunk, nchunks, units, smem bytes, vec, cached; then soff a map

struct GatherMap {
  const bf16* feat;  // (B, h, w, c)
  int h, w, c;
  int c0;    // its first channel in the output row
  int soff;  // its byte offset in shared memory, or -1: read from device memory
};

struct GatherParams {
  GatherMap map[MAX_LEVELS];
  int n, csum;
  int hf, wf;            // the grid the normalized uv address (pyramid: the finest level)
  int chunk, nchunks;    // points a unit takes
  int cached;            // 1: map 0's rows in the register cache
  const float* uv;       // (B, N, 2)
  bf16* out;             // (B, N, csum)
};

// V bf16 channels as one load
template <int V>
struct gt_vec;
template <>
struct gt_vec<8> {
  typedef uint4 T;
};
template <>
struct gt_vec<2> {
  typedef unsigned int T;
};

template <int V, bool SMEM>
__device__ __forceinline__ typename gt_vec<V>::T gt_load(const bf16* p) {
  typedef typename gt_vec<V>::T T;
  if constexpr (SMEM) {
    return *reinterpret_cast<const T*>(p);
  } else {
    return __ldg(reinterpret_cast<const T*>(p));
  }
}

template <int V>
__device__ __forceinline__ void gt_fma(float (&acc)[V], float w, const typename gt_vec<V>::T& r) {
  const unsigned int* u = reinterpret_cast<const unsigned int*>(&r);
#pragma unroll
  for (int i = 0; i < V / 2; i++) {
    const float lo = __uint_as_float(u[i] << 16), hi = __uint_as_float(u[i] & 0xffff0000u);
    acc[2 * i] = fmaf(w, lo, acc[2 * i]);  // w * row is exact: the FMA rounds once, as a sum
    acc[2 * i + 1] = fmaf(w, hi, acc[2 * i + 1]);
  }
}

// the output is written once and read by the next kernel: streamed past L2's
// resident maps (st.global.cs)
template <int V>
__device__ __forceinline__ void gt_store(bf16* out, const float (&acc)[V]) {
  typename gt_vec<V>::T r;
  unsigned int* u = reinterpret_cast<unsigned int*>(&r);
#pragma unroll
  for (int i = 0; i < V / 2; i++) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    u[i] = *reinterpret_cast<const unsigned int*>(&h);
  }
  __stcs(reinterpret_cast<typename gt_vec<V>::T*>(out), r);
}

// f(integral_constant<int, i>{}) for i = I, ..., N - 1, unrolled at compile time
template <int I, int N, class F>
__device__ __forceinline__ void gt_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    gt_for<I + 1, N>(f);
  }
}

// A point's taps, as the walk passes them between lanes: for each map l its
// tap base (the flat pixel of tap (0, 0)) and its K_l x K_l weights, K_0 = 2
// (the fine grid's window) and K_l = 3 for the composed levels. The weights
// are bf16 values (the plain versions round them so), two to a word; or, for
// one map with float32 weights (F32: bilerp.cu's maps past 8,192 pixels),
// one float a word.
__host__ __device__ constexpr int gt_k(int l) { return l == 0 ? 2 : 3; }
__host__ __device__ constexpr int gt_off(int l) { return l == 0 ? 0 : 3 + 6 * (l - 1); }

template <int W>
struct GtWords {
  unsigned int v[W];
};

// words of the block's table of tap records a thread: none for one map
__host__ __device__ constexpr int gt_table_words(int nmaps) {
  return nmaps > 1 ? gt_off(nmaps) : 0;
}

// A batch's tap records, one a thread. Thread j of a group puts the record
// of the batch's point j, and every lane of the warp gets each record. One
// map's record (3 words) stays in registers and is read by shuffle; more
// maps' records go to the block's table in shared memory (word k of every
// thread's record in row k: conflict-free writes, broadcast reads), since
// the registers of the record a lane keeps and of the one it reads would
// spill. Either measured faster where it is used.
template <int W, bool TABLE>
struct GtBatch {
  unsigned int* table;
  unsigned int mine[TABLE ? 1 : W];

  __device__ __forceinline__ void put(int k, unsigned int v) {
    if constexpr (TABLE) {
      table[k * THREADS + threadIdx.x] = v;
    } else {
      mine[k] = v;
    }
  }
  // between the puts and the gets of a batch, and the gets and the next puts
  __device__ __forceinline__ void sync() const {
    if constexpr (TABLE) __syncwarp();
  }
  // words [O, O + N) of lane `src`'s record; every lane of the warp calls it
  template <int O, int N>
  __device__ __forceinline__ GtWords<N> get(int src) const {
    GtWords<N> t;
#pragma unroll
    for (int k = 0; k < N; k++) {
      if constexpr (TABLE) {
        t.v[k] = table[(O + k) * THREADS + (threadIdx.x & ~31) + src];
      } else {
        t.v[k] = __shfl_sync(0xffffffffu, mine[O + k], src);
      }
    }
    return t;
  }
};

// weight i of the map whose record starts at word O
template <int O, bool F32, int W>
__device__ __forceinline__ float gt_w(const GtWords<W>& t, int i) {
  if constexpr (F32) return __uint_as_float(t.v[O + 1 + i]);
  const unsigned int u = t.v[O + 1 + i / 2];
  return __uint_as_float(i % 2 ? u & 0xffff0000u : u << 16);
}

// words of a map's record: its tap base and its K x K weights
template <int K, bool F32>
__host__ __device__ constexpr int gt_rec_words() {
  return 1 + (F32 ? K * K : (K * K + 1) / 2);
}

// Map l's sums for one point from `map` (device or shared memory), no cache:
// lane j's channels j * V + k * LANES * V, a row of taps at a time (the
// registers of 3 x 3 taps' 16-byte loads would spill). A tap with a zero
// weight (past the map's edge, or a zero axis weight) is neither loaded nor
// added.
template <int K, int V, int LANES, bool SMEM, bool F32, int W>
__device__ __forceinline__ void gt_level(const bf16* map, int wn, int C, const GtWords<W>& t,
                                         bf16* out, int j) {
  constexpr int O = 0;
  const int off = (int)t.v[O];
  for (int c = j * V; c < C; c += LANES * V) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; i++) acc[i] = 0.f;
#pragma unroll
    for (int ty = 0; ty < K; ty++) {
      typename gt_vec<V>::T r[K];
#pragma unroll
      for (int tx = 0; tx < K; tx++)
        if (gt_w<O, F32>(t, ty * K + tx) != 0.f)
          r[tx] = gt_load<V, SMEM>(map + (size_t)(off + ty * wn + tx) * C + c);
#pragma unroll
      for (int tx = 0; tx < K; tx++)
        if (gt_w<O, F32>(t, ty * K + tx) != 0.f)
          gt_fma<V>(acc, gt_w<O, F32>(t, ty * K + tx), r[tx]);
    }
    gt_store<V>(out + c, acc);
  }
}

// Level 0's register cache: the 2 x 2 rows of lane j's SL channel groups
// at tap base `key`; bit i of `have` says row i is held.
template <int SL, int V>
struct GtRows {
  typename gt_vec<V>::T r[SL][4];
  int key;
  unsigned have;
};

// load the point's nonzero level-0 rows that the cache does not hold
template <int SL, int V, int LANES, bool F32, int W>
__device__ __forceinline__ void gt_fine_load(GtRows<SL, V>& rows, const bf16* map, int wn, int C,
                                             const GtWords<W>& t, int j) {
  const int off = (int)t.v[0];
  if (off != rows.key) {
    rows.key = off;
    rows.have = 0;
  }
  unsigned need = 0;
#pragma unroll
  for (int i = 0; i < 4; i++) need |= (unsigned)(gt_w<0, F32>(t, i) != 0.f) << i;
  const unsigned load = need & ~rows.have;
  rows.have |= need;
#pragma unroll
  for (int s = 0; s < SL; s++) {
    const int c = j * V + s * LANES * V;
    if (c < C) {
#pragma unroll
      for (int i = 0; i < 4; i++)
        if (load >> i & 1u)
          rows.r[s][i] = gt_load<V, false>(map + (size_t)(off + i / 2 * wn + i % 2) * C + c);
    }
  }
}

template <int SL, int V, int LANES, bool F32, int W>
__device__ __forceinline__ void gt_fine_sum(const GtRows<SL, V>& rows, int C, const GtWords<W>& t,
                                            bf16* out, int j) {
#pragma unroll
  for (int s = 0; s < SL; s++) {
    const int c = j * V + s * LANES * V;
    if (c < C) {
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; i++) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; i++)
        if (gt_w<0, F32>(t, i) != 0.f) gt_fma<V>(acc, gt_w<0, F32>(t, i), rows.r[s][i]);
      gt_store<V>(out + c, acc);
    }
  }
}

// copy map b's (h, w, c) bf16 block into shared memory
template <int V>
__device__ __forceinline__ void gt_stage(char* dst, const bf16* src, int nbytes) {
  const char* s = reinterpret_cast<const char*>(src);
  if constexpr (V == 8) {
    for (int i = threadIdx.x * 16; i < nbytes; i += THREADS * 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       (unsigned)__cvta_generic_to_shared(dst + i)),
                   "l"(s + i)
                   : "memory");
  } else {
    for (int i = threadIdx.x * 4; i < nbytes; i += THREADS * 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       (unsigned)__cvta_generic_to_shared(dst + i)),
                   "l"(s + i)
                   : "memory");
  }
}

// The unit of this block: map b, points [p0, p1), in WARPS * 32 / LANES
// streams of consecutive points, one a group of LANES lanes. `taps(m, u, v,
// &bx, &by, w)` gives a point's tap base and weights on map m (w[3][3], the
// first K x K used). SL: level 0's channel groups a lane caches. F32: the
// weights pass between lanes as float32 (one map only), else as bf16.
template <int NLEV, int V, int LANES, int SL, bool F32 = false, class Taps>
__device__ __forceinline__ void gather_block(const GatherParams& p, Taps taps) {
  static_assert(!F32 || NLEV == 1, "float32 weights: one map");
  extern __shared__ uint4 gt_smem[];
  constexpr int GROUPS = 32 / LANES;
  const int b = blockIdx.x / p.nchunks;
  const int p0 = blockIdx.x % p.nchunks * p.chunk, p1 = min(p.n, p0 + p.chunk);
  char* smem = reinterpret_cast<char*>(gt_smem);

  bool staged = false;
  gt_for<0, NLEV>([&](auto L) {
    const GatherMap& m = p.map[decltype(L)::value];
    if (m.soff >= 0) {
      gt_stage<V>(smem + m.soff, m.feat + (size_t)b * m.h * m.w * m.c, m.h * m.w * m.c * 2);
      staged = true;
    }
  });
  if (staged) {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }

  const int lane = threadIdx.x % 32, j = lane % LANES;
  const int streams = WARPS * GROUPS;
  const int len = (p1 - p0 + streams - 1) / streams;
  const int q0 = p0 + (threadIdx.x / 32 * GROUPS + lane / LANES) * len;
  const int q1 = min(p1, q0 + len);
  const float2* uv = reinterpret_cast<const float2*>(p.uv) + (size_t)b * p.n;
  const bool cached = p.cached;
  GtBatch<F32 ? gt_rec_words<2, true>() : gt_off(NLEV), (gt_table_words(NLEV) > 0)> rec;
  rec.table = reinterpret_cast<unsigned int*>(smem);  // the table first, the staged maps after it
  GtRows<SL, V> rows;
  rows.key = -1;
  rows.have = 0;

#pragma unroll 1
  for (int i0 = 0; i0 < len; i0 += LANES) {  // the same in every lane
    // thread j of a group: the record of the batch's point j
    {
      const int q = q0 + i0 + j;
      const float2 pt = q < q1 ? __ldg(uv + q) : make_float2(0.f, 0.f);
      gt_for<0, NLEV>([&](auto L) {
        constexpr int l = decltype(L)::value, K = gt_k(l), O = gt_off(l);
        int bx, by;
        float w[3][3];
        taps(p.map[l], pt.x, pt.y, &bx, &by, w);
        rec.put(O, (unsigned)(by * p.map[l].w + bx));
        if constexpr (F32) {
#pragma unroll
          for (int i = 0; i < K * K; i++) rec.put(O + 1 + i, __float_as_uint(w[i / K][i % K]));
        } else {
#pragma unroll
          for (int i = 0; i < K * K; i += 2) {
            const unsigned hi = i + 1 < K * K ? __float_as_uint(w[(i + 1) / K][(i + 1) % K]) : 0u;
            rec.put(O + 1 + i / 2, __float_as_uint(w[i / K][i % K]) >> 16 | (hi & 0xffff0000u));
          }
        }
      });
    }
    rec.sync();
    const int m = min(LANES, len - i0);
#pragma unroll 1
    for (int i = 0; i < m; i++) {
      // every lane gets each record (a group whose stream has ended too),
      // each map's words just before its sums: fewer registers live at once
      const int src = (lane & ~(LANES - 1)) | i, q = q0 + i0 + i;
      const bool on = q < q1;
      bf16* out = p.out + ((size_t)b * p.n + q) * p.csum;
      const GatherMap& m0 = p.map[0];
      const bf16* f0 = m0.feat + (size_t)b * m0.h * m0.w * m0.c;
      constexpr int N0 = gt_rec_words<2, F32>();
      const GtWords<N0> t0 = rec.template get<0, N0>(src);
      if (on && cached) gt_fine_load<SL, V, LANES, F32>(rows, f0, m0.w, m0.c, t0, j);
      gt_for<0, NLEV>([&](auto L) {
        constexpr int l = decltype(L)::value, K = gt_k(l), N = gt_rec_words<K, F32>();
        const GatherMap& ml = p.map[l];
        if (l == 0 && cached) return;
        const GtWords<N> t = rec.template get<gt_off(l), N>(src);
        if (!on) return;
        if (ml.soff >= 0) {
          gt_level<K, V, LANES, true, F32>(reinterpret_cast<const bf16*>(smem + ml.soff), ml.w,
                                           ml.c, t, out + ml.c0, j);
        } else {
          gt_level<K, V, LANES, false, F32>(ml.feat + (size_t)b * ml.h * ml.w * ml.c, ml.w, ml.c,
                                            t, out + ml.c0, j);
        }
      });
      if (on && cached) gt_fine_sum<SL, V, LANES, F32>(rows, m0.c, t0, out + m0.c0, j);
    }
    rec.sync();  // the next batch's records overwrite this one's
  }
}

// Fill p from the host's plan (ops/gather_plan.py: GatherPlan.as_ints) for
// `nmaps` maps ((h, w, c) each in `dims`, concatenated in this order), b
// maps of n points; the launch's units, shared-memory bytes and V. Returns
// cudaErrorInvalidValue for a plan that does not cover them or does not fit.
static inline int gather_plan(GatherParams* p, const int* plan, const void* const* feats,
                              const int* dims, int nmaps, int b, int n, int lanes, int sl,
                              int* units, int* smem, int* vec) {
  if (nmaps < 1 || nmaps > MAX_LEVELS || b < 1 || n < 1) return (int)cudaErrorInvalidValue;
  p->chunk = plan[0];
  p->nchunks = plan[1];
  *units = plan[2];
  *smem = plan[3];
  *vec = plan[4];
  p->cached = plan[5];
  p->n = n;
  if (p->chunk < 1 || (long long)p->chunk * p->nchunks < n || (long long)b * p->nchunks != *units ||
      (*vec != 8 && *vec != 2) || *smem < 0 || *smem > 232448)
    return (int)cudaErrorInvalidValue;
  int c0 = 0;
  for (int l = 0; l < nmaps; l++) {
    GatherMap& m = p->map[l];
    m = GatherMap{static_cast<const bf16*>(feats[l]), dims[3 * l], dims[3 * l + 1], dims[3 * l + 2],
                  c0, plan[GT_PLAN_HEAD + l]};
    c0 += m.c;
    const long long bytes = 2LL * m.h * m.w * m.c;
    if (m.h < 1 || m.w < 1 || m.c < 2 || m.c % *vec != 0 ||
        (m.soff >= 0 && (m.soff % 16 != 0 || m.soff + bytes > *smem)) ||
        (reinterpret_cast<uintptr_t>(m.feat) % (2 * *vec)) != 0)
      return (int)cudaErrorInvalidValue;
  }
  p->csum = c0;
  // the taps' table first, the staged maps after it
  const int table = 4 * THREADS * gt_table_words(nmaps);
  for (int l = 0; l < nmaps; l++)
    if (p->map[l].soff >= 0 && p->map[l].soff < table) return (int)cudaErrorInvalidValue;
  if (*smem < table) return (int)cudaErrorInvalidValue;
  const GatherMap& m0 = p->map[0];
  if (p->cached && (m0.soff >= 0 || m0.c > sl * lanes * *vec)) return (int)cudaErrorInvalidValue;
  return 0;
}

template <class Kernel>
static inline int gather_launch(Kernel kernel, const GatherParams& p, int units, int smem,
                                cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<units, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
