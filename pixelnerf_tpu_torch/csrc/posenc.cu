// Field-input builder: positional code + viewdir concat in one pass.
//
// Replaces the TPU kernel pixelnerf_tpu/ops/posenc_pallas.py:
// posenc_concat (`_kernel`, one Pallas pass per 2048-row tile).
//
// What it computes, per row of (M, 3) float32 base points and view
// directions, F frequencies fr_f = f0 * 2^f (models/code.py:freq_phase):
//   out = [b0 b1 b2 | sin(b_d * fr_f + p) for f < F, p in (0, pi/2), d < 3
//          | v0 v1 v2]                                   (M, 6F + 6)
// in bf16 (or float32), columns as the TPU kernel's: for each frequency
// the three sines, then the three cosines as the sine of the shifted
// argument. Each product and each sum rounds on its own (__fmul_rn,
// __fadd_rn: a contracted FMA moves values across a bf16 boundary) and the
// sine is the precise sinf (arguments reach |b| * f0 * 2^(F-1), far outside
// the range where __sinf is accurate), as the plain version's elementwise
// ops do; base and viewdirs are copied exactly.
//
// Bound on the H100: bytes or the sines' issue. Each row reads 24 B and
// writes 12 (F + 1) B (84 B at F = 6) for 6F precise sines of some twenty
// instructions each, of the same order at 3.35 TB/s and the FP32 pipe's
// one instruction a lane and clock.
//
// Design: a block takes PE_ROWS consecutive rows. It reads their base and
// viewdirs as two contiguous runs with 16-byte loads into shared memory;
// each thread then computes one whole row in registers, packs neighbouring
// columns into one bf16 pair, and writes the row into a shared staging
// buffer of the block's rows (84 x PE_ROWS bytes at F = 6, a multiple of 16
// bytes, as is its offset in `out`); the block writes the buffer out with
// coalesced 16-byte stores. A tail block masks its loads and stores to its
// rows: M need be a multiple of nothing.

#include "tile_common.cuh"

#define PE_ROWS 128  // rows (and threads) a block

template <typename T>
struct PePair;
template <>
struct PePair<bf16> {
  typedef __nv_bfloat162 type;
  static __device__ __forceinline__ type make(float a, float b) { return __floats2bfloat162_rn(a, b); }
};
template <>
struct PePair<float> {
  typedef float2 type;
  static __device__ __forceinline__ type make(float a, float b) { return make_float2(a, b); }
};

// `n` floats from src to dst, both 16-byte aligned: 16-byte loads, then the
// last n % 4 one at a time
__device__ __forceinline__ void pe_load(const float* __restrict__ src, float* dst, int n) {
  const int vecs = n / 4;
  for (int i = threadIdx.x; i < vecs; i += PE_ROWS)
    reinterpret_cast<float4*>(dst)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
  for (int i = 4 * vecs + threadIdx.x; i < n; i += PE_ROWS) dst[i] = __ldg(src + i);
}

template <typename T>
__global__ void __launch_bounds__(PE_ROWS) posenc_kernel(const float* __restrict__ base,
                                                         const float* __restrict__ vd, T* __restrict__ out,
                                                         long long m, int nf, float f0, float half_pi) {
  typedef typename PePair<T>::type P;
  extern __shared__ float4 pe_smem[];
  float* sb = reinterpret_cast<float*>(pe_smem);
  float* sv = sb + 3 * PE_ROWS;
  P* stage = reinterpret_cast<P*>(sv + 3 * PE_ROWS);
  const long long row0 = (long long)blockIdx.x * PE_ROWS;
  const int rows = m - row0 < PE_ROWS ? (int)(m - row0) : PE_ROWS;
  const int pairs = 3 * nf + 3;  // a row: 6F + 6 columns
  pe_load(base + row0 * 3, sb, 3 * rows);
  pe_load(vd + row0 * 3, sv, 3 * rows);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows) {
    const float b0 = sb[3 * t], b1 = sb[3 * t + 1], b2 = sb[3 * t + 2];
    P* dst = stage + t * pairs;  // a stride of 21 words at F = 6: no bank conflicts
    dst[0] = PePair<T>::make(b0, b1);
    float pend = b2;  // columns pair up across the groups of three
    float fr = f0;
    for (int f = 0; f < nf; f++) {
      const float x0 = __fmul_rn(b0, fr), x1 = __fmul_rn(b1, fr), x2 = __fmul_rn(b2, fr);
      const float s0 = sinf(__fadd_rn(x0, 0.f)), s1 = sinf(__fadd_rn(x1, 0.f)),
                  s2 = sinf(__fadd_rn(x2, 0.f));
      const float c0 = sinf(__fadd_rn(x0, half_pi)), c1 = sinf(__fadd_rn(x1, half_pi)),
                  c2 = sinf(__fadd_rn(x2, half_pi));
      dst[1 + 3 * f] = PePair<T>::make(pend, s0);
      dst[2 + 3 * f] = PePair<T>::make(s1, s2);
      dst[3 + 3 * f] = PePair<T>::make(c0, c1);
      pend = c2;
      fr = __fmul_rn(fr, 2.f);  // exact: the next power of two
    }
    dst[1 + 3 * nf] = PePair<T>::make(pend, sv[3 * t]);
    dst[2 + 3 * nf] = PePair<T>::make(sv[3 * t + 1], sv[3 * t + 2]);
  }
  __syncthreads();
  // the block's rows are one contiguous run of `out`, starting on 16 bytes
  const int bytes = rows * pairs * (int)sizeof(P), vecs = bytes / 16;
  int4* o16 = reinterpret_cast<int4*>(out + row0 * 2 * pairs);
  const int4* s16 = reinterpret_cast<const int4*>(stage);
  for (int i = t; i < vecs; i += PE_ROWS) o16[i] = s16[i];
  uint32_t* o4 = reinterpret_cast<uint32_t*>(o16 + vecs);
  const uint32_t* s4 = reinterpret_cast<const uint32_t*>(s16 + vecs);
  for (int i = t; i < (bytes % 16) / 4; i += PE_ROWS) o4[i] = s4[i];
}

// dynamic shared memory of a block: base and viewdirs, then the staging
// buffer of PE_ROWS rows
static inline size_t pe_smem_bytes(int nf, int out_f32) {
  return (size_t)6 * PE_ROWS * 4 + (size_t)PE_ROWS * (3 * nf + 3) * (out_f32 ? 8 : 4);
}

template <typename T>
static int pe_launch(const float* base, const float* vd, T* out, long long m, int nf, float f0,
                     float half_pi, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(posenc_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (m + PE_ROWS - 1) / PE_ROWS;
  posenc_kernel<T><<<(unsigned)blocks, PE_ROWS, smem, stream>>>(base, vd, out, m, nf, f0, half_pi);
  return (int)cudaGetLastError();
}

extern "C" {

size_t pnt_posenc_smem_bytes(int nf, int out_f32) { return pe_smem_bytes(nf, out_f32); }

// Launch on `stream`: base and vd (M, 3) float32 and out (M, 6 nf + 6),
// bf16 or (out_f32) float32, every pointer on 16 bytes; f0 the first
// frequency and half_pi the cosines' phase, as float32. Returns
// cudaGetLastError() or a refusal.
int pnt_posenc(const void* base, const void* vd, void* out, long long m, int nf, float f0,
               float half_pi, int out_f32, void* stream) {
  if (m < 1 || nf < 1 || (m + PE_ROWS - 1) / PE_ROWS > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(base) | reinterpret_cast<uintptr_t>(vd) |
                      reinterpret_cast<uintptr_t>(out);
  if (a % 16) return (int)cudaErrorMisalignedAddress;
  const size_t smem = pe_smem_bytes(nf, out_f32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(base);
  const float* v = static_cast<const float*>(vd);
  return out_f32 ? pe_launch(b, v, static_cast<float*>(out), m, nf, f0, half_pi, smem, s)
                 : pe_launch(b, v, static_cast<bf16*>(out), m, nf, f0, half_pi, smem, s);
}

}  // extern "C"
