// ResnetFC forward on a (z, x) pair, with an optional bf16 stash.
//
// Replaces the TPU kernels pixelnerf_tpu/ops/resnetfc_pallas.py:
// `_fwd_kernel` (the primal, `_fused_fwd_impl`) when the stash pointers
// are null, and `_fwd_stash_kernel` (`_fused_fwd_stash_impl`, the forward
// of the custom VJP) when they are given. What it computes, and the stash
// layout: fwd_chain.cuh.
//
// Bound on the H100: operations (as field_fwd.cu: ~11.6 MFLOP of bf16
// products a point at the flagship width and NS=2, against ~1 KB of z);
// with the stash it also writes ~17 KB a point, ~1/20 of the time the
// products need at the bf16 peak.
//
// Design: fwd_chain.cuh's wgmma chain on TMA-fed weight tiles, the z tile
// loaded by the consumer threads into its swizzled K-major layout, 16 bytes
// a thread (a TMA box a view would need P rows to start on a 1024-byte
// swizzle atom, which P = 21 at NS = 3 breaks). The stash forward is the
// primal's code with the stash copies switched on, so both write the same
// output bit for bit.

#include "fwd_chain.cuh"

template <int H>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    resnetfc_fwd_kernel(const __grid_constant__ ChainParams p,
                        const __grid_constant__ ChainMaps maps, const bf16* z) {
  run_chain<H>(p, maps, [&](unsigned char* Z, int s, int p0, int c0, int nc, bool) {
    // the z tile (latent columns [c0, c0 + nc)), rows view-major; rows past
    // the last point or past NS * P are zero; eight 16-byte loads in flight
    // a thread before their stores
    const int DL = p.d_latent, P = p.pts, rows = p.ns * P, chunks = nc / 8;
    for (int e0 = threadIdx.x; e0 < FWD_ROWS * chunks; e0 += 8 * FWD_CONSUMERS) {
      uint4 val[8];
#pragma unroll
      for (int i = 0; i < 8; i++) {
        const int e = e0 + i * FWD_CONSUMERS, r = e / chunks, j = e % chunks;
        const int v = r / P, pt = p0 + r % P;
        val[i] = make_uint4(0, 0, 0, 0);
        if (e < FWD_ROWS * chunks && r < rows && pt < p.b)
          val[i] = *reinterpret_cast<const uint4*>(z + (((size_t)s * p.ns + v) * p.b + pt) * DL +
                                                   c0 + j * 8);
      }
#pragma unroll
      for (int i = 0; i < 8; i++) {
        const int e = e0 + i * FWD_CONSUMERS;
        if (e < FWD_ROWS * chunks)
          *reinterpret_cast<uint4*>(Z + sw128_offset(e / chunks, (e % chunks) * 8)) = val[i];
      }
    }
  });
}

template <int H>
static int launch(const ChainParams& p, const ChainMaps& maps, const void* z, size_t smem,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(resnetfc_fwd_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_dim((p.b + p.pts - 1) / p.pts, p.sb);
  resnetfc_fwd_kernel<H><<<grid_dim, FWD_THREADS, smem, stream>>>(p, maps,
                                                                  static_cast<const bf16*>(z));
  return (int)cudaGetLastError();
}

extern "C" {

size_t pnt_resnetfc_fwd_smem_bytes(int hidden, int d_latent, int d_in_pad, int ns) {
  return fwd_smem_bytes(hidden, d_latent, ns);
}

// counts[0]: the ring stages one tile walks, counts[1]: the drains of the
// tensor pipe its consumers make (fwd_chain.cuh:fwd_schedule)
void pnt_resnetfc_fwd_schedule(int hidden, int d_latent, int d_in_pad, int ns, int n_blocks,
                               int combine_layer, int* counts) {
  fwd_schedule(hidden, d_latent, d_in_pad, ns, n_blocks,
               combine_layer < n_blocks ? combine_layer : n_blocks, &counts[0], &counts[1]);
}

// Launches the kernel on `stream` (stash written when spost is not null);
// returns cudaGetLastError(), or cudaErrorInvalidValue for a width the
// chain is not built for.
int pnt_resnetfc_fwd(const void* z, const void* xin, const void* w_in,
                     const void* b_in, const void* wz, const void* bz,
                     const void* w0, const void* b0, const void* w1,
                     const void* b1, const void* w_out, const void* b_out,
                     void* out, void* spre, void* spost, int sb, int ns, int b,
                     int d_latent, int d_in, int d_in_pad, int hidden,
                     int d_out, int n_blocks, int combine_layer, void* stream) {
  ChainParams p;
  ChainMaps maps;
  const int err = chain_setup(&p, &maps, xin, w_in, b_in, wz, bz, w0, b0, w1, b1, w_out, b_out,
                              out, spre, spost, sb, ns, b, d_latent, d_in, d_in_pad, hidden,
                              d_out, n_blocks, combine_layer);
  if (err) return err;
  const size_t smem = fwd_smem_bytes(hidden, d_latent, ns);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_hidden(
      hidden, [&](auto h) { return launch<decltype(h)::value>(p, maps, z, smem, st); });
}

}  // extern "C"
