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
// Design: field_fwd.cu's block chain (fwd_chain.cuh) with the gather
// replaced by a load of the bf16 z tile. The stash rows are written from
// the same shared-memory operand tiles the products read, 16 bytes a
// thread.

#include "fwd_chain.cuh"

__global__ void __launch_bounds__(THREADS, 1) resnetfc_fwd_kernel(ChainParams p, const bf16* z) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem m = fwd_smem(smem, p);
  const int DL = p.d_latent, tb = p.tb, B = p.b;
  const int s = blockIdx.y, p0 = blockIdx.x * tb;
  const int rows = p.ns * tb;

  // the z tile, rows view-major; rows past the last point or past ns * tb
  // are zero
  for (int e = threadIdx.x; e < p.rows_pad * (DL / 2); e += THREADS) {
    const int r = e / (DL / 2), c = (e % (DL / 2)) * 2;
    const int v = r / tb, pt = p0 + r % tb;
    __nv_bfloat162 val = __floats2bfloat162_rn(0.f, 0.f);
    if (r < rows && pt < B)
      val = *reinterpret_cast<const __nv_bfloat162*>(
          z + (((size_t)s * p.ns + v) * B + pt) * DL + c);
    *reinterpret_cast<__nv_bfloat162*>(m.Z + r * DL + c) = val;
  }
  load_xin(p, m, s, p0);
  __syncthreads();
  forward_chain(p, m, s, p0);
}

extern "C" {

size_t pnt_resnetfc_fwd_smem_bytes(int hidden, int d_latent, int d_in_pad, int ns) {
  return fwd_smem_bytes(hidden, d_latent, d_in_pad, ns);
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
  const ChainParams p =
      chain_params(xin, w_in, b_in, wz, bz, w0, b0, w1, b1, w_out, b_out, out, spre, spost, sb,
                   ns, b, d_latent, d_in, d_in_pad, hidden, d_out, n_blocks, combine_layer);
  const size_t smem = fwd_smem_bytes(hidden, d_latent, d_in_pad, ns);
  cudaError_t err = cudaFuncSetAttribute(
      resnetfc_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_dim((b + p.tb - 1) / p.tb, sb);
  resnetfc_fwd_kernel<<<grid_dim, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const bf16*>(z));
  return (int)cudaGetLastError();
}

}  // extern "C"
