"""The cotangents the backward chain (`csrc/bwd_chain.cuh`) hands the
weight-gradient products, in their plain version
(`resnetfc_cotangents_plain`), at the narrow width the card tests use.

Two facts the kernel's design rests on, held here on the CPU:
- every weight and bias gradient of the plain backward is `act^T @ G` (or a
  column sum) of these bf16 cotangents with the stash, in the layout the
  kernel writes (so the card tests can hold the kernel's cotangents to
  them), and those gradients are the Pallas kernel's;
- the cotangent at injection i's point is Gin for i = 0 and G1 of block
  i - 1 otherwise, so the kernel's one g_z product after the chain reads
  tiles it has already written: the latent weight and bias gradients taken
  from those written slots are the Pallas backward's (`_fused_bwd_impl`,
  which computes each injection's cotangent in its own tile), and dz from
  them is the Pallas kernel's dz.
Against the plain backward the comparisons are exact or within float32
summation order (1e-6 relative): both sides are the same plain arithmetic.
Against the Pallas VJP (interpret mode) they take the tolerances of
tests/test_torch_resnetfc.py: bf16 roundings of other summation orders
travel through the blocks, 2e-2 of the largest magnitude at worst and a
relative Frobenius error of 1e-2 (dz one bf16 ulp more).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.ops.resnetfc_pallas import ResnetFCWeights
from pixelnerf_tpu.ops.resnetfc_pallas import resnetfc_fused as j_fused

from pixelnerf_tpu_torch.ops.field import FieldWeights
from pixelnerf_tpu_torch.ops.resnetfc import (
    _dot_g, _dot_t, _rows, resnetfc_bwd_plain, resnetfc_cotangents_plain, resnetfc_fwd_plain,
    stash_layout,
)

HIDDEN, D_LATENT, D_IN, D_OUT, N_BLOCKS = 64, 64, 42, 4, 5


def _case(ns, sb, b, seed):
    rng = np.random.default_rng(seed)
    combine = 3 if ns > 1 else 1000
    n_inj = min(combine, N_BLOCKS)
    t = lambda *shape, scale=0.3: torch.from_numpy(rng.normal(size=shape, scale=scale).astype(np.float32))
    w = FieldWeights(
        w_in=t(D_IN, HIDDEN), b_in=t(HIDDEN), wz=t(n_inj, D_LATENT, HIDDEN), bz=t(n_inj, HIDDEN),
        w0=t(N_BLOCKS, HIDDEN, HIDDEN), b0=t(N_BLOCKS, HIDDEN), w1=t(N_BLOCKS, HIDDEN, HIDDEN),
        b1=t(N_BLOCKS, HIDDEN), w_out=t(HIDDEN, D_OUT), b_out=t(D_OUT),
    )
    z = t(sb, ns, b, D_LATENT, scale=1.0).to(torch.bfloat16)
    xin = t(sb, ns, b, D_IN, scale=1.0).to(torch.bfloat16)
    g = t(sb, b, D_OUT, scale=1.0)
    _, spre, spost = resnetfc_fwd_plain(z, xin, w, N_BLOCKS, combine, ns, stash=True)
    return combine, w, z, xin, g, spre, spost


def _pallas_grads(w, z, xin, g, combine, ns):
    """dz and the weight gradients of the Pallas kernel's VJP (interpret
    mode) on the same inputs."""
    import jax

    jw = ResnetFCWeights(**{
        k: jnp.asarray(v.numpy()[None] if k in ("b_in", "b_out") else v.numpy())
        for k, v in w._asdict().items()
    })
    jz = jnp.asarray(z.float().numpy(), jnp.bfloat16)
    jx = jnp.asarray(xin.float().numpy(), jnp.bfloat16)
    jfn = lambda zz, ww: j_fused(zz, jx, ww, N_BLOCKS, combine, ns, True)
    _, vjp = jax.vjp(jfn, jz, jw)
    jdz, jdw = vjp(jnp.asarray(g.numpy()))
    return np.asarray(jdz.astype(jnp.float32)), jdw


def _pallas_close(got, want, extra_ulp=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32).reshape(got.shape)
    scale = np.abs(want).max() + 1e-12
    tol = 2e-2 * scale + (2.0 ** -7 * np.abs(want) if extra_ulp else 0.0)
    assert np.all(np.abs(got - want) <= tol)
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want) + 1e-12


@pytest.mark.parametrize("ns,sb,b", [(1, 2, 37), (2, 2, 19), (3, 1, 22), (5, 1, 7)])
def test_cotangents_give_the_weight_gradients(ns, sb, b):
    combine, w, z, xin, g, spre, spost = _case(ns, sb, b, 10 * ns + b)
    args = (N_BLOCKS, combine, ns)
    _, _, dw = resnetfc_bwd_plain(z, xin, g, spre, spost, w, *args)
    gpre, gpost, gin, gout = resnetfc_cotangents_plain(g, spre, spost, w, *args)
    k, m = stash_layout(*args)
    n_inj = min(combine, N_BLOCKS)
    assert gpost.shape == (2 * m, sb, b, HIDDEN) and gin.shape == (sb, ns, b, HIDDEN)
    assert (gpre is None) == (k == 0) and gout.shape == (sb, b, 16)
    assert torch.equal(gout[..., :D_OUT], g.to(torch.bfloat16)) and not gout[..., D_OUT:].any()
    close = lambda a, b_: torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-6)

    def slot(blk, h1, stash=True):
        pre = blk < k
        arr = (spre if pre else spost) if stash else (gpre if pre else gpost)
        return arr[h1 * (k if pre else m) + (blk if pre else blk - k)]

    for blk in range(N_BLOCKS):
        close(dw.w1[blk], _dot_g(slot(blk, 1), slot(blk, 0, stash=False)))
        close(dw.w0[blk], _dot_g(slot(blk, 0), slot(blk, 1, stash=False)))
    zz, xx = (z[:, 0], xin[:, 0]) if ns == 1 else (z, xin)
    gi = gin[:, 0] if ns == 1 else gin
    close(dw.w_in, _dot_g(xx, gi))
    close(dw.w_out, _dot_g(spost[2 * m], gout[..., :D_OUT]))
    for i in range(n_inj):
        cot = gi if i == 0 else slot(i - 1, 0, stash=False)
        close(dw.wz[i], _dot_g(zz, cot))
    # and those gradients are the Pallas kernel's
    _, jdw = _pallas_grads(w, z, xin, g, combine, ns)
    for blk in range(N_BLOCKS):
        _pallas_close(_dot_g(slot(blk, 1), slot(blk, 0, stash=False)), jdw.w1[blk])
        _pallas_close(_dot_g(slot(blk, 0), slot(blk, 1, stash=False)), jdw.w0[blk])
        _pallas_close(_rows(slot(blk, 0, stash=False).float()), jdw.b1[blk])
        _pallas_close(_rows(slot(blk, 1, stash=False).float()), jdw.b0[blk])
    _pallas_close(_dot_g(xx, gi), jdw.w_in)
    _pallas_close(_dot_g(spost[2 * m], gout[..., :D_OUT]), jdw.w_out)


@pytest.mark.parametrize("ns,sb,b", [(1, 1, 30), (2, 2, 19), (3, 1, 22)])
def test_injection_cotangents_are_written_tiles(ns, sb, b):
    combine, w, z, xin, g, spre, spost = _case(ns, sb, b, 100 + ns)
    args = (N_BLOCKS, combine, ns)
    gpre, gpost, gin, _ = resnetfc_cotangents_plain(g, spre, spost, w, *args)
    k, _ = stash_layout(*args)
    n_inj = min(combine, N_BLOCKS)
    zz = z[:, 0] if ns == 1 else z
    gi = gin[:, 0] if ns == 1 else gin
    # the written slots the kernel's g_z product reads: Gin, then G1 of
    # block i - 1 (pre-pool rows while i - 1 < k)
    tiles = [gi] + [gpre[i - 1] if i - 1 < k else gpost[i - 1 - k] for i in range(1, n_inj)]
    jdz, jdw = _pallas_grads(w, z, xin, g, combine, ns)
    for i, t in enumerate(tiles):
        _pallas_close(_dot_g(zz, t), jdw.wz[i])
        _pallas_close(_rows(t.float()), jdw.bz[i])
    dz = sum(_dot_t(t, w.wz[i]) for i, t in enumerate(tiles))
    _pallas_close(dz if ns > 1 else dz[:, None], jdz, extra_ulp=True)
