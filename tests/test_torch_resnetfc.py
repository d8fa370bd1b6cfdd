"""Port parity: the fused ResnetFC module, forward and backward.

`pixelnerf_tpu_torch.ops.resnetfc.resnetfc_fused` on CPU tensors runs the
plain versions of its kernels (the stash forward under autograd, the
backward from the stash). It is held against the Pallas kernel
`resnetfc_fused(..., interpret=True)` and its custom VJP on the same numpy
inputs: bf16 z and x, float32 weights with non-zero fc_1, 3 blocks pooling
at block 2 (1 for NS=1), hidden 32, at NS = 1, 2 and 3 and point counts
that the TPU kernel pads to its tile.

Tolerances. Both sides cast every matmul operand to bf16, the cotangents
of the weight-gradient products included, and sum in float32, but in other
orders: where a float32 value lies within an ulp of a bf16 rounding
boundary the two round apart, and that bf16 step (2^-8 to 2^-7 relative)
travels through the blocks. The forward is held to 2e-2 absolute plus 2e-2 relative on
outputs of O(1); each gradient to 2e-2 of its largest magnitude at worst
and a relative Frobenius error of 1e-2; dz and dxin, which the kernels
return in bf16, one more bf16 ulp (2^-7 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.ops.resnetfc_pallas import ResnetFCWeights
from pixelnerf_tpu.ops.resnetfc_pallas import resnetfc_fused as j_fused
from pixelnerf_tpu_torch.ops.field import FieldWeights
from pixelnerf_tpu_torch.ops.resnetfc import (
    resnetfc_bwd, resnetfc_fused, resnetfc_fwd, resnetfc_fwd_stash, stash_layout,
    supported_config,
)

D_IN, D_LATENT, HIDDEN, D_OUT, N_BLOCKS = 42, 48, 32, 4, 3


def _weights(rng, n_inj):
    def m(shape, fan_in):
        return rng.normal(size=shape, scale=1.0 / np.sqrt(fan_in)).astype(np.float32)

    return dict(
        w_in=m((D_IN, HIDDEN), D_IN), b_in=m((HIDDEN,), 10),
        wz=m((n_inj, D_LATENT, HIDDEN), D_LATENT), bz=m((n_inj, HIDDEN), 10),
        w0=m((N_BLOCKS, HIDDEN, HIDDEN), HIDDEN), b0=m((N_BLOCKS, HIDDEN), 10),
        w1=m((N_BLOCKS, HIDDEN, HIDDEN), HIDDEN), b1=m((N_BLOCKS, HIDDEN), 10),
        w_out=m((HIDDEN, D_OUT), HIDDEN), b_out=m((D_OUT,), 10),
    )


def _grad_close(got, want, extra_ulp=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-12
    tol = 2e-2 * scale + (2.0 ** -7 * np.abs(want) if extra_ulp else 0.0)
    assert np.all(np.abs(got - want) <= tol)
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want) + 1e-12


def _case(ns, sb, b, seed):
    rng = np.random.default_rng(seed)
    combine = 2 if ns > 1 else 1
    w = _weights(rng, min(combine, N_BLOCKS))
    z = rng.normal(size=(sb, ns, b, D_LATENT)).astype(np.float32)
    xin = rng.normal(size=(sb, ns, b, D_IN)).astype(np.float32)
    g = rng.normal(size=(sb, b, D_OUT)).astype(np.float32)
    return combine, w, z, xin, g


@pytest.mark.parametrize("ns,sb,b", [(1, 2, 37), (2, 2, 40), (3, 1, 21)])
def test_forward_and_gradients_match_pallas(ns, sb, b):
    combine, w, z, xin, g = _case(ns, sb, b, 10 * ns + b)
    jw = ResnetFCWeights(
        **{k: jnp.asarray(v[None] if k in ("b_in", "b_out") else v) for k, v in w.items()}
    )
    jfn = lambda zz, xx, ww: j_fused(zz, xx, ww, N_BLOCKS, combine, ns, True)
    jout, vjp = jax.vjp(jfn, jnp.asarray(z, jnp.bfloat16), jnp.asarray(xin, jnp.bfloat16), jw)
    jdz, jdx, jdw = vjp(jnp.asarray(g))

    tz = torch.from_numpy(z).to(torch.bfloat16).requires_grad_(True)
    tx = torch.from_numpy(xin).to(torch.bfloat16).requires_grad_(True)
    tw = FieldWeights(**{k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()})
    before = (resnetfc_fwd.launches, resnetfc_fwd_stash.launches, resnetfc_bwd.launches)
    out = resnetfc_fused(tz, tx, tw, N_BLOCKS, combine, ns)
    out.backward(torch.from_numpy(g))
    # CPU tensors: the plain versions, no kernel
    assert (resnetfc_fwd.launches, resnetfc_fwd_stash.launches, resnetfc_bwd.launches) == before

    want = np.asarray(jout)
    assert out.shape == (sb, b, D_OUT) and out.dtype == torch.float32
    assert np.abs(want).mean() > 0.3  # the chain is not trivial
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-2, atol=2e-2)
    assert tz.grad.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16
    _grad_close(tz.grad.float(), jdz.astype(jnp.float32), extra_ulp=True)
    _grad_close(tx.grad.float(), jdx.astype(jnp.float32), extra_ulp=True)
    for name in FieldWeights._fields:
        got = getattr(tw, name).grad
        want = np.asarray(getattr(jdw, name)).reshape(got.shape)
        _grad_close(got, want)


def test_stash_free_forward_without_grad():
    """Without autograd the forward writes no stash; with it the stash
    forward gives the same output and the documented stash shapes."""
    ns, sb, b = 2, 1, 9
    combine, w, z, xin, _ = _case(ns, sb, b, 5)
    tz, tx = torch.from_numpy(z).to(torch.bfloat16), torch.from_numpy(xin).to(torch.bfloat16)
    tw = FieldWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    with torch.no_grad():
        plain = resnetfc_fused(tz, tx, tw, N_BLOCKS, combine, ns)
    out, spre, spost = resnetfc_fwd_stash(tz, tx, tw, N_BLOCKS, combine, ns)
    k, m = stash_layout(N_BLOCKS, combine, ns)
    assert (k, m) == (2, 1)
    assert spre.shape == (2 * k, sb, ns, b, HIDDEN) and spost.shape == (2 * m + 1, sb, b, HIDDEN)
    assert spre.dtype == spost.dtype == torch.bfloat16 and (spre >= 0).all()
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_supported_config_mirrors_pallas():
    from pixelnerf_tpu.ops.resnetfc_pallas import supported_config as j_supported

    cases = [
        (0.0, False, "average", 512, 42, 3, 5, 2), (0.0, False, "average", 512, 42, 5, 5, 2),
        (0.0, False, "average", 512, 42, 5, 5, 1), (0.0, False, "max", 512, 42, 3, 5, 2),
        (1.0, False, "average", 512, 42, 3, 5, 2), (0.0, True, "average", 512, 42, 3, 5, 2),
        (0.0, False, "average", 0, 42, 3, 5, 2), (0.0, False, "average", 512, 42, 0, 5, 1),
        (0.0, False, "average", 512, 42, 3, 5, None),
    ]
    for c in cases:
        assert supported_config(*c) == j_supported(*c), c
