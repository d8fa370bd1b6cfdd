"""The plain version of the weight-gradient kernel (`csrc/wgrad.cuh`):
`resnetfc_wgrad_plain`, at the narrow width the card tests use (hidden 64,
d_latent 64), on the plain chain's bf16 cotangents
(`resnetfc_cotangents_plain`).

- Its gradients are the Pallas VJP's (`resnetfc_fused` in interpret mode),
  within the tolerances of tests/test_torch_bwd_chain.py: bf16 roundings of
  other summation orders travel through the blocks, 2e-2 of the largest
  magnitude at worst and a relative Frobenius error of 1e-2.
- Its packed latent product, z^T [Gin | G1_0 | ...], equals the per-injection
  products within float32 summation order (1e-6 relative), and every
  gradient equals the plain backward's (the same bf16 operands, sums in
  another order: 1e-6).
"""

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.ops.resnetfc import (
    _dot_g, resnetfc_bwd_plain, resnetfc_cotangents_plain, resnetfc_wgrad_plain, stash_layout,
)
from tests.test_torch_bwd_chain import D_OUT, N_BLOCKS, _case, _pallas_close, _pallas_grads

CASES = [(1, 2, 37), (2, 2, 19), (3, 1, 22), (5, 1, 7)]
WEIGHTS = ("w_in", "wz", "w0", "w1", "w_out")


def _wgrad(ns, sb, b, seed):
    combine, w, z, xin, g, spre, spost = _case(ns, sb, b, seed)
    args = (N_BLOCKS, combine, ns)
    cots = resnetfc_cotangents_plain(g, spre, spost, w, *args)
    dw = resnetfc_wgrad_plain(z, xin, spre, spost, *cots, *args, D_OUT)
    return dw, (combine, w, z, xin, g, spre, spost), cots


@pytest.mark.parametrize("ns,sb,b", CASES)
def test_wgrad_plain_matches_pallas_vjp(ns, sb, b):
    dw, (combine, w, z, xin, g, _, _), _ = _wgrad(ns, sb, b, 200 + 10 * ns + b)
    _, jdw = _pallas_grads(w, z, xin, g, combine, ns)
    for name in WEIGHTS:
        _pallas_close(dw[name], getattr(jdw, name))


@pytest.mark.parametrize("ns,sb,b", CASES)
def test_packed_latent_product_is_the_per_injection_products(ns, sb, b):
    dw, (combine, _, z, _, _, _, _), (gpre, gpost, gin, _) = _wgrad(ns, sb, b, 300 + 10 * ns + b)
    k, _ = stash_layout(N_BLOCKS, combine, ns)
    zz, gi = (z[:, 0], gin[:, 0]) if ns == 1 else (z, gin)
    n_inj = min(combine, N_BLOCKS)
    assert dw["wz"].shape == (n_inj, z.shape[-1], gin.shape[-1])
    for i in range(n_inj):
        cot = gi if i == 0 else (gpre[i - 1] if i - 1 < k else gpost[i - 1 - k])
        torch.testing.assert_close(dw["wz"][i], _dot_g(zz, cot), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ns,sb,b", CASES)
def test_wgrad_plain_is_the_plain_backward(ns, sb, b):
    dw, (combine, w, z, xin, g, spre, spost), _ = _wgrad(ns, sb, b, 400 + 10 * ns + b)
    want = resnetfc_bwd_plain(z, xin, g, spre, spost, w, N_BLOCKS, combine, ns)[2]
    for name in WEIGHTS:
        got = dw[name]
        assert got.dtype == torch.float32 and got.shape == getattr(want, name).shape
        torch.testing.assert_close(got, getattr(want, name), rtol=1e-6, atol=1e-6)
