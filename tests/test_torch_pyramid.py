"""Port parity: the native-pyramid gather and scatter module.

`pixelnerf_tpu_torch.ops.pyramid` on CPU tensors runs its plain versions.
They are held against the Pallas kernels of
`pixelnerf_tpu/ops/pyramid_pallas.py` in interpret mode, on the same numpy
inputs: three levels whose coarser ones need composed taps (16x16 fine,
5x5 and 4x4 native, so coincident taps add), points on the border and
beyond it, point counts that are not a multiple of the TPU kernel's
512-point tile, and 1, 2 or 3 maps per scene (NS source views).

Tolerances. Both sides round the composed tap weights to the feature
dtype the same way and form exact bf16 x bf16 products, so only the order
of the float32 sums differs: the bf16 gather agrees to one bf16 ulp
(at most 2^-7 relative) plus 1e-6, the float32 gather to 1e-6, and the float32
scatter to 1e-5 relative plus 1e-5. The bf16 scatter in interpret mode on
the CPU rounds each product w*g to bf16 before it sums them (measured: the
plain version agrees with a float64 sum of the same products to 3e-7,
the interpret mode to ~1e-3 of the largest value), so there the tolerance
is 2^-7 times the sum of |w*g| over the element's contributions, plus
1e-5, and one more bf16 ulp of the result for the bf16 level gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.ops.pyramid_pallas import (
    pyramid_gather as j_gather,
    pyramid_index_train as j_index,
    pyramid_index_train_dual as j_index_dual,
    pyramid_scatter_add as j_scatter,
)
from pixelnerf_tpu_torch.ops.pyramid import (
    pyramid_gather,
    pyramid_index_train,
    pyramid_index_train_dual,
    pyramid_scatter_add,
    pyramid_supported,
)
from tests.scatter_uv import ray_uv

SHAPES = [(16, 16, 8), (5, 5, 8), (4, 4, 16)]
CSUM = sum(c for (_, _, c) in SHAPES)
BF16_ULP = 2.0 ** -7  # one bf16 ulp of a value, relative: at most 2^-7


def _uv(rng, b, n):
    uv = rng.uniform(-1.3, 1.3, size=(b, n, 2)).astype(np.float32)
    # exact corners, edges and fine-grid knots
    uv[:, 0] = [-1.0, -1.0]
    uv[:, 1] = [1.0, 1.0]
    uv[:, 2] = [1.0, -0.2]
    uv[:, 3] = [-1.0 + 2.0 * 3 / 15, 2.0 * 7 / 15 - 1.0]
    return uv


def _feats(rng, b):
    return [rng.normal(size=(b, h, w, c)).astype(np.float32) for (h, w, c) in SHAPES]


def _j(a, dtype):
    return jnp.asarray(a, dtype=dtype)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-6)


# b = SB * NS maps: NS = 1, 2 and 3 source views; then ray-coherent points
# (runs of samples along rays, about half a fine pixel apart, as a train
# step's lookups see them)
@pytest.mark.parametrize("b,n,rays", [
    pytest.param(2, 37, False, id="2-37"), pytest.param(4, 130, False, id="4-130"),
    pytest.param(3, 515, False, id="3-515"), pytest.param(2, 515, True, id="2-515-rays"),
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gather_matches_pallas(b, n, rays, dtype):
    rng = np.random.default_rng(b * 1000 + n + rays)
    feats = _feats(rng, b)
    uv = ray_uv(rng, b, n, 1.0 / 15) if rays else _uv(rng, b, n)
    want = np.asarray(
        j_gather([_j(f, getattr(jnp, dtype)) for f in feats], jnp.asarray(uv), interpret=True)
        .astype(jnp.float32)
    )
    got = pyramid_gather([_t(f, getattr(torch, dtype)) for f in feats], torch.from_numpy(uv))
    assert got.shape == (b, n, CSUM) and got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        _close_ulp(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


CSIZES = [c for (_, _, c) in SHAPES]
HWS = [(h, w) for (h, w, _) in SHAPES]


def _product_bound(uv, g):
    """Per element of the level gradients: 2^-7 * sum of |w * g| (the
    composed weights are non-negative)."""
    mag = pyramid_scatter_add(
        torch.from_numpy(uv), g.abs(), CSIZES, HWS, HWS[0]
    )
    return [BF16_ULP * m.numpy() + 1e-5 for m in mag]


# random points, and ray-coherent ones (runs of samples along rays, about
# half a fine pixel apart, as a train step's lookups see them)
@pytest.mark.parametrize("b,n,rays", [
    pytest.param(2, 37, False, id="2-37"), pytest.param(3, 515, False, id="3-515"),
    pytest.param(2, 515, True, id="2-515-rays"),
])
@pytest.mark.parametrize("dual", [False, True])
def test_scatter_matches_pallas(b, n, rays, dual):
    rng = np.random.default_rng(7 * b + n + rays)
    uv = ray_uv(rng, b, n, 1.0 / 15) if rays else _uv(rng, b, n)
    dz = rng.normal(size=(b, n, CSUM)).astype(np.float32)
    dz2 = rng.normal(size=(b, n, CSUM)).astype(np.float32)
    want = j_scatter(
        jnp.asarray(uv), _j(dz, jnp.bfloat16), CSIZES, HWS, HWS[0], interpret=True,
        dz2=_j(dz2, jnp.bfloat16) if dual else None,
    )
    tdz, tdz2 = _t(dz, torch.bfloat16), _t(dz2, torch.bfloat16)
    got = pyramid_scatter_add(
        torch.from_numpy(uv), tdz, CSIZES, HWS, HWS[0], dz2=tdz2 if dual else None,
    )
    bound = _product_bound(uv, tdz + tdz2 if dual else tdz)
    for g, w, tol, (h, ww, c) in zip(got, want, bound, SHAPES):
        assert g.shape == (b, h, ww, c) and g.dtype == torch.float32
        assert np.all(np.abs(g.numpy() - np.asarray(w)) <= tol)
    # float32 cotangents: no rounding anywhere but the order of the sums
    want = j_scatter(jnp.asarray(uv), jnp.asarray(dz), CSIZES, HWS, HWS[0], interpret=True)
    got = pyramid_scatter_add(torch.from_numpy(uv), torch.from_numpy(dz), CSIZES, HWS, HWS[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dual", [False, True])
def test_index_train_gradients_match_jax(dual):
    """The autograd functions: level gradients from one or two cotangents
    (the dual one hands both to the scatter), cast to bf16; d_uv is zero."""
    rng = np.random.default_rng(11 + dual)
    b, n = 4, 70
    feats, uv = _feats(rng, b), _uv(rng, b, n)
    g1 = rng.normal(size=(b, n, CSUM)).astype(np.float32)
    g2 = rng.normal(size=(b, n, CSUM)).astype(np.float32)

    jf = tuple(_j(f, jnp.bfloat16) for f in feats)
    if dual:
        fn = lambda fs, u: j_index_dual(fs, u, True)
        cot = (_j(g1, jnp.bfloat16), _j(g2, jnp.bfloat16))
    else:
        fn = lambda fs, u: j_index(fs, u, True)
        cot = _j(g1, jnp.bfloat16)
    jout, vjp = jax.vjp(fn, jf, jnp.asarray(uv))
    jd_feats, jd_uv = vjp(cot)

    tf = [_t(f, torch.bfloat16).requires_grad_(True) for f in feats]
    tuv = torch.from_numpy(uv).requires_grad_(True)
    if dual:
        a, c = pyramid_index_train_dual(tf, tuv)
        assert a.data_ptr() == c.data_ptr()
        torch.autograd.backward([a, c], [_t(g1, torch.bfloat16), _t(g2, torch.bfloat16)])
        _close_ulp(c.detach().float().numpy(), np.asarray(jout[1].astype(jnp.float32)))
    else:
        a = pyramid_index_train(tf, tuv)
        a.backward(_t(g1, torch.bfloat16))
    _close_ulp(a.detach().float().numpy(), np.asarray(jout[0] if dual else jout, np.float32))
    assert not np.asarray(jd_uv).any() and not tuv.grad.abs().sum().item()
    gsum = _t(g1, torch.bfloat16) + (_t(g2, torch.bfloat16) if dual else 0)
    for t, j, tol in zip(tf, jd_feats, _product_bound(uv, gsum)):
        assert t.grad.dtype == torch.bfloat16
        want = np.asarray(j.astype(jnp.float32))
        assert np.all(np.abs(t.grad.float().numpy() - want) <= tol + BF16_ULP * np.abs(want))


def test_supported_fine_grid():
    assert pyramid_supported((64, 64)) and pyramid_supported((64, 128))
    assert not pyramid_supported((128, 128))


def test_wrappers_refuse_other_devices():
    meta = lambda *s: torch.empty(s, device="meta")
    before = pyramid_gather.launches, pyramid_scatter_add.launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pyramid_gather([meta(2, 8, 8, 4)], meta(2, 5, 2))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pyramid_scatter_add(meta(2, 5, 2), meta(2, 5, 4), [4], [(8, 8)], (8, 8))
    assert (pyramid_gather.launches, pyramid_scatter_add.launches) == before
