"""Port parity: the fused field's VJP (ops/field.py).

The plain versions of `pyramid_field_fused_fwd_stash` and
`pyramid_field_fused_bwd` (CPU tensors) are held against the VJP of the
Pallas kernel `pyramid_field_fused(..., interpret=True)` on the same numpy
inputs, at tests/test_field_pallas.py's shapes: bf16 levels 8x8x16,
4x4x24 and 2x2x32 (composed taps on the coarser ones), grid points on and
beyond the border, hidden 32, non-zero fc_1, NS = 1, 2 and 3, a point
count that is not a multiple of the TPU kernel's tile (b=50), and
combine_layer 1000 with NS=1; and a grid of ray-coherent runs of points,
as a train step's samples along rays.

Tolerances. Both sides gather z with the same rounded tap weights, cast
every matmul operand to bf16 and sum in float32, in other orders: the
forward is held to 2e-2 absolute plus 2e-2 relative on outputs of O(1),
and each gradient to 2e-2 of its largest magnitude at worst and a relative
Frobenius error of 1e-2 (tests/test_torch_resnetfc.py), dxin and the bf16
level gradients one more bf16 ulp (2^-7 relative). The level gradients
carry, besides, the interpret-mode scatter's rounding of each product
w * g to bf16 (tests/test_torch_pyramid.py): 2^-7 of the sum of |w * g|
over each element's contributions.

Inside the port, the fused field and the two-kernel composition
(`pyramid_index_train` + `resnetfc_fused`) run the same plain arithmetic,
so their outputs and every gradient agree bit for bit, as
tests/test_field_pallas.py:65-108 asserts of the TPU kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.ops.field_pallas import pyramid_field_fused as j_field
from pixelnerf_tpu.ops.resnetfc_pallas import ResnetFCWeights
from pixelnerf_tpu_torch.ops.field import (
    FieldWeights, pyramid_field_fused, pyramid_field_fused_bwd, pyramid_field_fused_fwd_stash,
)
from pixelnerf_tpu_torch.ops.pyramid import pyramid_index_train, pyramid_scatter_add
from pixelnerf_tpu_torch.ops.resnetfc import resnetfc_fused, stash_layout
from tests.scatter_uv import ray_uv

SHAPES = [(8, 8, 16), (4, 4, 24), (2, 2, 32)]
LEVELS = [tuple(s) for s in SHAPES]
D_LATENT = sum(c for (_, _, c) in SHAPES)
D_IN, HIDDEN, D_OUT = 42, 32, 4
BF16_ULP = 2.0 ** -7
CASES = [  # sb, ns, b, n_blocks, combine_layer
    (2, 2, 32, 5, 3),
    (1, 1, 32, 3, 1000),  # one view, an injection in every block
    (1, 3, 50, 4, 2),  # 50 points: not a multiple of the tile
]
# the VJP's cases: random grids, and one of ray-coherent runs of points (as
# a train step's samples along rays), which the level scatter merges
VJP_CASES = [pytest.param(*case, "random", id="-".join(map(str, case))) for case in CASES] + [
    pytest.param(2, 2, 96, 5, 3, "rays", id="2-2-96-5-3-rays"),
]


def _inputs(seed, sb, ns, b, n_blocks, combine, kind="random"):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(sb * ns, h, w, c)).astype(np.float32) for (h, w, c) in SHAPES]
    if kind == "rays":
        grid = ray_uv(rng, sb * ns, b, 1.0 / SHAPES[0][1]).reshape(sb, ns, b, 2)
    else:
        grid = rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)).astype(np.float32)
        grid[:, :, 0] = -1.0
        grid[:, :, 1] = 1.0
    xin = rng.normal(size=(sb, ns, b, D_IN)).astype(np.float32)
    n_inj = min(combine, n_blocks)

    def m(shape, fan_in):
        return rng.normal(size=shape, scale=1.0 / np.sqrt(fan_in)).astype(np.float32)

    w = dict(
        w_in=m((D_IN, HIDDEN), D_IN), b_in=m((HIDDEN,), 10),
        wz=m((n_inj, D_LATENT, HIDDEN), D_LATENT), bz=m((n_inj, HIDDEN), 10),
        w0=m((n_blocks, HIDDEN, HIDDEN), HIDDEN), b0=m((n_blocks, HIDDEN), 10),
        w1=m((n_blocks, HIDDEN, HIDDEN), HIDDEN), b1=m((n_blocks, HIDDEN), 10),
        w_out=m((HIDDEN, D_OUT), HIDDEN), b_out=m((D_OUT,), 10),
    )
    g = rng.normal(size=(sb, b, D_OUT)).astype(np.float32)
    return feats, grid, xin, w, g


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _grad_close(got, want, extra=0.0):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = 2e-2 * (np.abs(want).max() + 1e-12) + extra
    assert np.all(np.abs(got - want) <= tol)
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want) + 1e-12


@pytest.mark.parametrize("sb,ns,b,n_blocks,combine,kind", VJP_CASES)
def test_field_vjp_matches_pallas(sb, ns, b, n_blocks, combine, kind):
    feats, grid, xin, w, g = _inputs(sb * 100 + ns * 10 + n_blocks, sb, ns, b, n_blocks, combine, kind)
    jw = ResnetFCWeights(
        **{k: jnp.asarray(v[None] if k in ("b_in", "b_out") else v) for k, v in w.items()}
    )
    jfeats = tuple(jnp.asarray(f, jnp.bfloat16) for f in feats)
    jfn = lambda fs, x, ww: j_field(fs, jnp.asarray(grid), x, ww, n_blocks, combine, ns, True)
    jout, vjp = jax.vjp(jfn, jfeats, jnp.asarray(xin, jnp.bfloat16), jw)
    jd_feats, jdx, jdw = vjp(jnp.asarray(g))

    tw = FieldWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    tgrid, txin = torch.from_numpy(grid), _bf16(xin)
    before = (pyramid_field_fused_fwd_stash.launches, pyramid_field_fused_bwd.launches)
    out, zstash, spre, spost = pyramid_field_fused_fwd_stash(
        [_bf16(f) for f in feats], tgrid, txin, tw, n_blocks, combine, ns,
    )
    k, m = stash_layout(n_blocks, combine, ns)
    assert zstash.shape == (sb, ns, b, D_LATENT) and zstash.dtype == torch.bfloat16
    assert (spre is None) == (k == 0) and spost.shape == (2 * m + 1, sb, b, HIDDEN)
    d_feats, dxin, dw = pyramid_field_fused_bwd(
        tgrid, txin, torch.from_numpy(g), zstash, spre, spost, tw, n_blocks, combine, ns, LEVELS,
    )
    # CPU tensors: the plain versions, no kernel
    assert (pyramid_field_fused_fwd_stash.launches, pyramid_field_fused_bwd.launches) == before

    want = np.asarray(jout)
    assert out.shape == (sb, b, D_OUT) and np.abs(want).mean() > 0.3
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-2, atol=2e-2)
    assert dxin.dtype == torch.bfloat16
    jdx = np.asarray(jdx.astype(jnp.float32))
    _grad_close(dxin.float(), jdx, BF16_ULP * np.abs(jdx))
    # the interpret-mode scatter's bf16 products: 2^-7 of sum |w * g|
    dz_abs = resnetfc_dz_abs(zstash, txin, g, spre, spost, tw, n_blocks, combine, ns)
    mags = pyramid_scatter_add(
        tgrid.reshape(sb * ns, b, 2), dz_abs, [c for *_, c in LEVELS],
        [(h, ww) for h, ww, _ in LEVELS], LEVELS[0][:2],
    )
    for got, jd, mag, (h, ww, c) in zip(d_feats, jd_feats, mags, LEVELS):
        assert got.shape == (sb * ns, h, ww, c) and got.dtype == torch.bfloat16
        jd = np.asarray(jd.astype(jnp.float32))
        _grad_close(got.float(), jd, BF16_ULP * (mag.numpy() + np.abs(jd)))
    for name in FieldWeights._fields:
        got = getattr(dw, name)
        assert got.dtype == torch.float32 and got.shape == getattr(tw, name).shape, name
        _grad_close(got, np.asarray(getattr(jdw, name)).reshape(got.shape))


def resnetfc_dz_abs(zstash, xin, g, spre, spost, w, n_blocks, combine, ns):
    """|dz| (SB*NS, B, d_latent) of the plain backward: the size of each
    cotangent the level gradients sum."""
    from pixelnerf_tpu_torch.ops.resnetfc import resnetfc_bwd_plain

    dz = resnetfc_bwd_plain(zstash, xin, torch.from_numpy(g), spre, spost, w, n_blocks, combine, ns)[0]
    sb, _, b, dl = zstash.shape
    return dz.abs().reshape(sb * ns, b, dl)


@pytest.mark.parametrize("sb,ns,b,n_blocks,combine", CASES)
def test_fused_field_equals_two_kernel_composition(sb, ns, b, n_blocks, combine):
    """Forward and every gradient of the autograd entry points, bit for
    bit: `pyramid_field_fused` against `pyramid_index_train` +
    `resnetfc_fused`; the grid's gradient is zero."""
    feats, grid, xin, w, g = _inputs(7 + ns, sb, ns, b, n_blocks, combine)

    def run(fused):
        tf = [_bf16(f).requires_grad_(True) for f in feats]
        tx = _bf16(xin).requires_grad_(True)
        tw = FieldWeights(**{k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()})
        tgrid = torch.from_numpy(grid).requires_grad_(True)
        if fused:
            out = pyramid_field_fused(tf, tgrid, tx, tw, n_blocks, combine, ns)
        else:
            z = pyramid_index_train(tf, tgrid.reshape(sb * ns, b, 2))
            out = resnetfc_fused(z.reshape(sb, ns, b, D_LATENT), tx, tw, n_blocks, combine, ns)
        torch.sin(out).sum().backward()
        assert not tgrid.grad.any()
        return [out.detach()] + [t.grad for t in (*tf, tx, *tw)]

    for got, want in zip(run(True), run(False)):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_field_primal_without_grad_and_stash_under_autograd(monkeypatch):
    """Without a gradient wanted the entry point runs the primal (no stash);
    with one it runs the stash forward once and, on backward, the backward
    once; inputs that want no gradient get none."""
    import pixelnerf_tpu_torch.ops.field as ops_field

    sb, ns, b, n_blocks, combine = CASES[0]
    feats, grid, xin, w, g = _inputs(3, sb, ns, b, n_blocks, combine)
    calls = []
    for name in ("pyramid_field_fused_fwd_stash", "pyramid_field_fused_bwd", "field_plain"):
        orig = getattr(ops_field, name)
        monkeypatch.setattr(
            ops_field, name, lambda *a, _o=orig, _n=name, **kw: calls.append(_n) or _o(*a, **kw)
        )
    tw = FieldWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    args = ([_bf16(f) for f in feats], torch.from_numpy(grid), _bf16(xin))
    with torch.no_grad():
        primal = pyramid_field_fused(*args, tw, n_blocks, combine, ns)
    assert calls == ["field_plain"]
    calls.clear()
    tw = tw._replace(w0=tw.w0.clone().requires_grad_(True))
    out = pyramid_field_fused(*args, tw, n_blocks, combine, ns)
    out.backward(torch.from_numpy(g))
    assert calls[0] == "pyramid_field_fused_fwd_stash" and calls[-1] == "pyramid_field_fused_bwd"
    assert torch.equal(out.detach(), primal)
    assert tw.w0.grad is not None and tw.w0.grad.norm() > 0 and tw.w1.grad is None
