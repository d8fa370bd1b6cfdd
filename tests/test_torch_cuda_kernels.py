"""The port's hand-written kernels against their plain versions, on the
card (`cuda` marker: skips where no GPU is present).

Run on a machine with an NVIDIA Hopper GPU:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: posenc, one bf16 ulp at the largest |value| (< 4): 2^-6; the
field and the ResnetFC forward, 2e-2 absolute plus 2e-2 relative on
outputs of O(1) — both sides use bf16 operands and float32 sums, in
different orders, so an activation may round to a neighbouring bf16 value
and carry that through the blocks; every ResnetFC gradient, 2e-2 of its
largest magnitude at worst and 1e-2 relative in Frobenius norm (bf16 dz
and dxin one bf16 ulp more). The pyramid gather: one bf16 ulp plus 1e-6
(the same exact products summed in another order); the scatter: 1e-4
relative plus 1e-5 (float32 atomics add in any order). The bilerp gather
and scatter as the pyramid's. The field's stash forward: its output as the
field's, its z-stash one bf16 ulp of the plain gather; its backward, from
the kernel's own stash, every gradient as the ResnetFC backward's, the
bf16 level gradients one more bf16 ulp. The backward chain
(`csrc/bwd_chain.cuh`) at each width it is built for: every gradient and
every bf16 cotangent it hands the weight-gradient products within
chip_smoke.py's GRAD_MAX (5e-2 of the largest magnitude) and GRAD_FRO (2e-2
Frobenius) of the plain backward from the same stash: its f32 sums run in
another order (g_z as one product after the chain, the bias sums as
shuffle trees) through five blocks. The weight-gradient products
(`csrc/wgrad.cuh`) against their plain version on the kernel's own stash
and bf16 cotangents: both sides multiply the same bf16 operands exactly and
differ only in the order of their float32 sums, so within 1e-4 of each
gradient's largest magnitude and 1e-5 relative in Frobenius norm; and two
runs of the backward give bit-identical weight gradients.
"""

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.ops import resnetfc as ops_resnetfc
from pixelnerf_tpu_torch.ops.field import (
    FieldWeights, field_bwd_plain, field_plain, pyramid_field_fused, pyramid_field_fused_bwd,
    pyramid_field_fused_fwd_stash,
)
from pixelnerf_tpu_torch.ops.pyramid import (
    pyramid_gather, pyramid_gather_plain, pyramid_scatter_add, pyramid_scatter_add_plain,
)
from pixelnerf_tpu_torch.ops.resnetfc import (
    resnetfc_bwd, resnetfc_bwd_plain, resnetfc_cotangents_plain, resnetfc_fwd, resnetfc_fwd_plain,
    resnetfc_fwd_stash, resnetfc_wgrad_plain, stash_layout,
)
from pixelnerf_tpu_torch.ops.scatter import (
    bilerp_gather, bilerp_gather_plain, bilerp_scatter_add, bilerp_scatter_add_plain,
)
from pixelnerf_tpu_torch.utils.hocon import loads
from pixelnerf_tpu_torch.ops.posenc import posenc_concat, posenc_concat_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_posenc_kernel_matches_plain(cuda):
    g = torch.Generator(device="cpu").manual_seed(0)
    base = torch.randn((5000, 3), generator=g).to(cuda)
    vd = torch.randn((5000, 3), generator=g).to(cuda)
    before = posenc_concat.launches
    got = posenc_concat(base, vd, 6, 1.5)
    torch.cuda.synchronize()
    assert posenc_concat.launches == before + 1
    want = posenc_concat_plain(base, vd, 6, 1.5)
    assert got.shape == want.shape == (5000, 42) and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 2.0 ** -6


@pytest.mark.parametrize(
    "ns,sb,b", [(1, 2, 50), (2, 1, 64), (2, 2, 37), (3, 1, 45), (5, 2, 13), (20, 1, 7)]
)
def test_field_kernel_matches_plain(cuda, ns, sb, b):
    rng = np.random.default_rng(ns * 100 + b)
    shapes = [(16, 16, 32), (8, 8, 32), (4, 4, 64)]
    d_in, hidden, n_blocks, combine = 42, 64, 5, 3
    d_latent = sum(c for (_, _, c) in shapes)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dtype)

    feats = [t(rng.normal(size=(sb * ns, h, w, c)), torch.bfloat16) for (h, w, c) in shapes]
    grid = t(rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)))
    xin = t(rng.normal(size=(sb, ns, b, d_in)), torch.bfloat16)

    def m(*shape):
        return t(rng.normal(size=shape, scale=1.0 / np.sqrt(shape[-2] if len(shape) > 1 else 10)))

    w = FieldWeights(
        w_in=m(d_in, hidden), b_in=m(hidden), wz=m(3, d_latent, hidden), bz=m(3, hidden),
        w0=m(n_blocks, hidden, hidden), b0=m(n_blocks, hidden),
        w1=m(n_blocks, hidden, hidden), b1=m(n_blocks, hidden),
        w_out=m(hidden, 4), b_out=m(4),
    )
    before = pyramid_field_fused.launches
    got = pyramid_field_fused(feats, grid, xin, w, n_blocks, combine, ns)
    torch.cuda.synchronize()
    assert pyramid_field_fused.launches == before + 1
    want = field_plain(feats, grid, xin, w, n_blocks, combine, ns)
    assert got.shape == want.shape == (sb, b, 4)
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_field_kernel_raises_past_its_shared_memory(cuda):
    """At the flagship width a tile of 65 views (more rows than the 64-row
    tile holds) does not fit in shared memory: the wrapper raises instead
    of launching."""
    ns, d_in, hidden, d_latent = 65, 42, 512, 512
    z = lambda *shape: torch.zeros(shape, device=cuda)
    w = FieldWeights(
        w_in=z(d_in, hidden), b_in=z(hidden), wz=z(3, d_latent, hidden), bz=z(3, hidden),
        w0=z(5, hidden, hidden), b0=z(5, hidden), w1=z(5, hidden, hidden), b1=z(5, hidden),
        w_out=z(hidden, 4), b_out=z(4),
    )
    feats = [z(ns, 8, 8, d_latent).to(torch.bfloat16)]
    before = pyramid_field_fused.launches
    with pytest.raises(ValueError, match="shared memory"):
        pyramid_field_fused(feats, z(1, ns, 4, 2), z(1, ns, 4, d_in).to(torch.bfloat16), w, 5, 3, ns)
    assert pyramid_field_fused.launches == before


QUERY_CONF = """
model {
    dtype = bfloat16
    use_xyz = True
    use_code = True
    code {
        num_freqs = 6
        freq_factor = 1.5
        include_input = True
    }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse {
        type = resnet
        n_blocks = 5
        d_hidden = 64
        combine_layer = 3
    }
    mlp_fine {
        type = resnet
        n_blocks = 5
        d_hidden = 64
        combine_layer = 3
    }
    encoder {
        backbone = resnet34
        num_layers = 4
    }
}
"""


def test_query_three_views_launches_the_field_kernel(cuda):
    """Three source views go through the fused field kernel on the card
    (not the per-layer path), and agree with the CPU plain versions of the
    same model at the slice's bf16 tolerance (5e-2 on sigmoid/relu
    outputs, see test_torch_slice.py)."""
    import copy

    from pixelnerf_tpu_torch.models.pixelnerf import make_model

    rng = np.random.default_rng(3)
    model = make_model(loads(QUERY_CONF)["model"], device=cuda, seed=0)
    with torch.no_grad():
        for mlp in (model.mlp_coarse, model.mlp_fine):
            for i in range(mlp.n_blocks):
                fc1 = getattr(mlp, f"block_{i}").fc_1.weight
                fc1.copy_(torch.randn(fc1.shape) * 0.1)
            # outputs of O(1), off the sigmoid's flat ends: the random
            # trunk's latents are O(10), so scale the output layer down and
            # take out the part common to all hidden units
            w_out = mlp.lin_out.weight
            w_out.mul_(0.1).sub_(w_out.mean(dim=1, keepdim=True))
    images = torch.from_numpy(rng.uniform(-1, 1, size=(1, 3, 32, 32, 3)).astype(np.float32))
    poses = torch.eye(4).repeat(1, 3, 1, 1)
    poses[0, :, 2, 3] = torch.tensor([1.3, 1.4, 1.5])
    xyz = torch.from_numpy(rng.uniform(-0.3, 0.3, size=(1, 50, 3)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(1, 50, 3)).astype(np.float32)), dim=-1)

    fused = model.with_field_fusion()
    model_cpu = copy.deepcopy(model).to("cpu").with_field_fusion()
    with torch.no_grad():
        enc = fused.encode(images, poses, 35.0)
        assert enc.num_views == 3 and isinstance(enc.latent, tuple)
        before = pyramid_field_fused.launches
        got = fused.query(enc, xyz.to(cuda), vd.to(cuda), coarse=False)
        torch.cuda.synchronize()
        assert pyramid_field_fused.launches == before + 1
        want = model_cpu.query(enc.to("cpu"), xyz, vd, coarse=False)
    assert got.shape == want.shape == (1, 50, 4)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=5e-2)


PYR_SHAPES = [(16, 16, 64), (4, 4, 64), (2, 2, 128)]


@pytest.mark.parametrize("ns", [1, 2, 3, 5])
def test_pyramid_kernels_match_plain(cuda, ns):
    rng = np.random.default_rng(ns)
    b, n = 2 * ns, 1000 + ns
    csizes = [c for (_, _, c) in PYR_SHAPES]
    hws = [(h, w) for (h, w, _) in PYR_SHAPES]
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feats = [t(rng.normal(size=(b, h, w, c)), torch.bfloat16) for (h, w, c) in PYR_SHAPES]
    uv = t(rng.uniform(-1.2, 1.2, size=(b, n, 2)))
    before = pyramid_gather.launches
    got = pyramid_gather(feats, uv)
    torch.cuda.synchronize()
    assert pyramid_gather.launches == before + 1
    want = pyramid_gather_plain(feats, uv)
    assert got.shape == want.shape == (b, n, sum(csizes)) and got.dtype == torch.bfloat16
    diff = (got.float() - want.float()).abs()
    assert (diff <= 2.0 ** -7 * want.float().abs() + 1e-6).all()
    dz, dz2 = (t(rng.normal(size=(b, n, sum(csizes))), torch.bfloat16) for _ in range(2))
    for second in (None, dz2):
        before = pyramid_scatter_add.launches
        got = pyramid_scatter_add(uv, dz, csizes, hws, hws[0], dz2=second)
        torch.cuda.synchronize()
        assert pyramid_scatter_add.launches == before + 1
        want = pyramid_scatter_add_plain(uv, dz, csizes, hws, hws[0], dz2=second)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def _mlp_case(rng, cuda, ns, sb, b, hidden=64, d_latent=64, n_blocks=5, combine=3):
    d_in = 42
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    m = lambda *shape: t(rng.normal(size=shape, scale=1.0 / np.sqrt(shape[-2] if len(shape) > 1 else 10)))
    n_inj = min(combine, n_blocks)
    w = FieldWeights(
        w_in=m(d_in, hidden), b_in=m(hidden), wz=m(n_inj, d_latent, hidden), bz=m(n_inj, hidden),
        w0=m(n_blocks, hidden, hidden), b0=m(n_blocks, hidden),
        w1=m(n_blocks, hidden, hidden), b1=m(n_blocks, hidden), w_out=m(hidden, 4), b_out=m(4),
    )
    z = t(rng.normal(size=(sb, ns, b, d_latent)), torch.bfloat16)
    xin = t(rng.normal(size=(sb, ns, b, d_in)), torch.bfloat16)
    g = t(rng.normal(size=(sb, b, 4)))
    return z, xin, w, g


def _grad_close(got, want, extra_ulp=False):
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape
    tol = 2e-2 * want.abs().max() + (2.0 ** -7 * want.abs() if extra_ulp else 0.0)
    assert ((got - want).abs() <= tol).all()
    assert (got - want).norm() <= 1e-2 * want.norm() + 1e-12


@pytest.mark.parametrize("ns,sb,b", [(1, 2, 50), (2, 2, 37), (3, 1, 45), (5, 2, 13)])
def test_resnetfc_kernels_match_plain(cuda, ns, sb, b):
    rng = np.random.default_rng(ns * 100 + b)
    combine = 3 if ns > 1 else 1000
    z, xin, w, g = _mlp_case(rng, cuda, ns, sb, b, combine=combine)
    n_blocks = 5
    before = (resnetfc_fwd.launches, resnetfc_fwd_stash.launches, resnetfc_bwd.launches)
    out = resnetfc_fwd(z, xin, w, n_blocks, combine, ns)
    out_s, spre, spost = resnetfc_fwd_stash(z, xin, w, n_blocks, combine, ns)
    dz, dxin, dw = resnetfc_bwd(z, xin, g, spre, spost, w, n_blocks, combine, ns)
    torch.cuda.synchronize()
    assert (resnetfc_fwd.launches, resnetfc_fwd_stash.launches, resnetfc_bwd.launches) == tuple(
        x + 1 for x in before
    )
    want, wpre, wpost = resnetfc_fwd_plain(z, xin, w, n_blocks, combine, ns, stash=True)
    assert torch.equal(out, out_s) and out.shape == (sb, b, 4)
    torch.testing.assert_close(out, want, rtol=2e-2, atol=2e-2)
    assert (spre is None) == (wpre is None) and spost.shape == wpost.shape
    # the plain backward from the kernel's stash (the backwards then differ
    # only in their own rounding)
    wdz, wdxin, wdw = resnetfc_bwd_plain(z, xin, g, spre, spost, w, n_blocks, combine, ns)
    _grad_close(dz, wdz, extra_ulp=True)
    _grad_close(dxin, wdxin, extra_ulp=True)
    for name in FieldWeights._fields:
        _grad_close(getattr(dw, name), getattr(wdw, name))


def test_failed_resnetfc_launch_raises(cuda, monkeypatch):
    """A launch the card refuses (here: more shared memory than a block
    may have, past the wrapper's own check) raises; nothing is counted."""
    rng = np.random.default_rng(0)
    z, xin, w, _ = _mlp_case(rng, cuda, 65, 1, 4, hidden=512, d_latent=512)
    monkeypatch.setattr(ops_resnetfc, "SMEM_LIMIT", 1 << 30)
    before = resnetfc_fwd.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        resnetfc_fwd(z, xin, w, 5, 3, 65)
    assert resnetfc_fwd.launches == before


FIELD_SHAPES = [(16, 16, 32), (8, 8, 32), (4, 4, 64)]


@pytest.mark.parametrize("ns,sb,b", [(1, 2, 50), (2, 2, 37), (3, 1, 45), (5, 2, 13)])
def test_field_vjp_kernels_match_plain(cuda, ns, sb, b):
    """The field's stash forward and its backward against their plain
    versions (the backward from the kernel's own stash), every gradient."""
    rng = np.random.default_rng(ns * 10 + b)
    combine, n_blocks = (3 if ns > 1 else 1000), 5
    d_latent = sum(c for (_, _, c) in FIELD_SHAPES)
    z, xin, w, g = _mlp_case(rng, cuda, ns, sb, b, d_latent=d_latent, combine=combine)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feats = [t(rng.normal(size=(sb * ns, h, ww, c)), torch.bfloat16) for (h, ww, c) in FIELD_SHAPES]
    grid = rng.uniform(-1.2, 1.2, size=(sb, ns, b, 2))
    grid[:, :, :2] = [[1.0, 1.0], [-1.0, 1.0]]
    grid = t(grid)
    args = (n_blocks, combine, ns)
    before = (pyramid_field_fused_fwd_stash.launches, pyramid_field_fused_bwd.launches)
    out, zs, spre, spost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)
    d_feats, dxin, dw = pyramid_field_fused_bwd(
        grid, xin, g, zs, spre, spost, w, *args, FIELD_SHAPES,
    )
    torch.cuda.synchronize()
    assert (pyramid_field_fused_fwd_stash.launches, pyramid_field_fused_bwd.launches) == tuple(
        x + 1 for x in before
    )
    assert torch.equal(out, pyramid_field_fused(feats, grid, xin, w, *args))
    want, wz, wpre, wpost = field_plain(feats, grid, xin, w, *args, stash=True)
    torch.testing.assert_close(out, want, rtol=2e-2, atol=2e-2)
    assert zs.shape == wz.shape and (spre is None) == (wpre is None) and spost.shape == wpost.shape
    assert ((zs.float() - wz.float()).abs() <= 2.0 ** -7 * wz.float().abs() + 1e-6).all()
    wd_feats, wdxin, wdw = field_bwd_plain(grid, xin, g, zs, spre, spost, w, *args, FIELD_SHAPES)
    for got, ref in zip(d_feats, wd_feats):
        assert got.dtype == torch.bfloat16
        _grad_close(got, ref, extra_ulp=True)
    _grad_close(dxin, wdxin, extra_ulp=True)
    for name in FieldWeights._fields:
        _grad_close(getattr(dw, name), getattr(wdw, name))


@pytest.mark.parametrize("b,hl,wl,c,n", [(2, 5, 7, 8, 33), (3, 64, 64, 64, 1001), (1, 8, 8, 512, 513)])
def test_bilerp_kernels_match_plain(cuda, b, hl, wl, c, n):
    rng = np.random.default_rng(n)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feat = t(rng.normal(size=(b, hl, wl, c)), torch.bfloat16)
    uv = rng.uniform(-1.3, 1.3, size=(b, n, 2))
    uv[:, :4] = [[1.0, 1.0], [-1.0, -1.0], [1.0, -0.3], [-0.5, 1.0]]
    uv = t(uv)
    before = bilerp_gather.launches
    got = bilerp_gather(feat, uv)
    torch.cuda.synchronize()
    assert bilerp_gather.launches == before + 1
    want = bilerp_gather_plain(feat, uv)
    assert got.shape == want.shape == (b, n, c) and got.dtype == torch.bfloat16
    assert ((got.float() - want.float()).abs() <= 2.0 ** -7 * want.float().abs() + 1e-6).all()
    dz = t(rng.normal(size=(b, n, c)), torch.bfloat16)
    before = bilerp_scatter_add.launches
    got = bilerp_scatter_add(uv, dz, hl, wl)
    torch.cuda.synchronize()
    assert bilerp_scatter_add.launches == before + 1
    torch.testing.assert_close(got, bilerp_scatter_add_plain(uv, dz, hl, wl), rtol=1e-4, atol=1e-5)


# The wgmma forward chain (csrc/fwd_chain.cuh) at the flagship width: hidden
# 512, d_latent 512 (srn.conf's three packed levels), d_in 42. Outputs as
# chip_smoke.py holds them (3e-2 + 3e-2 |plain|: bf16 operands and float32
# sums in other orders through five 512-wide blocks); every gradient of the
# backward from the kernel's stash within 5e-2 of its largest magnitude and
# 2e-2 Frobenius of the plain backward from the same stash (chip_smoke.py's
# GRAD_MAX, GRAD_FRO). Each NS has a B that is not a multiple of the tile's
# max(1, 64 // NS) points, and one B is smaller than a tile.
WIDE_LEVELS = [(64, 64, 128), (16, 16, 128), (8, 8, 256)]
WIDE_CASES = [(1, 1, 100), (2, 2, 45), (2, 1, 5), (3, 1, 50), (5, 2, 9)]


def _wide_weights(rng, cuda, d_in=42, hidden=512, d_latent=512, n_blocks=5, combine=3):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    m = lambda scale, *shape: t(rng.normal(size=shape, scale=scale))
    n_inj = min(combine, n_blocks)
    return FieldWeights(
        w_in=m(d_in ** -0.5, d_in, hidden), b_in=m(0.1, hidden),
        wz=m(d_latent ** -0.5, n_inj, d_latent, hidden), bz=m(0.1, n_inj, hidden),
        w0=m(hidden ** -0.5, n_blocks, hidden, hidden), b0=m(0.1, n_blocks, hidden),
        w1=m(0.5 * hidden ** -0.5, n_blocks, hidden, hidden), b1=m(0.1, n_blocks, hidden),
        w_out=m(hidden ** -0.5, hidden, 4), b_out=m(0.1, 4),
    )


def _out_close(got, want):
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert ((got - want).abs() <= 3e-2 + 3e-2 * want.abs()).all()


def _grad_within(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 5e-2 * want.abs().max() + 1e-30
    assert (got - want).norm() <= 2e-2 * want.norm() + 1e-30


@pytest.mark.parametrize("ns,sb,b", WIDE_CASES)
def test_resnetfc_forward_chain_flagship_width(cuda, ns, sb, b):
    rng = np.random.default_rng(1000 + ns * 100 + b)
    combine = 3 if ns > 1 else 1000
    w = _wide_weights(rng, cuda, combine=combine)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, torch.bfloat16)
    z, xin = t(rng.normal(size=(sb, ns, b, 512))), t(rng.normal(size=(sb, ns, b, 42)))
    g = torch.from_numpy(rng.normal(size=(sb, b, 4)).astype(np.float32)).to(cuda)
    args = (5, combine, ns)
    before = (resnetfc_fwd.launches, resnetfc_fwd_stash.launches)
    out = resnetfc_fwd(z, xin, w, *args)
    out_s, spre, spost = resnetfc_fwd_stash(z, xin, w, *args)
    torch.cuda.synchronize()
    assert (resnetfc_fwd.launches, resnetfc_fwd_stash.launches) == tuple(x + 1 for x in before)
    assert torch.equal(out, out_s)
    want, wpre, wpost = resnetfc_fwd_plain(z, xin, w, *args, stash=True)
    _out_close(out, want)
    assert (spre is None) == (wpre is None) and spost.shape == wpost.shape
    dz, dxin, dw = resnetfc_bwd(z, xin, g, spre, spost, w, *args)
    wdz, wdxin, wdw = resnetfc_bwd_plain(z, xin, g, spre, spost, w, *args)
    _grad_within(dz, wdz)
    _grad_within(dxin, wdxin)
    for name in FieldWeights._fields:
        _grad_within(getattr(dw, name), getattr(wdw, name))


@pytest.mark.parametrize("ns,sb,b", WIDE_CASES)
def test_field_forward_chain_flagship_width(cuda, ns, sb, b):
    rng = np.random.default_rng(2000 + ns * 100 + b)
    combine = 3 if ns > 1 else 1000
    w = _wide_weights(rng, cuda, combine=combine)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feats = [t(rng.normal(size=(sb * ns, h, ww, c)), torch.bfloat16) for (h, ww, c) in WIDE_LEVELS]
    grid = t(rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)))
    xin = t(rng.normal(size=(sb, ns, b, 42)), torch.bfloat16)
    g = t(rng.normal(size=(sb, b, 4)) * 1e-3)
    args = (5, combine, ns)
    before = (pyramid_field_fused.launches, pyramid_field_fused_fwd_stash.launches)
    out = pyramid_field_fused(feats, grid, xin, w, *args)
    out_s, zs, spre, spost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)
    torch.cuda.synchronize()
    assert (pyramid_field_fused.launches, pyramid_field_fused_fwd_stash.launches) == tuple(
        x + 1 for x in before
    )
    assert torch.equal(out, out_s)
    want, wz, wpre, wpost = field_plain(feats, grid, xin, w, *args, stash=True)
    _out_close(out, want)
    assert torch.equal(zs, pyramid_gather_plain(feats, grid.reshape(sb * ns, b, 2)).reshape(zs.shape))
    assert (spre is None) == (wpre is None) and spost.shape == wpost.shape
    d_feats, dxin, dw = pyramid_field_fused_bwd(grid, xin, g, zs, spre, spost, w, *args, WIDE_LEVELS)
    wd_feats, wdxin, wdw = field_bwd_plain(grid, xin, g, zs, spre, spost, w, *args, WIDE_LEVELS)
    for got, ref in zip(d_feats, wd_feats):
        _grad_within(got, ref)
    _grad_within(dxin, wdxin)
    for name in FieldWeights._fields:
        _grad_within(getattr(dw, name), getattr(wdw, name))


def test_resnetfc_forward_raises_on_widths_the_chain_lacks(cuda):
    """hidden 384 is not a width the chain is built for: the wrapper raises
    before launching."""
    rng = np.random.default_rng(5)
    z, xin, w, _ = _mlp_case(rng, cuda, 2, 1, 8, hidden=384, d_latent=64)
    before = resnetfc_fwd.launches
    with pytest.raises(ValueError, match="d_hidden"):
        resnetfc_fwd(z, xin, w, 5, 3, 2)
    assert resnetfc_fwd.launches == before


# The chains at every width they are built for. The backward's d_latent is
# the field's levels' sum: srn.conf's 512 from hidden 128 up, 128 at hidden
# 64, whose 768-wide cases run g_z in two passes (512 + 256 columns).
CHAIN_WIDTHS = [64, 128, 256, 512]
CHAIN_LEVELS = {64: FIELD_SHAPES, 768: [(16, 16, 256), (8, 8, 256), (4, 4, 256)]}


def _levels_for(hidden, d_latent=None):
    if d_latent is not None:
        return CHAIN_LEVELS[d_latent]
    return FIELD_SHAPES if hidden == 64 else WIDE_LEVELS


def _chain_case(rng, cuda, hidden, ns, sb, b, levels):
    combine = 3 if ns > 1 else 1000
    d_latent = sum(c for (_, _, c) in levels)
    w = _wide_weights(rng, cuda, hidden=hidden, d_latent=d_latent, combine=combine)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    z = t(rng.normal(size=(sb, ns, b, d_latent)), torch.bfloat16)
    xin = t(rng.normal(size=(sb, ns, b, 42)), torch.bfloat16)
    g = t(rng.normal(size=(sb, b, 4)))
    return (5, combine, ns), w, z, xin, g


BWD_CASES = [(1, 1, 100), (2, 2, 45), (2, 1, 5), (3, 1, 50), (5, 2, 9)]


@pytest.mark.parametrize("hidden", CHAIN_WIDTHS)
@pytest.mark.parametrize("ns,sb,b", BWD_CASES)
def test_backward_chain_matches_plain(cuda, hidden, ns, sb, b):
    """dz, dxin, every weight and bias gradient and the bf16 cotangents
    (gpre, gpost, gin, gout) that the weight-gradient products read, from
    the kernel forward's stash; B ragged against the tile's points, or
    smaller than one tile."""
    rng = np.random.default_rng(3000 + hidden + ns * 100 + b)
    args, w, z, xin, g = _chain_case(rng, cuda, hidden, ns, sb, b, _levels_for(hidden))
    _, spre, spost = resnetfc_fwd_stash(z, xin, w, *args)
    before = resnetfc_bwd.launches
    dz, dxin, dw = resnetfc_bwd(z, xin, g, spre, spost, w, *args)
    torch.cuda.synchronize()
    assert resnetfc_bwd.launches == before + 1
    wdz, wdxin, wdw = resnetfc_bwd_plain(z, xin, g, spre, spost, w, *args)
    _grad_within(dz, wdz)
    _grad_within(dxin, wdxin)
    for name in FieldWeights._fields:
        _grad_within(getattr(dw, name), getattr(wdw, name))
    cots = ops_resnetfc.launch_bwd(z, xin, g, spre, spost, w, *args)[3]
    torch.cuda.synchronize()
    wcots = resnetfc_cotangents_plain(g, spre, spost, w, *args)
    for got, want in zip(cots, wcots):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.dtype == torch.bfloat16
            _grad_within(got, want)


@pytest.mark.parametrize("hidden", CHAIN_WIDTHS)
@pytest.mark.parametrize("ns,sb,b", BWD_CASES)
def test_backward_chain_level_scatter_matches_plain(cuda, hidden, ns, sb, b):
    """The field's epilogue: bf(g_z) scattered onto the native levels."""
    rng = np.random.default_rng(4000 + hidden + ns * 100 + b)
    levels = _levels_for(hidden)
    args, w, _, xin, g = _chain_case(rng, cuda, hidden, ns, sb, b, levels)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feats = [t(rng.normal(size=(sb * ns, h, ww, c)), torch.bfloat16) for (h, ww, c) in levels]
    grid = t(rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)))
    _, zs, spre, spost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)
    before = pyramid_field_fused_bwd.launches
    d_feats, dxin, dw = pyramid_field_fused_bwd(grid, xin, g, zs, spre, spost, w, *args, levels)
    torch.cuda.synchronize()
    assert pyramid_field_fused_bwd.launches == before + 1
    wd_feats, wdxin, wdw = field_bwd_plain(grid, xin, g, zs, spre, spost, w, *args, levels)
    for got, ref in zip(d_feats, wd_feats):
        _grad_within(got, ref)
    _grad_within(dxin, wdxin)
    for name in FieldWeights._fields:
        _grad_within(getattr(dw, name), getattr(wdw, name))


WGRAD_WEIGHTS = ("w_in", "wz", "w0", "w1", "w_out")


def _wgrad_run(rng, cuda, hidden, ns, sb, b, field):
    """One backward through `launch_bwd` (with the field's level epilogue
    when `field`): its weight gradients and the plain version's on the
    kernel's own stash and cotangents."""
    levels = _levels_for(hidden)
    args, w, z, xin, g = _chain_case(rng, cuda, hidden, ns, sb, b, levels)
    if field:
        t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
        feats = [t(rng.normal(size=(sb * ns, h, ww, c)), torch.bfloat16) for (h, ww, c) in levels]
        grid = t(rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)))
        _, z, spre, spost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)
        run = lambda: ops_resnetfc.launch_bwd(z, xin, g, spre, spost, w, *args, levels=levels, grid=grid)
    else:
        _, spre, spost = resnetfc_fwd_stash(z, xin, w, *args)
        run = lambda: ops_resnetfc.launch_bwd(z, xin, g, spre, spost, w, *args)
    before = ops_resnetfc.launch_bwd.wgrad_launches
    _, _, dw, cots = run()
    torch.cuda.synchronize()
    assert ops_resnetfc.launch_bwd.wgrad_launches == before + 2
    want = resnetfc_wgrad_plain(z, xin, spre, spost, *cots, *args, g.shape[-1])
    return dw, want, run


@pytest.mark.parametrize("field", [False, True])
@pytest.mark.parametrize("hidden", CHAIN_WIDTHS)
@pytest.mark.parametrize("ns,sb,b", BWD_CASES)
def test_wgrad_matches_plain_on_its_own_cotangents(cuda, hidden, ns, sb, b, field):
    """Every weight gradient of the grouped products and their reduction
    against `resnetfc_wgrad_plain` on the same bf16 stash and cotangents, at
    every chain width, B ragged or below one tile, with and without the
    field's epilogue; two launches (products, reduction) a call."""
    rng = np.random.default_rng(7000 + hidden + ns * 100 + b + 50 * field)
    dw, want, _ = _wgrad_run(rng, cuda, hidden, ns, sb, b, field)
    for name in WGRAD_WEIGHTS:
        got, ref = getattr(dw, name).cpu(), want[name].cpu()
        assert got.shape == ref.shape and torch.isfinite(got).all(), name
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max() + 1e-30, name
        assert (got - ref).norm() <= 1e-5 * ref.norm() + 1e-30, name


@pytest.mark.parametrize("field", [False, True])
def test_wgrad_is_deterministic(cuda, field):
    """Enough points for several splits a product: two runs of the backward
    give bit-identical weight gradients (each split's partial stored apart,
    summed in a fixed order)."""
    rng = np.random.default_rng(7500 + field)
    dw, _, run = _wgrad_run(rng, cuda, 512, 2, 2, 3000, field)
    assert ops_resnetfc.launch_bwd.wgrad_plan["splits"][0] > 1
    again = run()[2]
    torch.cuda.synchronize()
    for name in WGRAD_WEIGHTS:
        assert torch.equal(getattr(dw, name), getattr(again, name)), name


@pytest.mark.parametrize("ns,sb,b", [(1, 1, 70), (2, 2, 45)])
def test_backward_chain_latent_passes(cuda, ns, sb, b):
    """d_latent 768 at hidden 64: g_z in two passes, both epilogues."""
    rng = np.random.default_rng(5000 + ns)
    levels = _levels_for(64, 768)
    args, w, z, xin, g = _chain_case(rng, cuda, 64, ns, sb, b, levels)
    _, spre, spost = resnetfc_fwd_stash(z, xin, w, *args)
    dz, dxin, dw = resnetfc_bwd(z, xin, g, spre, spost, w, *args)
    wdz, wdxin, wdw = resnetfc_bwd_plain(z, xin, g, spre, spost, w, *args)
    _grad_within(dz, wdz)
    _grad_within(dxin, wdxin)
    for name in FieldWeights._fields:
        _grad_within(getattr(dw, name), getattr(wdw, name))
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feats = [t(rng.normal(size=(sb * ns, h, ww, c)), torch.bfloat16) for (h, ww, c) in levels]
    grid = t(rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)))
    _, zs, spre, spost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)
    d_feats = pyramid_field_fused_bwd(grid, xin, g, zs, spre, spost, w, *args, levels)[0]
    wd_feats = field_bwd_plain(grid, xin, g, zs, spre, spost, w, *args, levels)[0]
    for got, ref in zip(d_feats, wd_feats):
        _grad_within(got, ref)


@pytest.mark.parametrize("hidden", [128, 256])
@pytest.mark.parametrize("ns,sb,b", WIDE_CASES)
def test_forward_chains_at_hidden_128_and_256(cuda, hidden, ns, sb, b):
    """The ResnetFC and field forwards (primal and stash) at the widths the
    chain now takes besides 64 and 512."""
    rng = np.random.default_rng(6000 + hidden + ns * 100 + b)
    args, w, z, xin, _ = _chain_case(rng, cuda, hidden, ns, sb, b, WIDE_LEVELS)
    before = (resnetfc_fwd.launches, pyramid_field_fused.launches)
    out = resnetfc_fwd(z, xin, w, *args)
    out_s, spre, spost = resnetfc_fwd_stash(z, xin, w, *args)
    want, wpre, wpost = resnetfc_fwd_plain(z, xin, w, *args, stash=True)
    assert torch.equal(out, out_s)
    _out_close(out, want)
    assert (spre is None) == (wpre is None) and spost.shape == wpost.shape
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feats = [t(rng.normal(size=(sb * ns, h, ww, c)), torch.bfloat16) for (h, ww, c) in WIDE_LEVELS]
    grid = t(rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)))
    fout = pyramid_field_fused(feats, grid, xin, w, *args)
    fout_s = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)[0]
    torch.cuda.synchronize()
    assert (resnetfc_fwd.launches, pyramid_field_fused.launches) == tuple(x + 1 for x in before)
    assert torch.equal(fout, fout_s)
    _out_close(fout, field_plain(feats, grid, xin, w, *args))


def test_resnetfc_backward_raises_on_widths_the_chain_lacks(cuda):
    """hidden 384: the backward wrapper raises before launching, as the
    forward's."""
    rng = np.random.default_rng(6)
    z, xin, w, g = _mlp_case(rng, cuda, 2, 1, 8, hidden=384, d_latent=64)
    k, m = stash_layout(5, 3, 2)
    spre = torch.zeros((2 * k, 1, 2, 8, 384), dtype=torch.bfloat16, device=cuda)
    spost = torch.zeros((2 * m + 1, 1, 8, 384), dtype=torch.bfloat16, device=cuda)
    before = resnetfc_bwd.launches
    with pytest.raises(ValueError, match="d_hidden"):
        resnetfc_bwd(z, xin, g, spre, spost, w, 5, 3, 2)
    assert resnetfc_bwd.launches == before


def test_chains_refuse_past_64_views(cuda):
    """65 views at hidden 64 fit shared memory but not one 64-row tile: both
    launches are refused, nothing is counted."""
    rng = np.random.default_rng(7)
    z, xin, w, g = _mlp_case(rng, cuda, 65, 1, 3)
    k, m = stash_layout(5, 3, 65)
    spre = torch.zeros((2 * k, 1, 65, 3, 64), dtype=torch.bfloat16, device=cuda)
    spost = torch.zeros((2 * m + 1, 1, 3, 64), dtype=torch.bfloat16, device=cuda)
    before = (resnetfc_fwd.launches, resnetfc_bwd.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        resnetfc_fwd(z, xin, w, 5, 3, 65)
    with pytest.raises(RuntimeError, match="launch failed"):
        resnetfc_bwd(z, xin, g, spre, spost, w, 5, 3, 65)
    assert (resnetfc_fwd.launches, resnetfc_bwd.launches) == before
