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
(the same exact products summed in another order); the scatters, and the
field backward's level scatter on the chain's own bf16 cotangent, against
a float64 evaluation of the plain scatter, element by element within the
bound of a float32 sum in any order, n * 2^-24 * sum |w * g| over the n
nonzero terms (ops/scatter_plan.py:scatter_reference): every product of
two bf16 values is exact in float32 and each addition rounds once, in
shared memory, in registers along a run of points, or in vector
reductions in any order; a term dropped or added twice breaks it. The
bilerp gather and scatter as the pyramid's. Past 8,192 pixels the bilerp
kernels take float32 tap weights (a product w * g then rounds once more,
which `scatter_reference` counts) and are held against `grid_sample_2d`
and its autograd backward: the gather within one bf16 ulp plus 1e-6 (the
same float32 products and sums, cast once); the map's bf16 gradient and
grid_sample's each round a float32 sum within the bound of the float64
one, so they lie within 2^-7 of the larger plus twice the bound. posenc at tail sizes as
elsewhere. The field's stash forward: its output as the
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
runs of the backward give bit-identical weight gradients. The layered
pooling: the mean within 1e-5 of the plain one and its bf16 copy within one
bf16 ulp, and both equal to a loop over the views in order; the column sums
of its backward and every gradient of the layered backward bit-identical
from run to run. The backward of a float32 caller (float32 dz and dxin,
the chain's F32 store and the layered path's float32 sums): the bf16
backward's bounds against the plain backward's float32 dz and dxin, and
rounded to bf16 equal to the bf16 backward's bit for bit.
"""

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.ops import resnetfc as ops_resnetfc
from pixelnerf_tpu_torch.ops.layer_chain import (
    layer_bwd, layer_bwd_plain, layer_fwd, layer_fwd_plain, layer_wgrad, layered_bwd, layered_fwd,
    view_pool_bwd, view_pool_bwd_plain, view_pool_fwd, view_pool_fwd_plain,
)
from pixelnerf_tpu_torch.ops.field import (
    FieldWeights, field_bwd_plain, field_plain, pyramid_field_fused, pyramid_field_fused_bwd,
    pyramid_field_fused_fwd_stash,
)
from pixelnerf_tpu_torch.ops.pyramid import (
    _level_taps, pyramid_gather, pyramid_gather_plain, pyramid_scatter_add,
)
from pixelnerf_tpu_torch.ops.resnetfc import (
    resnetfc_bwd, resnetfc_bwd_plain, resnetfc_cotangents_plain, resnetfc_fused, resnetfc_fwd,
    resnetfc_fwd_plain, resnetfc_fwd_stash, resnetfc_wgrad_plain,
)
from pixelnerf_tpu_torch.ops.scatter import _taps as bilerp_taps
from pixelnerf_tpu_torch.models.encoder import index_features
from pixelnerf_tpu_torch.ops.grid_sample import grid_sample_2d
from pixelnerf_tpu_torch.ops.scatter import (
    bilerp_gather, bilerp_gather_plain, bilerp_scatter_add, grid_sample_border_train,
)
from pixelnerf_tpu_torch.ops.scatter_plan import scatter_reference
from pixelnerf_tpu_torch.utils.hocon import loads
from pixelnerf_tpu_torch.ops.posenc import posenc_concat, posenc_concat_plain
from tests.scatter_uv import ray_uv

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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nf", [1, 6])
@pytest.mark.parametrize("m", [1, 127, 129, 2049])
def test_posenc_kernel_at_tails(cuda, m, nf, dtype):
    """Row counts around the kernel's 128-row block (the staging buffer's
    last partial block and its 4-byte tail), one and six frequencies, both
    output dtypes; inputs 4 bytes off a 16-byte boundary are copied first."""
    g = torch.Generator(device="cpu").manual_seed(m + nf)
    base = (torch.randn((m, 3), generator=g) * 3).to(cuda)
    vd = torch.randn((m * 3 + 1,), generator=g).to(cuda)[1:].view(m, 3)
    assert vd.data_ptr() % 16 == 4
    before = posenc_concat.launches
    got = posenc_concat(base, vd, nf, 1.5, out_dtype=dtype)
    torch.cuda.synchronize()
    assert posenc_concat.launches == before + 1
    want = posenc_concat_plain(base, vd, nf, 1.5, out_dtype=dtype)
    assert got.shape == want.shape == (m, 6 * nf + 6) and got.dtype == dtype
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


def test_field_kernel_raises_past_its_shared_memory(cuda, monkeypatch):
    """A tile that does not fit the shared memory a block may have: the
    wrapper raises instead of launching. (65 views, which used to be the
    case, are now refused by the widths check first, `chain_widths_ok`;
    here the flagship's widths meet a lowered limit.)"""
    import pixelnerf_tpu_torch.ops.field as ops_field

    ns, d_in, hidden, d_latent = 2, 42, 512, 512
    z = lambda *shape: torch.zeros(shape, device=cuda)
    w = FieldWeights(
        w_in=z(d_in, hidden), b_in=z(hidden), wz=z(3, d_latent, hidden), bz=z(3, hidden),
        w0=z(5, hidden, hidden), b0=z(5, hidden), w1=z(5, hidden, hidden), b1=z(5, hidden),
        w_out=z(hidden, 4), b_out=z(4),
    )
    feats = [z(ns, 8, 8, d_latent).to(torch.bfloat16)]
    monkeypatch.setattr(ops_field, "SMEM_LIMIT", 1024)
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


def test_d_in_39_model_trains_and_renders_through_the_kernels(cuda, monkeypatch):
    """A bf16 model without view directions (d_in 39) trains and renders
    on the card through the ResnetFC and field kernels (the wrappers give
    its positional code a zero column), and agrees with the same model on
    the card with the wrappers' plain versions (their device test made to
    answer "cpu"), so that the rest of the step (the encoder's bf16
    convolutions above all, which round apart on the card and the CPU) is
    the same on both sides. Tolerances are the slice's bf16 ones
    (tests/test_torch_train.py): the loss 2e-2 relative, each gradient of
    the heads 5e-2 and of the encoder 1e-1 in relative Frobenius norm,
    rgb 5e-2. The heads are shaped as
    test_query_three_views_launches_the_field_kernel's, so that their
    outputs are O(1)."""
    import copy

    import pixelnerf_tpu_torch.ops.field as ops_field
    from pixelnerf_tpu_torch.eval.render_utils import render_full
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.train.step import make_optimizer, make_train_step, sample_rays
    from pixelnerf_tpu_torch.utils.rays import gen_rays

    conf = loads(QUERY_CONF.replace("use_viewdirs = True", "use_viewdirs = False"))
    model = make_model(conf["model"], device=cuda, seed=0, train=True)
    assert model.d_in == 39 and model.mlp_coarse.fused_ok((2, 8))
    with torch.no_grad():
        for mlp in (model.mlp_coarse, model.mlp_fine):
            for i in range(mlp.n_blocks):
                fc1 = getattr(mlp, f"block_{i}").fc_1.weight
                fc1.copy_(torch.randn(fc1.shape) * 0.1)
            w_out = mlp.lin_out.weight
            w_out.mul_(0.1).sub_(w_out.mean(dim=1, keepdim=True))
    model_plain = copy.deepcopy(model)
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 32, 32, 3)).astype(np.float32))
    poses = torch.eye(4).repeat(1, 3, 1, 1)
    poses[..., 2, 3] = torch.tensor([1.3, 1.4, 1.5])
    batch = {"images": images, "poses": poses, "focal": torch.full((1, 2), 35.0),
             "c": torch.full((1, 2), 16.0), "src_images": images[:, :2], "src_poses": poses[:, :2]}
    pix = torch.from_numpy(2 * 32 * 32 + rng.integers(0, 32 * 32, size=(1, 64)))
    batch["rays"], batch["rgb_gt"] = sample_rays(
        images, poses, batch["focal"], batch["c"], 0.8, 1.8, 64, draws={"pix": pix})
    batch = {k: v.to(cuda) for k, v in batch.items()}
    rays = gen_rays(poses[0, 2:], 32, 32, 35.0, 0.8, 1.8).reshape(-1, 8)
    rcfg = RendererConfig(n_coarse=16, n_fine=8, n_fine_depth=4, perturb=0.0)
    kernels = (resnetfc_fwd_stash, resnetfc_bwd, pyramid_field_fused)

    def run(m):
        step = make_train_step(m, rcfg, make_optimizer(m, 1e-4), 64, 0.8, 1.8)
        loss = step(batch)["t"].item()
        grads = {n: p.grad.float() for n, p in m.named_parameters()}
        m.eval()
        with torch.no_grad():
            enc = m.encode(images[:, :2].to(cuda), poses[:, :2].to(cuda), 35.0)
            out = render_full(m, enc, rays, rcfg, chunk=512)
        torch.cuda.synchronize()
        return loss, grads, out

    before = [k.launches for k in kernels]
    loss, grads, out = run(model)
    assert all(k.launches > n for k, n in zip(kernels, before))
    before = [k.launches for k in kernels]
    with monkeypatch.context() as mp:
        for mod in (ops_resnetfc, ops_field):
            mp.setattr(mod, "_device_of", lambda t, what: "cpu")
        want_loss, want_grads, want_out = run(model_plain)
    assert [k.launches for k in kernels] == before
    assert np.isfinite(loss) and abs(loss - want_loss) <= 2e-2 * abs(want_loss)
    for n, want in want_grads.items():
        tol = 1e-1 if n.startswith("encoder") else 5e-2
        assert (grads[n] - want).norm() <= tol * want.norm() + 1e-12, n
    for head in ("coarse", "fine"):
        got = out[head]["rgb"]
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want_out[head]["rgb"], rtol=0, atol=5e-2)


PYR_SHAPES = [(16, 16, 64), (4, 4, 64), (2, 2, 128)]
FLAG_LEVELS = [(64, 64, 128), (16, 16, 128), (8, 8, 256)]


def _scatter_uv(rng, kind, b, n, fine_hw):
    """random points; `rays`, runs of samples along rays about half a fine
    pixel apart (as a train step's lookups), straddling the kernels' run
    and chunk boundaries; `one`, every point at one uv (the most points on
    one pixel)."""
    if kind == "rays":
        return ray_uv(rng, b, n, 1.0 / max(fine_hw))
    if kind == "one":
        return np.broadcast_to(np.float32([0.137, -0.42]), (b, n, 2)).copy()
    return rng.uniform(-1.2, 1.2, size=(b, n, 2))


def _within_sum_bound(got, taps, g):
    """A scatter's float32 map (B, H, W, C) against the float64 scatter of
    g (B, N, C) through `taps`, within the float32 sum's bound."""
    b, h, w, c = got.shape
    want, bound = scatter_reference(*taps, g, h * w)
    d = (got.double().reshape(want.shape) - want).abs()
    assert torch.isfinite(got).all()
    assert (d <= bound).all(), f"{int((d > bound).sum())} elements beyond the bound, worst excess {(d - bound).max().item():.3e}"


def _pyramid_within_sum_bound(got, uv, g, levels):
    c0 = 0
    for grad, (h, w, c) in zip(got, levels):
        _within_sum_bound(grad, _level_taps(uv, h, w, *levels[0][:2], torch.bfloat16), g[..., c0 : c0 + c])
        c0 += c


# the four view counts of the train step (b = 2 NS maps); then the design's
# cases: ray-coherent and single-point uv at the flagship's levels (a global
# fine level, two shared-memory ones), channel counts that take 8-byte
# vectors (6, 10, 130), a 64x128 fine grid (the path's limit) with four
# levels over both paths, and one point
PYR_CASES = [(PYR_SHAPES, 2 * ns, 1000 + ns, "random") for ns in (1, 2, 3, 5)] + [
    (FLAG_LEVELS, 2, 5000, "rays"),
    (FLAG_LEVELS, 2, 4096, "one"),
    ([(16, 16, 6), (8, 8, 10), (4, 4, 130)], 2, 777, "random"),
    ([(64, 64, 130), (16, 16, 10), (8, 8, 6)], 2, 999, "rays"),
    ([(64, 128, 16), (32, 64, 16), (16, 32, 32), (8, 16, 64)], 2, 3001, "rays"),
    (FLAG_LEVELS, 3, 1, "random"),
]


@pytest.mark.parametrize("levels,b,n,kind", PYR_CASES)
def test_pyramid_kernels_match_plain(cuda, levels, b, n, kind):
    rng = np.random.default_rng(b + n)
    csizes = [c for (_, _, c) in levels]
    hws = [(h, w) for (h, w, _) in levels]
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feats = [t(rng.normal(size=(b, h, w, c)), torch.bfloat16) for (h, w, c) in levels]
    uv = t(_scatter_uv(rng, kind, b, n, hws[0]))
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
        _pyramid_within_sum_bound(got, uv, dz if second is None else dz + second, levels)


def _mlp_case(rng, cuda, ns, sb, b, hidden=64, d_latent=64, n_blocks=5, combine=3, d_in=42):
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
    _resnetfc_kernels_match_plain(cuda, ns, sb, b, d_in=42)


def _resnetfc_kernels_match_plain(cuda, ns, sb, b, d_in):
    rng = np.random.default_rng(ns * 100 + b)
    combine = 3 if ns > 1 else 1000
    z, xin, w, g = _mlp_case(rng, cuda, ns, sb, b, combine=combine, d_in=d_in)
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
    """A launch the library refuses (here: 65 views, with the wrapper's
    own widths and shared-memory checks and its route to the layered path
    switched off) raises; nothing is counted."""
    rng = np.random.default_rng(0)
    z, xin, w, _ = _mlp_case(rng, cuda, 65, 1, 4, hidden=512, d_latent=512)
    monkeypatch.setattr(ops_resnetfc, "SMEM_LIMIT", 1 << 30)
    monkeypatch.setattr(ops_resnetfc, "check_chain_widths", lambda *a: None)
    monkeypatch.setattr(ops_resnetfc, "takes_chains", lambda *a: True)
    before = resnetfc_fwd.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        resnetfc_fwd(z, xin, w, 5, 3, 65)
    assert resnetfc_fwd.launches == before


FIELD_SHAPES = [(16, 16, 32), (8, 8, 32), (4, 4, 64)]


@pytest.mark.parametrize("ns,sb,b", [(1, 2, 50), (2, 2, 37), (3, 1, 45), (5, 2, 13)])
def test_field_vjp_kernels_match_plain(cuda, ns, sb, b):
    """The field's stash forward and its backward against their plain
    versions (the backward from the kernel's own stash), every gradient."""
    _field_vjp_kernels_match_plain(cuda, ns, sb, b, d_in=42)


@pytest.mark.parametrize("ns,sb,b", [(1, 2, 50), (2, 2, 37), (3, 1, 45)])
def test_odd_d_in_kernels_match_plain(cuda, ns, sb, b):
    """d_in 39 (a bf16 model without view directions): the wrappers give
    the positional code a zero column (`even_d_in`), and the ResnetFC's
    and the field's kernels, forward and backward, agree with their plain
    versions at the d_in-42 tolerances, dxin and the w_in gradient at 39
    columns."""
    _resnetfc_kernels_match_plain(cuda, ns, sb, b, d_in=39)
    _field_vjp_kernels_match_plain(cuda, ns, sb, b, d_in=39)


def _field_vjp_kernels_match_plain(cuda, ns, sb, b, d_in):
    rng = np.random.default_rng(ns * 10 + b)
    combine, n_blocks = (3 if ns > 1 else 1000), 5
    d_latent = sum(c for (_, _, c) in FIELD_SHAPES)
    z, xin, w, g = _mlp_case(rng, cuda, ns, sb, b, d_latent=d_latent, combine=combine, d_in=d_in)
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


# random points with the corners and far edges; then ray-coherent and
# single-point uv on the flagship's 64x64 map, channel counts that take
# 8-byte vectors, the largest map of the path (64x128) and one point
BILERP_CASES = [(2, 5, 7, 8, 33, "random"), (3, 64, 64, 64, 1001, "random"), (1, 8, 8, 512, 513, "random"),
                (2, 64, 64, 512, 3000, "rays"), (1, 64, 64, 128, 4096, "one"), (2, 16, 16, 6, 777, "rays"),
                (2, 64, 64, 10, 1000, "random"), (2, 64, 64, 130, 999, "rays"), (2, 64, 128, 64, 3001, "rays"),
                (1, 64, 64, 512, 1, "random")]


@pytest.mark.parametrize("b,hl,wl,c,n,kind", BILERP_CASES)
def test_bilerp_kernels_match_plain(cuda, b, hl, wl, c, n, kind):
    rng = np.random.default_rng(n)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feat = t(rng.normal(size=(b, hl, wl, c)), torch.bfloat16)
    uv = _scatter_uv(rng, kind, b, n, (hl, wl)) if kind != "random" else rng.uniform(-1.3, 1.3, size=(b, n, 2))
    if kind == "random":
        uv[:, :4] = [[1.0, 1.0], [-1.0, -1.0], [1.0, -0.3], [-0.5, 1.0]][: min(n, 4)]
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
    _within_sum_bound(got, bilerp_taps(uv, hl, wl), dz)


# the route past 8,192 pixels: dtu's 3 x 150x200x512 composed map with a
# ragged N, a map of exactly 8,192 pixels (64x128: `_onehot_w`'s rounding,
# no wide launch) and one just past it (91x91)
LIMIT_CASES = [(3, 150, 200, 512, 100003, "rays"), (2, 64, 128, 64, 3001, "rays"),
               (2, 91, 91, 64, 5003, "random")]


@pytest.mark.parametrize("b,hl,wl,c,n,kind", LIMIT_CASES)
def test_bilerp_lookup_past_the_limit_matches_grid_sample(cuda, b, hl, wl, c, n, kind):
    """grid_sample_border_train on the card, forward and the map's gradient:
    the gather within one bf16 ulp of the plain version (and past the limit
    of grid_sample_2d), the scatter within the float32 sum's bound, the bf16
    map gradient against grid_sample_2d's autograd backward past the limit;
    `wide_launches` moves only past 8,192 pixels."""
    rng = np.random.default_rng(n)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feat = t(rng.normal(size=(b, hl, wl, c)), torch.bfloat16)
    uv = t(_scatter_uv(rng, kind, b, n, (hl, wl)))
    dz = t(rng.normal(size=(b, n, c)), torch.bfloat16)
    wide = hl * wl > 8192
    g0, s0 = bilerp_gather.wide_launches, bilerp_scatter_add.wide_launches
    f = feat.clone().requires_grad_(True)
    out = grid_sample_border_train(f, uv)
    out.backward(dz)
    torch.cuda.synchronize()
    assert (bilerp_gather.wide_launches - g0, bilerp_scatter_add.wide_launches - s0) == (wide, wide)
    close = lambda a, w: ((a.float() - w.float()).abs() <= 2.0 ** -7 * w.float().abs() + 1e-6).all()
    assert out.dtype == torch.bfloat16 and close(out, bilerp_gather_plain(feat, uv))
    taps = bilerp_taps(uv, hl, wl)
    _within_sum_bound(bilerp_scatter_add(uv, dz, hl, wl), taps, dz)
    assert f.grad.dtype == torch.bfloat16
    ref_sum, bound = scatter_reference(*taps, dz, hl * wl)
    a = f.grad.double().reshape(ref_sum.shape)
    assert ((a - ref_sum).abs() <= 2.0 ** -8 * a.abs() + bound).all()
    if wide:
        r = feat.clone().requires_grad_(True)
        want = grid_sample_2d(r, uv)
        want.backward(dz)
        assert close(out, want)
        bg = r.grad.double().reshape(ref_sum.shape)
        assert ((a - bg).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), bg.abs()) + 2 * bound).all()


def test_index_features_takes_the_kernels_past_the_limit_on_the_card(cuda):
    """On the card a bf16 map past 8,192 pixels takes the bilerp kernels
    (one wide launch); a float32 map keeps grid_sample_2d (none)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    uv = (torch.rand((2, 777, 2), generator=g) * 180).to(cuda)
    size, scale = torch.tensor([182.0, 182.0], device=cuda), torch.tensor([2.0, 2.0], device=cuda)
    for dtype, taken in ((torch.bfloat16, 1), (torch.float32, 0)):
        latent = torch.randn((2, 91, 91, 64), generator=g).to(cuda, dtype)
        l0, w0 = bilerp_gather.launches, bilerp_gather.wide_launches
        out = index_features(latent, scale, uv, size)
        torch.cuda.synchronize()
        assert (bilerp_gather.launches - l0, bilerp_gather.wide_launches - w0) == (taken, taken)
        want = grid_sample_2d(latent, uv * (scale / size) - 1.0)
        assert out.dtype == dtype and (out.is_contiguous() or not taken)
        assert ((out.float() - want.float()).abs() <= 2.0 ** -7 * want.float().abs() + 1e-6).all()


def _on_centres(rng, b, n, hw):
    """Normalized points whose clipped pixel coordinates on an (h, w) grid
    are whole numbers in float32 (every tap but the first of an axis has a
    zero weight), a third of them on the last row or column. Not every
    pixel has such a float32 point near -1: those that do are drawn."""
    def axis(size, k):
        x = lambda u: (u + np.float32(1)) * np.float32(0.5) * np.float32(size - 1)
        idx = np.arange(size)
        u0 = (2.0 * idx / (size - 1) - 1.0).astype(np.float32)
        found = np.full(size, np.nan, np.float32)
        for step in (np.float32(2), np.float32(-2)):
            u = u0.copy()
            for _ in range(64):  # float32 neighbours, outwards
                found = np.where(np.isnan(found) & (x(u) == idx), u, found)
                u = np.nextafter(u, step)
        whole = np.flatnonzero(~np.isnan(found))
        assert whole[-1] == size - 1
        pick = whole[rng.integers(0, whole.size, k.shape)]
        pick[k] = size - 1
        return found[pick]
    h, w = hw
    last = np.zeros((b, n), bool)
    return np.stack([axis(w, last | (np.arange(n) % 3 == 0)), axis(h, last | (np.arange(n) % 3 == 1))], -1)


def _gather_uv(rng, kind, b, n, hw):
    if kind == "centres":
        return _on_centres(rng, b, n, hw)
    return _scatter_uv(rng, kind, b, n, hw)


def _unaligned(t):
    """t's values in a view that starts 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[2 : 2 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


# the gathers' design cases (csrc/gather_tile.cuh), each against the plain
# version within one bf16 ulp plus 1e-6: points on pixel centres and on the
# last row and column (zero-weight and dropped taps); channel counts that
# are not multiples of 8 and maps off 16-byte alignment (4-byte lanes); one
# point and N just past a chunk; a level just too large for shared memory
# (16x16x136 beside the table and the staged 8x8x256: device memory, where
# the flagship's 16x16x128 would fit); the 64x128
# four-level pyramid; ray-coherent runs across streams and chunks, at the
# flagship's size too. (kind, maps, b, n, uv, unaligned)
GATHER_CASES = [
    ("pyramid", FLAG_LEVELS, 2, 3000, "centres", False),
    ("pyramid", [(64, 64, 128), (8, 8, 256), (16, 16, 136)], 2, 3000, "rays", False),
    ("pyramid", FLAG_LEVELS, 1, 257, "rays", False),
    ("pyramid", FLAG_LEVELS, 3, 1, "random", False),
    ("pyramid", [(16, 16, 6), (8, 8, 10), (4, 4, 130)], 2, 777, "centres", False),
    ("pyramid", FLAG_LEVELS, 2, 1000, "random", True),
    ("pyramid", [(64, 128, 16), (32, 64, 16), (16, 32, 32), (8, 16, 64)], 2, 3001, "centres", False),
    ("pyramid", FLAG_LEVELS, 8, 65536, "rays", False),
    ("bilerp", [(64, 64, 512)], 2, 3000, "centres", False),
    ("bilerp", [(64, 64, 512)], 1, 257, "rays", False),
    ("bilerp", [(64, 64, 130)], 2, 999, "centres", False),
    ("bilerp", [(8, 8, 512)], 2, 513, "rays", False),
    ("bilerp", [(64, 64, 512)], 1, 1000, "rays", True),
    ("bilerp", [(64, 128, 64)], 2, 3001, "centres", False),
    ("bilerp", [(64, 64, 512)], 8, 65536, "rays", False),
]


@pytest.mark.parametrize("kind,maps,b,n,uvs,unaligned", GATHER_CASES)
def test_gathers_match_plain(cuda, kind, maps, b, n, uvs, unaligned):
    rng = np.random.default_rng(b + n + len(maps))
    feats = [torch.from_numpy(rng.normal(size=(b,) + m).astype(np.float32)).to(cuda, torch.bfloat16)
             for m in maps]
    if unaligned:
        feats = [_unaligned(f) for f in feats]
    uv = torch.from_numpy(np.asarray(_gather_uv(rng, uvs, b, n, maps[0][:2]), np.float32)).to(cuda)
    fn, plain = (pyramid_gather, pyramid_gather_plain) if kind == "pyramid" else (
        bilerp_gather, bilerp_gather_plain)
    args = (feats, uv) if kind == "pyramid" else (feats[0], uv)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args)
    assert got.shape == want.shape == (b, n, sum(c for _, _, c in maps))
    assert got.dtype == torch.bfloat16
    assert ((got.float() - want.float()).abs() <= 2.0 ** -7 * want.float().abs() + 1e-6).all()
    plan = fn.plan
    assert plan.vec == (2 if unaligned or any(c % 8 for _, _, c in maps) else 8)
    if maps[-1] == (16, 16, 136):
        assert plan.soff[1] >= 0 and plan.soff[2] == -1


@pytest.mark.parametrize("offset", [1, 2])
def test_scatters_take_cotangents_off_vector_alignment(cuda, offset):
    """Cotangents that start 2 or 4 bytes past an 8-byte boundary (views
    into a larger buffer): the wrappers copy the first (then 16-byte
    vectors) and plan 8-byte vectors for the second; both agree with the
    plain versions."""
    rng = np.random.default_rng(40 + offset)
    b, n, hl, wl, c = 2, 700, 64, 64, 128
    uv = torch.from_numpy(ray_uv(rng, b, n, 1.0 / 64)).to(cuda)
    flat = torch.from_numpy(rng.normal(size=b * n * c + offset).astype(np.float32)).to(cuda, torch.bfloat16)
    dz = flat[offset:].view(b, n, c)
    assert dz.data_ptr() % 8 == 2 * offset
    got = bilerp_scatter_add(uv, dz, hl, wl)
    assert bilerp_scatter_add.plan.segments[0].vec == (4 if offset == 1 else 2)
    _within_sum_bound(got, bilerp_taps(uv, hl, wl), dz)
    got = pyramid_scatter_add(uv, dz, [c], [(hl, wl)], (hl, wl))
    _pyramid_within_sum_bound(got, uv, dz, [(hl, wl, c)])


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


# Latents wider than the forward's z tile holds at hidden 512 (512
# columns): the global encoder's 512 + 128 and five encoder levels' 1024
# (srn.conf's levels and layer4's 4x4x512 at 128x128). The forward runs
# the injections in 512-column bands (csrc/fwd_chain.cuh:fwd_z_cols), the
# backward g_z in passes of 512; tolerances as at the flagship's width.
WIDE_LATENT_LEVELS = {
    640: [(64, 64, 128), (16, 16, 128), (8, 8, 256), (4, 4, 128)],
    1024: [(64, 64, 128), (16, 16, 128), (8, 8, 256), (4, 4, 512)],
}
WIDE_LATENT_CASES = [(1, 1, 100), (2, 2, 45), (3, 1, 50)]


@pytest.mark.parametrize("d_latent", sorted(WIDE_LATENT_LEVELS))
@pytest.mark.parametrize("ns,sb,b", WIDE_LATENT_CASES)
def test_wide_latent_resnetfc_chains_match_plain(cuda, d_latent, ns, sb, b):
    """The ResnetFC forward, stash and backward at d_latent 640 and 1024,
    hidden 512: one launch each, no plain version, against the plain
    versions on the kernel's own stash."""
    rng = np.random.default_rng(7000 + d_latent + ns * 100 + b)
    combine = 3 if ns > 1 else 1000
    w = _wide_weights(rng, cuda, d_latent=d_latent, combine=combine)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, torch.bfloat16)
    z, xin = t(rng.normal(size=(sb, ns, b, d_latent))), t(rng.normal(size=(sb, ns, b, 42)))
    g = torch.from_numpy(rng.normal(size=(sb, b, 4)).astype(np.float32)).to(cuda)
    args = (5, combine, ns)
    before = (resnetfc_fwd.launches, resnetfc_fwd_stash.launches, resnetfc_bwd.launches)
    out = resnetfc_fwd(z, xin, w, *args)
    out_s, spre, spost = resnetfc_fwd_stash(z, xin, w, *args)
    dz, dxin, dw = resnetfc_bwd(z, xin, g, spre, spost, w, *args)
    torch.cuda.synchronize()
    after = (resnetfc_fwd.launches, resnetfc_fwd_stash.launches, resnetfc_bwd.launches)
    assert after == tuple(x + 1 for x in before)
    assert torch.equal(out, out_s)
    want, wpre, wpost = resnetfc_fwd_plain(z, xin, w, *args, stash=True)
    _out_close(out, want)
    for got, ref in zip((spre, spost), (wpre, wpost)):
        assert (got is None) == (ref is None)
        if got is not None:
            _grad_within(got, ref)
    wdz, wdxin, wdw = resnetfc_bwd_plain(z, xin, g, spre, spost, w, *args)
    _grad_within(dz, wdz)
    _grad_within(dxin, wdxin)
    for name in FieldWeights._fields:
        _grad_within(getattr(dw, name), getattr(wdw, name))


@pytest.mark.parametrize("d_latent", sorted(WIDE_LATENT_LEVELS))
@pytest.mark.parametrize("ns,sb,b", WIDE_LATENT_CASES)
def test_wide_latent_field_chains_match_plain(cuda, d_latent, ns, sb, b):
    """The field primal, its stash forward (the z-stash written band by
    band, equal to the plain gather) and its backward at d_latent 640 and
    1024, hidden 512."""
    rng = np.random.default_rng(8000 + d_latent + ns * 100 + b)
    combine = 3 if ns > 1 else 1000
    levels = WIDE_LATENT_LEVELS[d_latent]
    w = _wide_weights(rng, cuda, d_latent=d_latent, combine=combine)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feats = [t(rng.normal(size=(sb * ns, h, ww, c)), torch.bfloat16) for (h, ww, c) in levels]
    grid = t(rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)))
    xin = t(rng.normal(size=(sb, ns, b, 42)), torch.bfloat16)
    g = t(rng.normal(size=(sb, b, 4)) * 1e-3)
    args = (5, combine, ns)
    out = pyramid_field_fused(feats, grid, xin, w, *args)
    out_s, zs, spre, spost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)
    d_feats, dxin, dw = pyramid_field_fused_bwd(grid, xin, g, zs, spre, spost, w, *args, levels)
    torch.cuda.synchronize()
    assert torch.equal(out, out_s)
    want = field_plain(feats, grid, xin, w, *args)
    _out_close(out, want)
    assert torch.equal(zs, pyramid_gather_plain(feats, grid.reshape(sb * ns, b, 2)).reshape(zs.shape))
    wd_feats, wdxin, wdw = field_bwd_plain(grid, xin, g, zs, spre, spost, w, *args, levels)
    for got, ref in zip(d_feats, wd_feats):
        _grad_within(got, ref)
    _grad_within(dxin, wdxin)
    for name in FieldWeights._fields:
        _grad_within(getattr(dw, name), getattr(wdw, name))


def test_resnetfc_forward_takes_the_layered_path_past_the_chain_widths(cuda):
    """hidden 576 is past the widest chain (512): the forward wrappers
    launch the layered kernels (csrc/layer_chain.cu), no chain, and match
    their plain versions; the primal equals the stash forward's output."""
    rng = np.random.default_rng(5)
    z, xin, w, _ = _mlp_case(rng, cuda, 2, 1, 8, hidden=576, d_latent=64)
    before = (resnetfc_fwd.launches, resnetfc_fwd_stash.launches, layer_fwd.launches,
              view_pool_fwd.launches)
    out = resnetfc_fwd(z, xin, w, 5, 3, 2)
    out_s, spre, spost = resnetfc_fwd_stash(z, xin, w, 5, 3, 2)
    torch.cuda.synchronize()
    # a run: w_in, 3 injections, 2 a block, lin_out; one pooling
    assert (resnetfc_fwd.launches, resnetfc_fwd_stash.launches) == before[:2]
    assert (layer_fwd.launches, view_pool_fwd.launches) == (before[2] + 2 * 15, before[3] + 2)
    assert torch.equal(out, out_s)
    want, wpre, wpost = resnetfc_fwd_plain(z, xin, w, 5, 3, 2, stash=True)
    _out_close(out, want)
    assert spre.shape == wpre.shape and spost.shape == wpost.shape


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


# The field backward's level scatter alone: the level gradients of the
# chain's epilogue against the float64 scatter of the same chain's own bf16
# cotangent (the chain without levels writes it as dz) within the float32
# sum's bound. Ray-coherent runs (the train step's), every point at one uv
# (the most points on one pixel), and points on fine pixel centres (every
# fine tap but one zero); the flagship's levels and a set whose first two
# levels' channel counts or offsets are not quads (8-byte reductions);
# tiles of 32 points (NS = 2), 64 (NS = 1: two batches of 32 a run) and 21.
ODD_LEVELS = [(32, 32, 62), (16, 16, 66), (8, 8, 128)]
LEVEL_SCATTER_CASES = [
    (hidden, kind, levels, ns, sb, b)
    for hidden in (128, 512)
    for kind in ("rays", "one", "centres")
    for levels, (ns, sb, b) in ((WIDE_LEVELS, (2, 2, 300)), (ODD_LEVELS, (1, 1, 333)), (WIDE_LEVELS, (3, 1, 100)))
]


@pytest.mark.parametrize("hidden,kind,levels,ns,sb,b", LEVEL_SCATTER_CASES)
def test_level_scatter_within_the_sum_bound(cuda, hidden, kind, levels, ns, sb, b):
    rng = np.random.default_rng(5000 + hidden + ns * 100 + b + len(kind))
    args, w, _, xin, g = _chain_case(rng, cuda, hidden, ns, sb, b, levels)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feats = [t(rng.normal(size=(sb * ns, h, ww, c)), torch.bfloat16) for (h, ww, c) in levels]
    fine = levels[0][:2]
    uv = t(_gather_uv(rng, kind, sb * ns, b, fine))
    grid = uv.reshape(sb, ns, b, 2)
    if kind == "centres":
        assert ((_level_taps(uv, *fine, *fine, torch.bfloat16)[1] != 0).sum(-1) == 1).all()
    _, zs, spre, spost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)
    before = ops_resnetfc.launch_bwd.chain_launches
    got = ops_resnetfc.launch_bwd(zs, xin, g, spre, spost, w, *args, levels=levels, grid=grid)[0]
    dz = ops_resnetfc.launch_bwd(zs, xin, g, spre, spost, w, *args)[0]
    torch.cuda.synchronize()
    assert ops_resnetfc.launch_bwd.chain_launches == before + 2
    assert [tuple(x.shape) for x in got] == [(sb * ns, h, ww, c) for h, ww, c in levels]
    _pyramid_within_sum_bound(got, uv, dz.reshape(sb * ns, b, -1), levels)


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


# The forward chain's schedule (csrc/fwd_chain.cuh: a block's W1 chunks
# before its last run on into the next W0 chunk, the tensor pipe drained
# only where an epilogue reads an accumulator) at every boundary it has:
# hidden 64, 128 and 256 (one h chunk) and 512 (two), NS 1, 2, 3 (21
# points a tile) and 5 with B off a whole tile, NS 64 (one point a tile),
# and a banded latent (d_latent 1024 at hidden 512: the z tile reloaded
# mid-chain); 4 outputs throughout.
FWD_CHAIN_CASES = [
    (hidden, None, *case) for hidden in CHAIN_WIDTHS for case in WIDE_CASES + [(64, 1, 3)]
] + [(512, 1024, *case) for case in WIDE_LATENT_CASES]


@pytest.mark.parametrize("hidden,d_latent,ns,sb,b", FWD_CHAIN_CASES)
def test_forward_chains_match_plain(cuda, hidden, d_latent, ns, sb, b):
    """The ResnetFC and field forwards, primal and stash, one launch each:
    outputs against the plain versions, every stash slot against the
    plain stash, the field's z-stash equal to the plain gather, and each
    primal's output equal to its stash forward's bit for bit."""
    rng = np.random.default_rng(6000 + hidden + (d_latent or 0) + ns * 100 + b)
    levels = WIDE_LATENT_LEVELS[d_latent] if d_latent else _levels_for(hidden)
    args, w, z, xin, _ = _chain_case(rng, cuda, hidden, ns, sb, b, levels)
    before = (resnetfc_fwd.launches, resnetfc_fwd_stash.launches, pyramid_field_fused.launches,
              pyramid_field_fused_fwd_stash.launches)
    out = resnetfc_fwd(z, xin, w, *args)
    out_s, spre, spost = resnetfc_fwd_stash(z, xin, w, *args)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feats = [t(rng.normal(size=(sb * ns, h, ww, c)), torch.bfloat16) for (h, ww, c) in levels]
    grid = t(rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)))
    fout = pyramid_field_fused(feats, grid, xin, w, *args)
    fout_s, zs, fpre, fpost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)
    torch.cuda.synchronize()
    after = (resnetfc_fwd.launches, resnetfc_fwd_stash.launches, pyramid_field_fused.launches,
             pyramid_field_fused_fwd_stash.launches)
    assert after == tuple(x + 1 for x in before)
    assert torch.equal(out, out_s) and torch.equal(fout, fout_s)
    want, wpre, wpost = resnetfc_fwd_plain(z, xin, w, *args, stash=True)
    fwant, wzs, fwpre, fwpost = field_plain(feats, grid, xin, w, *args, stash=True)
    _out_close(out, want)
    _out_close(fout, fwant)
    assert torch.equal(zs, pyramid_gather_plain(feats, grid.reshape(sb * ns, b, 2)).reshape(zs.shape))
    for got, ref in zip((spre, spost, fpre, fpost), (wpre, wpost, fwpre, fwpost)):
        assert (got is None) == (ref is None)
        if got is not None:
            _grad_within(got, ref)


def test_resnetfc_backward_takes_the_layered_path_past_the_chain_widths(cuda):
    """hidden 576: the backward wrapper launches the layered cotangent
    kernels and the weight-gradient products, no chain, and every gradient
    matches the plain backward from the same stash."""
    rng = np.random.default_rng(6)
    z, xin, w, g = _mlp_case(rng, cuda, 2, 1, 8, hidden=576, d_latent=64)
    _, spre, spost = resnetfc_fwd_stash(z, xin, w, 5, 3, 2)
    before = (resnetfc_bwd.launches, layer_bwd.launches, view_pool_bwd.launches,
              layer_wgrad.launches)
    dz, dxin, dw = resnetfc_bwd(z, xin, g, spre, spost, w, 5, 3, 2)
    torch.cuda.synchronize()
    # lin_out, 2 a block, 3 injections, dxin, and the column sums'
    # reduction of lin_out's and 2 a block but the pooling's (10); bf(g) and
    # the pooling, each with its column sums' reduction
    assert (resnetfc_bwd.launches, layer_bwd.launches, view_pool_bwd.launches,
            layer_wgrad.launches) == (before[0], before[1] + 25, before[2] + 4, before[3] + 2)
    _layered_grads_close(z, xin, g, spre, spost, w, (5, 3, 2), dz, dxin, dw)


def _layered_grads_close(z, xin, g, spre, spost, w, args, dz, dxin, dw):
    wdz, wdxin, wdw = resnetfc_bwd_plain(z, xin, g, spre, spost, w, *args)
    _grad_within(dz, wdz)
    _grad_within(dxin, wdxin)
    for name in FieldWeights._fields:
        _grad_within(getattr(dw, name), getattr(wdw, name))


def test_the_layered_path_takes_past_64_views(cuda):
    """65 views at hidden 64 fit shared memory but not one 64-row tile: both
    wrappers take the layered path (`takes_chains`), launch no chain, and
    match their plain versions."""
    rng = np.random.default_rng(7)
    z, xin, w, g = _mlp_case(rng, cuda, 65, 1, 3)
    before = (resnetfc_fwd_stash.launches, resnetfc_bwd.launches, layer_fwd.launches,
              layer_bwd.launches)
    out, spre, spost = resnetfc_fwd_stash(z, xin, w, 5, 3, 65)
    dz, dxin, dw = resnetfc_bwd(z, xin, g, spre, spost, w, 5, 3, 65)
    torch.cuda.synchronize()
    assert (resnetfc_fwd_stash.launches, resnetfc_bwd.launches) == before[:2]
    assert layer_fwd.launches > before[2] and layer_bwd.launches > before[3]
    _out_close(out, resnetfc_fwd_plain(z, xin, w, 5, 3, 65))
    _layered_grads_close(z, xin, g, spre, spost, w, (5, 3, 65), dz, dxin, dw)


def test_the_layered_path_takes_more_row_tiles_than_a_grid_column(cuda):
    """8.4M pre-pool rows at hidden 64 and 80 views: 65,625 row tiles of
    128, past the 65,535 blocks of a grid's y axis, walked by the
    persistent grid. The stash forward and the backward launch (the
    backward's 10 column-sum reductions counted) and match their plain
    versions."""
    rng = np.random.default_rng(8)
    sb, ns, b = 1, 80, 105_000
    assert sb * ns * b > 65_535 * 128
    _, _, w, _ = _mlp_case(rng, cuda, ns, sb, 1)
    gen = torch.Generator(device=cuda).manual_seed(8)
    z = torch.randn((sb, ns, b, 64), generator=gen, device=cuda).to(torch.bfloat16)
    xin = torch.randn((sb, ns, b, 42), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((sb, b, 4), generator=gen, device=cuda)
    before = (layer_fwd.launches, layer_bwd.launches)
    out, spre, spost = resnetfc_fwd_stash(z, xin, w, 5, 3, ns)
    dz, dxin, dw = resnetfc_bwd(z, xin, g, spre, spost, w, 5, 3, ns)
    torch.cuda.synchronize()
    assert (layer_fwd.launches, layer_bwd.launches) == (before[0] + 15, before[1] + 25)
    _out_close(out, resnetfc_fwd_plain(z, xin, w, 5, 3, ns))
    _layered_grads_close(z, xin, g, spre, spost, w, (5, 3, ns), dz, dxin, dw)


# the layered path's widths: (hidden, NS, SB, B); three levels summing to
# d_latent 512 for the field
LAYERED_CASES = {"hidden 576": (576, 2, 1, 45), "hidden 1024": (1024, 2, 2, 37),
                 "views 65": (64, 65, 1, 7), "views 80": (64, 80, 2, 5),
                 "hidden 1024 one view": (1024, 1, 1, 70)}
LAYERED_LEVELS = [(32, 32, 128), (8, 8, 128), (4, 4, 256)]


@pytest.mark.parametrize("hidden,ns,sb,b", LAYERED_CASES.values(), ids=LAYERED_CASES.keys())
def test_layered_resnetfc_and_field_match_plain(cuda, hidden, ns, sb, b):
    """The ResnetFC and the field through the layered path: forward
    (primal equal to the stash forward's output), stash, backward from the
    layered stash, and the field's level gradients, against the plain
    versions; no chain or field kernel counts a launch."""
    rng = np.random.default_rng(9000 + hidden + ns * 10 + b)
    args, w, z, xin, g = _chain_case(rng, cuda, hidden, ns, sb, b, LAYERED_LEVELS)
    out = resnetfc_fwd(z, xin, w, *args)
    out_s, spre, spost = resnetfc_fwd_stash(z, xin, w, *args)
    dz, dxin, dw = resnetfc_bwd(z, xin, g, spre, spost, w, *args)
    torch.cuda.synchronize()
    assert torch.equal(out, out_s)
    _out_close(out, resnetfc_fwd_plain(z, xin, w, *args))
    _layered_grads_close(z, xin, g, spre, spost, w, args, dz, dxin, dw)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feats = [t(rng.normal(size=(sb * ns, h, ww, c)), torch.bfloat16) for (h, ww, c) in LAYERED_LEVELS]
    grid = t(rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)))
    before = (pyramid_field_fused.launches, pyramid_field_fused_fwd_stash.launches,
              pyramid_field_fused_bwd.launches)
    fout = pyramid_field_fused(feats, grid, xin, w, *args)
    fout_s, zs, fpre, fpost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)
    d_feats, fdxin, fdw = pyramid_field_fused_bwd(grid, xin, g, zs, fpre, fpost, w, *args,
                                                  LAYERED_LEVELS)
    torch.cuda.synchronize()
    assert (pyramid_field_fused.launches, pyramid_field_fused_fwd_stash.launches,
            pyramid_field_fused_bwd.launches) == before
    assert torch.equal(fout, fout_s)
    _out_close(fout, field_plain(feats, grid, xin, w, *args))
    assert torch.equal(zs, pyramid_gather_plain(feats, grid.reshape(sb * ns, b, 2)).reshape(zs.shape))
    wd_feats, wdxin, wdw = field_bwd_plain(grid, xin, g, zs, fpre, fpost, w, *args, LAYERED_LEVELS)
    for got, ref in zip(d_feats, wd_feats):
        _grad_within(got, ref)
    _grad_within(fdxin, wdxin)
    for name in FieldWeights._fields:
        _grad_within(getattr(fdw, name), getattr(wdw, name))


@pytest.mark.parametrize("ns,sb,b", [(1, 1, 70), (2, 2, 37)])
def test_layered_path_matches_the_chain_at_hidden_512(cuda, ns, sb, b):
    """At the flagship's widths the layered path and the chain round at the
    same places: the outputs and stashes agree within the kernels'
    tolerances, and on each forward's stash the two backwards agree."""
    rng = np.random.default_rng(9500 + ns * 10 + b)
    args, w, z, xin, g = _chain_case(rng, cuda, 512, ns, sb, b, WIDE_LEVELS)
    out_c, cpre, cpost = resnetfc_fwd_stash(z, xin, w, *args)
    out_l, lpre, lpost = layered_fwd(z, xin, w, *args, stash=True)
    torch.cuda.synchronize()
    _out_close(out_l, out_c)
    for a, c in ((lpre, cpre), (lpost, cpost)):
        assert (a is None) == (c is None)
        if a is not None:
            assert a.shape == c.shape
            assert ((a.float() - c.float()).abs() <= 3e-2 + 3e-2 * c.float().abs()).all()
    for spre, spost in ((cpre, cpost), (lpre, lpost)):
        dz_c, dxin_c, dw_c = resnetfc_bwd(z, xin, g, spre, spost, w, *args)
        dz_l, dxin_l, dw_l, _ = layered_bwd(z, xin, g, spre, spost, w, *args)
        torch.cuda.synchronize()
        _grad_within(dz_l, dz_c)
        _grad_within(dxin_l, dxin_c)
        for name in FieldWeights._fields:
            _grad_within(getattr(dw_l, name), getattr(dw_c, name))


def test_layer_kernels_match_plain(cuda):
    """Each layered kernel on its own against its plain version: ragged
    rows, K off the 64-deep box (48), N of 16 with 4 columns kept (rows of
    the mask and y off 16 bytes: element accesses), masks, the residual
    added to and written, relu'd and plain bf16 copies, column sums
    (per-CTA sums in a fixed order), the pooling and its backward."""
    g = torch.Generator(device="cpu").manual_seed(11)
    r = lambda *s: torch.randn(s, generator=g).to(cuda)
    bf = lambda t: t.to(torch.bfloat16)
    for m, k, n, cols in ((333, 48, 192, 192), (1000, 576, 16, 4), (7, 1024, 1024, 1000)):
        a, w, bias, x0 = bf(r(m, k)), bf(r(k, n) / k ** 0.5), r(n), r(m, cols)
        got = [x0.clone(), torch.zeros(m, cols, dtype=torch.bfloat16, device=cuda)]
        want = [x0.clone(), got[1].clone()]
        layer_fwd(a, w, bias, x=got[0], add=True, y=got[1], cols=cols)
        layer_fwd_plain(a, w, bias, x=want[0], add=True, y=want[1], cols=cols)
        wt, mask = bf(r(n, k) / k ** 0.5), bf(r(m, cols))
        gotb = [x0.clone(), got[1].clone(), torch.zeros(cols, device=cuda)]
        wantb = [x0.clone(), got[1].clone(), torch.zeros(cols, device=cuda)]
        layer_bwd(a, wt, mask=mask, x=gotb[0], add=True, y=gotb[1], colsum=gotb[2], cols=cols)
        layer_bwd_plain(a, wt, mask=mask, x=wantb[0], add=True, y=wantb[1], colsum=wantb[2],
                        cols=cols)
        torch.cuda.synchronize()
        for gt, wn in zip(got + gotb[:2], want + wantb[:2]):
            _out_close(gt.float(), wn.float())
        assert (gotb[2] - wantb[2]).abs().max() <= 1e-5 * wantb[0].abs().sum(dim=0).max()
    sb, ns, b, h = 2, 80, 9, 1024
    x = r(sb, ns, b, h)
    outs = [torch.empty(sb * b, h, device=cuda) for _ in range(2)]
    ys = [torch.empty(sb * b, h, dtype=torch.bfloat16, device=cuda) for _ in range(2)]
    view_pool_fwd(x, outs[0], ys[0])
    view_pool_fwd_plain(x, outs[1], ys[1])
    gc = r(sb, b, 20)
    gxs = [torch.empty(sb * ns * b, 20, device=cuda) for _ in range(2)]
    yb = [torch.empty(sb * ns * b, 32, dtype=torch.bfloat16, device=cuda) for _ in range(2)]
    cs = [torch.zeros(20, device=cuda) for _ in range(2)]
    view_pool_bwd(gc, ns, gx=gxs[0], y=yb[0], colsum=cs[0])
    view_pool_bwd_plain(gc, ns, gx=gxs[1], y=yb[1], colsum=cs[1])
    torch.cuda.synchronize()
    # g / ns: the kernel divides, the plain version on the card may multiply
    # by the reciprocal (one float32 ulp), and the bf16 copies may then round
    # one bf16 ulp apart
    assert (outs[0] - outs[1]).abs().max() <= 1e-5
    assert ((gxs[0] - gxs[1]).abs() <= 2.0 ** -23 * gxs[1].abs()).all()
    assert (ys[0].float() - ys[1].float()).abs().max() <= 2.0 ** -7 * outs[1].abs().max()
    assert ((yb[0].float() - yb[1].float()).abs() <= 2.0 ** -7 * yb[1].float().abs()).all()
    assert (cs[0] - cs[1]).abs().max() <= 1e-5 * gc.abs().sum(dim=(0, 1)).max()


# (SB, NS, B, H, which of x, out and y start 4 bytes off 16, y given): one
# view to 80; one row, rows just past a block's items (256: 32 rows of 64
# columns, 2 of 1024); H of 20 (element accesses) and 1024
POOL_CASES = {
    "ns 1": (2, 1, 37, 64, (), True),
    "ns 2 hidden 1024": (2, 2, 3, 1024, (), True),
    "ns 3 hidden 20": (1, 3, 7, 20, (), True),
    "ns 80": (1, 80, 5, 64, (), True),
    "ns 80 hidden 1024": (1, 80, 3, 1024, (), True),
    "one row": (1, 3, 1, 64, (), True),
    "one row ns 80": (1, 80, 1, 1024, (), True),
    "rows past a block": (1, 2, 33, 64, (), True),
    "off 16 bytes": (2, 3, 9, 64, ("x", "out", "y"), True),
    "off 16 bytes ns 80": (2, 80, 3, 64, ("x", "out", "y"), True),
    "x off 16 bytes": (1, 2, 5, 1024, ("x",), True),
    "no y": (2, 2, 9, 64, (), False),
    "no y ns 80": (1, 80, 5, 20, (), False),
}


def _off16(t, off):
    """t's values in a tensor of its shape that starts 4 bytes off 16 (a
    view into a larger buffer) if `off`, else t."""
    if not off:
        return t
    step = 4 // t.element_size()
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    base = (-buf.data_ptr() % 16) // t.element_size() + step
    out = buf[base:base + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("sb,ns,b,h,off,with_y", POOL_CASES.values(), ids=POOL_CASES.keys())
def test_view_pool_fwd_matches_plain(cuda, sb, ns, b, h, off, with_y):
    """The pooling against its plain version at the path's tolerances, and
    the mean and its bf16 copy equal to a loop over the views in order (the
    kernel's arithmetic)."""
    g = torch.Generator(device="cpu").manual_seed(sb * 1000 + ns * 10 + b + h)
    x = _off16(torch.randn((sb, ns, b, h), generator=g).to(cuda), "x" in off)
    out = _off16(torch.zeros(sb * b, h, device=cuda), "out" in off)
    y = _off16(torch.zeros(sb * b, h, dtype=torch.bfloat16, device=cuda), "y" in off) if with_y else None
    want, wy = torch.empty(sb * b, h, device=cuda), torch.empty(sb * b, h, dtype=torch.bfloat16, device=cuda)
    before = view_pool_fwd.launches
    view_pool_fwd(x, out, y)
    view_pool_fwd_plain(x, want, wy)
    torch.cuda.synchronize()
    assert view_pool_fwd.launches == before + 1
    assert (out - want).abs().max() <= 1e-5
    if with_y:
        assert (y.float() - wy.float()).abs().max() <= 2.0 ** -7 * want.abs().max()
    acc = torch.zeros(sb, b, h, device=cuda)
    for v in range(ns):
        acc = acc + x[:, v]
    mean = (acc / torch.full_like(acc, float(ns))).reshape(sb * b, h)
    assert torch.equal(out, mean)
    assert not with_y or torch.equal(y, torch.relu(mean).to(torch.bfloat16))


def test_view_pool_bwd_column_sums_are_deterministic(cuda):
    """Rows past one wave of the backward's row blocks (4,096 blocks of 64
    rows): each block's sums go to a workspace row and a second launch adds
    them in block order, so two runs give equal column sums; every output
    against the plain version."""
    sb, ns, b, c, ldy = 1, 2, 300_000, 64, 64
    assert sb * b > 4096 * 64
    g = torch.randn((sb, b, c), generator=torch.Generator(device="cpu").manual_seed(5)).to(cuda)
    runs = []
    for fn in (view_pool_bwd, view_pool_bwd, view_pool_bwd_plain):
        outs = [torch.empty(sb * ns * b, c, device=cuda),
                torch.empty(sb * ns * b, ldy, dtype=torch.bfloat16, device=cuda),
                torch.zeros(c, device=cuda)]
        before = view_pool_bwd.launches
        fn(g, ns, gx=outs[0], y=outs[1], colsum=outs[2])
        torch.cuda.synchronize()
        if fn is view_pool_bwd:
            assert view_pool_bwd.launches == before + 2  # the broadcast, the column sums
        runs.append(outs)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    (gx, y, cs), (wgx, wy, wcs) = runs[0], runs[2]
    assert ((gx - wgx).abs() <= 2.0 ** -23 * wgx.abs()).all()
    assert ((y.float() - wy.float()).abs() <= 2.0 ** -7 * wy.float().abs()).all()
    assert (cs - wcs).abs().max() <= 1e-5 * g.abs().sum(dim=(0, 1)).max()


def test_layered_backward_is_deterministic(cuda):
    """Two runs of the layered backward at hidden 1024 and 2 views (the
    pooling's column sums and the products' reduced in fixed orders, the
    weight gradients too) give equal gradients, every one."""
    rng = np.random.default_rng(17)
    args, w, z, xin, g = _chain_case(rng, cuda, 1024, 2, 2, 4096, LAYERED_LEVELS)
    _, spre, spost = resnetfc_fwd_stash(z, xin, w, *args)
    runs = [layered_bwd(z, xin, g, spre, spost, w, *args)[:3] for _ in range(2)]
    torch.cuda.synchronize()
    (dz, dxin, dw), (dz2, dxin2, dw2) = runs
    assert torch.equal(dz, dz2) and torch.equal(dxin, dxin2)
    for name in FieldWeights._fields:
        assert torch.equal(getattr(dw, name), getattr(dw2, name)), name


def _layer_pair(cuda, m, k, n, cols, seed):
    """layer_fwd and layer_bwd of one shape (every epilogue part on) as the
    kernel and as the plain version: the outputs of each, and each kernel's
    plan."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g).to(cuda)
    bf = lambda t: t.to(torch.bfloat16)
    a, w, wt, bias = bf(r(m, k)), bf(r(k, n) / k ** 0.5), bf(r(n, k) / k ** 0.5), r(n)
    x0, mask = r(m, cols), bf(r(m, cols))
    y0 = torch.zeros(m, cols, dtype=torch.bfloat16, device=cuda)
    outs = []
    for fwd, bwd in ((layer_fwd, layer_bwd), (layer_fwd_plain, layer_bwd_plain)):
        f = [x0.clone(), y0.clone()]
        fwd(a, w, bias, x=f[0], add=True, y=f[1], cols=cols)
        b = [x0.clone(), y0.clone(), torch.zeros(cols, device=cuda)]
        bwd(a, wt, mask=mask, x=b[0], add=True, y=b[1], colsum=b[2], cols=cols)
        outs.append(f + b)
    torch.cuda.synchronize()
    return outs, (layer_fwd.plan, layer_bwd.plan)


def _layer_pair_close(outs):
    (fx, fy, bx, by, cs), (wfx, wfy, wbx, wby, wcs) = outs
    for got, want in ((fx, wfx), (fy, wfy), (bx, wbx), (by, wby)):
        _out_close(got.float(), want.float())
    assert (cs - wcs).abs().max() <= 1e-5 * wbx.abs().sum(dim=0).max()


# (M, K, N, cols) and the N tile the plan takes: N <= 64 on 64-column
# tiles, wider on 128; K off the 64-deep box (16, 48, 576); M under one
# 128-row tile and off a tile multiple; N off the tile (192 = 128 + 64)
LAYER_SHAPES = {
    "N 64": (333, 64, 64, 64, 64), "N 48 K 48": (129, 48, 48, 48, 64),
    "N 16 K 16": (7, 16, 16, 16, 64), "N 1024 K 576": (300, 576, 1024, 1024, 128),
    "N 192 M 7": (7, 1024, 192, 192, 128), "N 512 K 64": (1000, 64, 512, 512, 128),
}


@pytest.mark.parametrize("m,k,n,cols,bn", LAYER_SHAPES.values(), ids=LAYER_SHAPES.keys())
def test_layer_products_at_each_tile_width(cuda, m, k, n, cols, bn):
    """The layered products at each N tile their plan instantiates (64 and
    128), K off the 64-deep box, M under a tile and off a tile multiple:
    every output against the plain version at the path's tolerances."""
    outs, plans = _layer_pair(cuda, m, k, n, cols, seed=m + k + n)
    assert [p.bn for p in plans] == [bn, bn]
    assert all(p.n_tiles == -(-n // bn) and p.grid == p.slots * p.n_tiles for p in plans)
    _layer_pair_close(outs)


def test_layer_products_walk_more_tiles_than_a_wave(cuda):
    """Row tiles past one wave of the persistent grid: each CTA walks
    several (N 64: one N tile, every SM a row slot; N 1024: 8 N tiles a
    slot), and the column sums of two runs are bit-identical (the CTAs'
    sums added in a fixed order, no atomics)."""
    for k, n in ((64, 64), (1024, 1024)):
        m = 300 * 128 + 5
        outs, plans = _layer_pair(cuda, m, k, n, n, seed=n)
        assert all(p.row_tiles == 301 and p.row_tiles > p.slots for p in plans)
        _layer_pair_close(outs)
        again, _ = _layer_pair(cuda, m, k, n, n, seed=n)
        assert torch.equal(outs[0][4], again[0][4])


def test_layer_products_refuse_rows_tma_cannot_read(cuda):
    """A and W are read by TMA: a row stride off 16 bytes or a start off 16
    bytes is refused before any launch."""
    bf = lambda *s: torch.randn(s, device=cuda).to(torch.bfloat16)
    a, w, wt = bf(64, 64), bf(64, 64), bf(64, 64)
    x = torch.zeros(64, 64, device=cuda)
    before = (layer_fwd.launches, layer_bwd.launches)
    with pytest.raises(ValueError, match="TMA"):
        layer_fwd(bf(64, 68)[:, :64], w, None, x=x)  # rows 136 bytes apart
    with pytest.raises(ValueError, match="TMA"):
        layer_fwd(a, bf(64 * 64 + 4)[4:].view(64, 64), None, x=x)  # starts 8 bytes off
    with pytest.raises(ValueError, match="TMA"):
        layer_bwd(bf(64, 72)[:, 4:68], wt, x=x)
    assert (layer_fwd.launches, layer_bwd.launches) == before


# widths off the chains' that the wrappers zero-pad (ops/resnetfc.py:
# chain_plan): (hidden, d_latent as levels, d_out)
PADDED_WIDTHS = {
    "hidden 16": (16, [(16, 16, 32), (8, 8, 32)], 4),
    "hidden 32": (32, [(16, 16, 32), (8, 8, 32)], 4),
    "hidden 192": (192, [(16, 16, 32), (8, 8, 32)], 4),
    "hidden 384": (384, [(16, 16, 64), (8, 8, 64)], 4),
    "d_latent 96": (64, [(16, 16, 32), (8, 8, 64)], 4),
    "d_out 20": (64, [(16, 16, 32), (8, 8, 32)], 20),
}


@pytest.mark.parametrize("hidden,levels,d_out", PADDED_WIDTHS.values(), ids=PADDED_WIDTHS.keys())
@pytest.mark.parametrize("ns,sb,b", [(1, 2, 50), (2, 2, 37)])
def test_padded_widths_match_plain(cuda, hidden, levels, d_out, ns, sb, b):
    """Widths the chains are not built for run on the kernels through the
    wrappers' zero padding and output groups, and agree with the plain
    versions at the caller's widths: the ResnetFC's primal, stash forward
    and backward (its stash at the chain's hidden width, cut back for the
    plain backward), the field's primal, stash forward and backward (the
    level gradients at the caller's channels), at the flagship-width
    tolerances (`_out_close`, `_grad_within`)."""
    rng = np.random.default_rng(hidden + d_out + ns)
    combine, n_blocks = (3 if ns > 1 else 1000), 5
    d_latent = sum(c for *_, c in levels)
    z, xin, w, _ = _mlp_case(rng, cuda, ns, sb, b, hidden=hidden, d_latent=d_latent,
                             combine=combine)
    w = w._replace(w_out=w.w_out.new_tensor(rng.normal(size=(hidden, d_out)) / np.sqrt(hidden)),
                   b_out=w.b_out.new_tensor(rng.normal(size=(d_out,)) * 0.3))
    g = torch.from_numpy(rng.normal(size=(sb, b, d_out)).astype(np.float32)).to(cuda)
    args = (n_blocks, combine, ns)
    cut = lambda t: None if t is None else t[..., :hidden]
    before = (resnetfc_fwd.launches, resnetfc_fwd_stash.launches, resnetfc_bwd.launches)
    out = resnetfc_fwd(z, xin, w, *args)
    out_s, spre, spost = resnetfc_fwd_stash(z, xin, w, *args)
    dz, dxin, dw = resnetfc_bwd(z, xin, g, spre, spost, w, *args)
    torch.cuda.synchronize()
    runs = -(-d_out // 16)  # one launch a group of 16 outputs
    assert (resnetfc_fwd.launches, resnetfc_fwd_stash.launches, resnetfc_bwd.launches) == tuple(
        x + runs for x in before)
    assert torch.equal(out, out_s) and out.shape == (sb, b, d_out)
    if spre is not None:
        assert not spre[..., hidden:].any()
    assert not spost[..., hidden:].any()
    _out_close(out, resnetfc_fwd_plain(z, xin, w, *args))
    wdz, wdxin, wdw = resnetfc_bwd_plain(z, xin, g, cut(spre), cut(spost), w, *args)
    for got, want in ((dz, wdz), (dxin, wdxin), *((getattr(dw, n), getattr(wdw, n))
                                                  for n in FieldWeights._fields)):
        _grad_within(got, want)

    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dt)
    feats = [t(rng.normal(size=(sb * ns, h, ww, c)), torch.bfloat16) for (h, ww, c) in levels]
    grid = t(rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)))
    before = (pyramid_field_fused.launches, pyramid_field_fused_fwd_stash.launches,
              pyramid_field_fused_bwd.launches)
    fout = pyramid_field_fused(feats, grid, xin, w, *args)
    out_s, zs, spre, spost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)
    d_feats, dxin, dw = pyramid_field_fused_bwd(grid, xin, g, zs, spre, spost, w, *args, levels)
    torch.cuda.synchronize()
    assert (pyramid_field_fused.launches, pyramid_field_fused_fwd_stash.launches,
            pyramid_field_fused_bwd.launches) == tuple(x + runs for x in before)
    assert torch.equal(fout, out_s)
    _out_close(fout, field_plain(feats, grid, xin, w, *args))
    wd_feats, wdxin, wdw = field_bwd_plain(grid, xin, g, zs[..., :d_latent], cut(spre), cut(spost),
                                           w, *args, levels)
    for got, want in zip(d_feats, wd_feats):
        _grad_within(got, want)
    _grad_within(dxin, wdxin)
    for name in FieldWeights._fields:
        _grad_within(getattr(dw, name), getattr(wdw, name))


# ------------------------------------------------- float32 callers' dz and dxin

F32_CASES = {
    "chain_h64_ns1": (64, 1, 2, 50), "chain_h128_ns2": (128, 2, 2, 37),
    "chain_h256_ns3": (256, 3, 1, 45), "chain_h512_ns2": (512, 2, 1, 70),
    "chain_h512_ns5": (512, 5, 2, 13), "layered_h576": (576, 2, 1, 40),
    "layered_65_views": (64, 65, 1, 3),
}
WGRAD_NAMES = ("w_in", "wz", "w0", "w1", "w_out")


def _f32_grads(z, xin, g, spre, spost, w, args):
    dz, dxin, dw = resnetfc_bwd(z, xin, g, spre, spost, w, *args, grad_dtype=torch.float32)
    torch.cuda.synchronize()
    return dz, dxin, dw


@pytest.mark.parametrize("hidden,ns,sb,b", F32_CASES.values(), ids=F32_CASES.keys())
def test_float32_backward_matches_plain(cuda, hidden, ns, sb, b):
    """The backward for a float32 caller (bf16 copies of its z and xin, as
    `resnetfc_fused` makes them): dz and dxin float32 from the chain's F32
    store (or the layered path's float32 sums), unrounded, within the bf16
    backward's bounds of the plain backward's float32 ones from the same
    stash; rounded to bf16 they equal the bf16 backward's dz and dxin bit
    for bit (the same sums, rounded at the store), whose weight gradients
    they share; and two runs give equal outputs."""
    rng = np.random.default_rng(hidden + ns * 10 + b)
    z, xin, w, g = _mlp_case(rng, cuda, ns, sb, b, hidden=hidden, d_latent=128)
    args = (5, 3, ns)
    _, spre, spost = resnetfc_fwd_stash(z, xin, w, *args)
    before = resnetfc_bwd.launches
    dz, dxin, dw = _f32_grads(z, xin, g, spre, spost, w, args)
    chained = ops_resnetfc.takes_chains(hidden, 128, 42, 4, ns)
    assert chained == (hidden <= 512 and ns <= 64)
    assert resnetfc_bwd.launches == before + chained
    assert dz.dtype == dxin.dtype == torch.float32
    assert dz.shape == z.shape and dxin.shape == xin.shape
    for t in (dz, dxin):
        assert (t != t.to(torch.bfloat16).float()).float().mean() > 0.5  # unrounded
    wdz, wdxin, wdw = resnetfc_bwd_plain(z, xin, g, spre, spost, w, *args,
                                         grad_dtype=torch.float32)
    assert wdz.dtype == wdxin.dtype == torch.float32
    _grad_within(dz, wdz)
    _grad_within(dxin, wdxin)
    for name in FieldWeights._fields:
        _grad_within(getattr(dw, name), getattr(wdw, name))
    bz, bxin, bdw = resnetfc_bwd(z, xin, g, spre, spost, w, *args)
    assert bz.dtype == bxin.dtype == torch.bfloat16
    assert torch.equal(dz.to(torch.bfloat16), bz) and torch.equal(dxin.to(torch.bfloat16), bxin)
    for name in WGRAD_NAMES:
        assert torch.equal(getattr(dw, name), getattr(bdw, name)), name
    dz2, dxin2, dw2 = _f32_grads(z, xin, g, spre, spost, w, args)
    assert torch.equal(dz, dz2) and torch.equal(dxin, dxin2)
    for name in WGRAD_NAMES:
        assert torch.equal(getattr(dw, name), getattr(dw2, name)), name


def test_float32_inputs_through_resnetfc_fused_on_card(cuda):
    """`resnetfc_fused` on float32 z and xin that want gradients: the stash
    forward and the F32 backward launch once each on the bf16 copies of the
    inputs; the output, float32 dz and dxin and the products' weight
    gradients are those of the two wrappers called on those copies, bit for
    bit (the bias sums are float32 atomics: the bf16 backward's bounds), and
    dz and dxin lie within the bf16 backward's bounds of the plain
    backward from that stash."""
    rng = np.random.default_rng(31)
    _, _, w, g = _mlp_case(rng, cuda, 2, 2, 37, hidden=512, d_latent=512)
    z32 = torch.from_numpy(rng.normal(size=(2, 2, 37, 512)).astype(np.float32)).to(cuda)
    x32 = torch.from_numpy(rng.normal(size=(2, 2, 37, 42)).astype(np.float32)).to(cuda)
    zz, xx = z32.clone().requires_grad_(True), x32.clone().requires_grad_(True)
    ww = FieldWeights(*[t.detach().clone().requires_grad_(True) for t in w])
    before = (resnetfc_fwd_stash.launches, resnetfc_bwd.launches, resnetfc_bwd.f32_launches)
    out = resnetfc_fused(zz, xx, ww, 5, 3, 2)
    out.backward(g)
    torch.cuda.synchronize()
    assert (resnetfc_fwd_stash.launches, resnetfc_bwd.launches, resnetfc_bwd.f32_launches) == tuple(
        x + 1 for x in before)
    assert zz.grad.dtype == xx.grad.dtype == torch.float32
    zb, xb = z32.to(torch.bfloat16), x32.to(torch.bfloat16)
    out_s, spre, spost = resnetfc_fwd_stash(zb, xb, w, 5, 3, 2)
    dz, dxin, dw = _f32_grads(zb, xb, g, spre, spost, w, (5, 3, 2))
    assert torch.equal(out, out_s)
    assert torch.equal(zz.grad, dz) and torch.equal(xx.grad, dxin)
    for name in FieldWeights._fields:
        got = getattr(ww, name).grad
        if name in WGRAD_NAMES:
            assert torch.equal(got, getattr(dw, name)), name
        else:
            _grad_within(got, getattr(dw, name))
    wdz, wdxin, _ = resnetfc_bwd_plain(zb, xb, g, spre, spost, w, 5, 3, 2, grad_dtype=torch.float32)
    _grad_within(dz, wdz)
    _grad_within(dxin, wdxin)
