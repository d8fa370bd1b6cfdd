"""Port parity: the single-map bilinear lookup (ops/scatter.py) and the
nearest resize (ops/interpolate.py).

`bilerp_gather` and `bilerp_scatter_add` on CPU tensors run their plain
versions. They are held against the Pallas kernels of
`pixelnerf_tpu/ops/scatter_pallas.py` in interpret mode on the same numpy
inputs: maps of 5x7 and 8x8 pixels, points on the border (exact corners,
the far edges, where a tap is dropped) and beyond it, and point counts
that are not a multiple of the TPU kernel's 512-point tile.
`grid_sample_border_train`'s gradients are held against the JAX custom
VJP, for one consumer and for two (the dual lookup, whose two bf16
cotangents autograd adds, as JAX does). `resize_nearest` is held against
JAX's forward and gradient in float32 and bf16. Past 8,192 pixels (dtu's
150x200 map, 91x91), where the JAX package samples with `grid_sample_2d`,
the plain versions take its float32 tap weights and are held against it
and its backward; at 8,192 pixels or fewer (64x128 too) the weights keep
`_onehot_w`'s bf16 rounding; and `index_features` on a CPU map past the
limit still calls `grid_sample_2d`.

Tolerances. Both sides round the same 2x2 weights to bf16 once and form
exact bf16 x bf16 products, so only the order of the float32 sums
differs: the gather agrees to one bf16 ulp (2^-7 relative) plus 1e-6. The
interpret-mode scatter on the CPU rounds each product w * g to bf16
before summing (tests/test_torch_pyramid.py), so the scatter is held to
2^-7 times the sum of |w * g| over each element's contributions, plus
1e-6, and one more bf16 ulp of the result for a bf16 map's gradient. The
nearest resize selects: its forward is exact, its gradient sums a few
cotangents per input pixel (float32: 1e-6 relative; bf16: one ulp). Past
the limit, the plain gather and `grid_sample_2d` sum the same four float32
products, the plain version rounding each product and grid_sample's CPU
kernel fusing it into the sum (FMA): each within 4 * 2^-24 * sum |w * f|
of the exact sum, so 8 * 2^-24 * sum |w * f| apart in float32 and one
bf16 ulp once cast; the plain scatter and grid_sample's backward each
within `scatter_reference`'s bound of the float64 sum (float32 sums of
the same terms in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.ops.interpolate import resize_nearest as j_resize_nearest
from pixelnerf_tpu.ops.scatter_pallas import (
    bilerp_gather as j_gather,
    bilerp_scatter_add as j_scatter,
    grid_sample_border_train as j_gsbt,
)
from pixelnerf_tpu_torch.models import encoder as tenc
from pixelnerf_tpu_torch.ops.interpolate import resize_nearest
from pixelnerf_tpu_torch.ops.scatter import (
    _taps, bilerp_gather, bilerp_scatter_add, bilerp_scatter_add_plain, fused_supported,
    grid_sample_border_train,
)
from pixelnerf_tpu_torch.ops.cuda_build import SMEM_LIMIT
from pixelnerf_tpu_torch.ops.field import level_scatter_plan
from pixelnerf_tpu_torch.ops.grid_sample import grid_sample_2d
from pixelnerf_tpu_torch.ops.gather_plan import (
    BLOCKS_PER_SM, STAGE_BYTES, count_tap_bytes, plan_gather, table_bytes,
)
from pixelnerf_tpu_torch.ops.pyramid import _level_taps
from pixelnerf_tpu_torch.ops.pyramid import pyramid_scatter_add_plain as tpyr_scatter_plain
from pixelnerf_tpu_torch.ops.scatter_plan import (
    RUN, SLICE_MAX, SLICE_MIN, STAGE, THREADS, WARPS, count_reductions, plan_scatter,
    scatter_reference,
)
from tests.scatter_uv import ray_uv

BF16_ULP = 2.0 ** -7


def _uv(rng, b, n):
    uv = rng.uniform(-1.3, 1.3, size=(b, n, 2)).astype(np.float32)
    uv[:, 0] = [1.0, 1.0]  # the far corner: both second taps dropped
    uv[:, 1] = [-1.0, -1.0]
    uv[:, 2] = [1.0, -0.3]
    uv[:, 3] = [-0.5, 1.0]
    return uv


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _bound(uv, g, hl, wl):
    """2^-7 * sum of |w * g| per element of the gradient, plus 1e-6."""
    mag = bilerp_scatter_add_plain(torch.from_numpy(uv), g.float().abs(), hl, wl)
    return BF16_ULP * mag.numpy() + 1e-6


# random points with the corners and far edges; then ray-coherent ones
@pytest.mark.parametrize("b,hl,wl,c,n,rays", [
    pytest.param(2, 5, 7, 8, 33, False, id="2-5-7-8-33"),
    pytest.param(3, 8, 8, 16, 515, False, id="3-8-8-16-515"),
    pytest.param(2, 8, 8, 16, 515, True, id="2-8-8-16-515-rays"),
    pytest.param(1, 64, 128, 8, 300, True, id="1-64-128-8-300-rays"),
])
def test_gather_matches_pallas(b, hl, wl, c, n, rays):
    rng = np.random.default_rng(b * 100 + n + rays)
    feat = rng.normal(size=(b, hl, wl, c)).astype(np.float32)
    uv = ray_uv(rng, b, n, 1.0 / 7) if rays else _uv(rng, b, n)
    want = np.asarray(
        j_gather(jnp.asarray(feat, jnp.bfloat16), jnp.asarray(uv), interpret=True).astype(jnp.float32)
    )
    before = bilerp_gather.launches
    got = bilerp_gather(_bf16(feat), torch.from_numpy(uv))
    assert bilerp_gather.launches == before  # CPU tensors: no kernel
    assert got.shape == (b, n, c) and got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-6)


# random points, and ray-coherent ones (runs of samples along rays, about
# half a pixel apart, as a train step's lookups see them)
@pytest.mark.parametrize("b,hl,wl,c,n,rays", [
    pytest.param(2, 5, 7, 8, 33, False, id="2-5-7-8-33"),
    pytest.param(3, 8, 8, 16, 515, False, id="3-8-8-16-515"),
    pytest.param(2, 8, 8, 16, 515, True, id="2-8-8-16-515-rays"),
    pytest.param(1, 64, 128, 8, 300, True, id="1-64-128-8-300-rays"),
])
def test_scatter_matches_pallas(b, hl, wl, c, n, rays):
    rng = np.random.default_rng(b * 10 + n + rays)
    uv = ray_uv(rng, b, n, 1.0 / 7) if rays else _uv(rng, b, n)
    dz = rng.normal(size=(b, n, c)).astype(np.float32)
    want = np.asarray(j_scatter(jnp.asarray(uv), jnp.asarray(dz), hl, wl, interpret=True))
    before = bilerp_scatter_add.launches
    got = bilerp_scatter_add(torch.from_numpy(uv), torch.from_numpy(dz), hl, wl)
    assert bilerp_scatter_add.launches == before
    assert got.shape == (b, hl, wl, c) and got.dtype == torch.float32
    # the scatter rounds the cotangent to bf16, as the TPU kernel
    assert np.all(np.abs(got.numpy() - want) <= _bound(uv, _bf16(dz), hl, wl))
    assert torch.equal(got, bilerp_scatter_add(torch.from_numpy(uv), _bf16(dz), hl, wl))


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grid_sample_border_train_matches_jax(dual, dtype):
    """Forward and the map's gradient, with one consumer or two; the
    gradient for uv is zero. A float32 map is gathered by grid_sample
    (`_fwd_gather`) and scattered by the bf16 kernel."""
    rng = np.random.default_rng(3 + dual)
    b, hl, wl, c, n = 2, 6, 5, 8, 70
    feat, uv = rng.normal(size=(b, hl, wl, c)).astype(np.float32), _uv(rng, b, n)
    g1, g2 = rng.normal(size=(2, b, n, c)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jfn(f, u):
        out = j_gsbt(f, u, True)
        return (out, out) if dual else out

    jout, vjp = jax.vjp(jfn, jnp.asarray(feat, jdt), jnp.asarray(uv))
    cot = (jnp.asarray(g1, jdt), jnp.asarray(g2, jdt)) if dual else jnp.asarray(g1, jdt)
    jd_feat, jd_uv = vjp(cot)

    tf = torch.from_numpy(feat).to(tdt).requires_grad_(True)
    tuv = torch.from_numpy(uv).requires_grad_(True)
    out = grid_sample_border_train(tf, tuv)
    t1, t2 = torch.from_numpy(g1).to(tdt), torch.from_numpy(g2).to(tdt)
    if dual:
        # the lookup's two consumers: autograd adds the two cotangents in
        # the map's dtype before the scatter
        torch.autograd.backward([out, out], [t1, t2])
        gsum = t1 + t2
    else:
        out.backward(t1)
        gsum = t1
    want = np.asarray((jout[0] if dual else jout).astype(jnp.float32))
    assert out.dtype == tdt
    got = out.detach().float().numpy()
    if dtype == "bfloat16":
        assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.asarray(jd_uv).any() and not tuv.grad.any()
    assert tf.grad.dtype == tdt
    jd = np.asarray(jd_feat.astype(jnp.float32))
    tol = _bound(uv, gsum.to(torch.bfloat16), hl, wl) + BF16_ULP * np.abs(jd)
    assert np.all(np.abs(tf.grad.float().numpy() - jd) <= tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("in_hw,out_hw", [((4, 4), (16, 16)), ((3, 5), (8, 12)), ((8, 8), (8, 8))])
def test_resize_nearest_matches_jax(dtype, in_hw, out_hw):
    rng = np.random.default_rng(sum(in_hw) + sum(out_hw))
    x = rng.normal(size=(2,) + in_hw + (6,)).astype(np.float32)
    g = rng.normal(size=(2,) + out_hw + (6,)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout, vjp = jax.vjp(lambda a: j_resize_nearest(a, out_hw), jnp.asarray(x, jdt))
    (jgx,) = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    out = resize_nearest(tx, out_hw)
    out.backward(torch.from_numpy(g).to(tdt))
    assert out.dtype == tx.grad.dtype == tdt and out.shape == (2,) + out_hw + (6,)
    np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(jout.astype(jnp.float32)))
    jgx = np.asarray(jgx.astype(jnp.float32))
    rel = 1e-6 if dtype == "float32" else BF16_ULP
    assert np.all(np.abs(tx.grad.float().numpy() - jgx) <= rel * np.abs(jgx) + 1e-6)


def test_index_features_routes_single_maps(monkeypatch):
    """A bf16 map of at most 8192 pixels under the bilinear, border lookup
    takes grid_sample_border_train (as the JAX package's `index_features`
    on a TPU); a float32 map, a larger map or another lookup grid_sample."""
    assert fused_supported(64, 64) and fused_supported(64, 128) and not fused_supported(128, 128)
    calls = []
    orig = tenc.grid_sample_border_train
    monkeypatch.setattr(tenc, "grid_sample_border_train", lambda *a: calls.append(1) or orig(*a))
    uv = torch.rand(2, 9, 2) * 30
    size, scale = torch.tensor([32.0, 32.0]), torch.tensor([2.0, 2.0])
    cases = [
        (torch.bfloat16, (16, 16), "border", True), (torch.float32, (16, 16), "border", False),
        (torch.bfloat16, (128, 128), "border", False), (torch.bfloat16, (16, 16), "zeros", False),
    ]
    for dtype, hw, padding, taken in cases:
        calls.clear()
        latent = torch.randn((2,) + hw + (4,)).to(dtype)
        out = tenc.index_features(latent, scale, uv, size, index_padding=padding)
        assert out.shape == (2, 9, 4) and bool(calls) == taken
    pair = tenc.index_features(torch.randn(2, 8, 8, 4).to(torch.bfloat16), scale, uv, size, dual=True)
    assert pair[0] is pair[1]


@pytest.mark.parametrize("hl,wl,rounded", [(8, 8, True), (64, 128, True), (91, 91, False),
                                            (150, 200, False)])
def test_taps_round_by_the_maps_size(hl, wl, rounded):
    """The weights round to bf16 (`_onehot_w`) on a map of at most 8,192
    pixels and are grid_sample's float32 products past it; the indices and
    the dropped taps are the same either way."""
    rng = np.random.default_rng(hl * wl)
    uv = torch.from_numpy(_uv(rng, 2, 300))
    idx, w = _taps(uv, hl, wl)
    assert fused_supported(hl, wl) == rounded
    assert torch.equal(w, w.to(torch.bfloat16).float()) == rounded
    x = ((uv[..., 0] + 1.0) * 0.5 * (wl - 1)).clamp(0.0, wl - 1.0)
    y = ((uv[..., 1] + 1.0) * 0.5 * (hl - 1)).clamp(0.0, hl - 1.0)
    fx, fy = x - x.floor(), y - y.floor()
    prod = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx], -1)
    prod = torch.where(w == 0, torch.zeros_like(prod), prod)  # dropped taps
    assert torch.equal(w, prod.to(torch.bfloat16).float() if rounded else prod)
    assert torch.equal(idx[..., 0], y.floor().long() * wl + x.floor().long())


# past the limit: a random 91x91 map with the corners and far edges, and
# ray-coherent points on dtu's composed 150x200 map
@pytest.mark.parametrize("b,hl,wl,c,n,rays", [
    pytest.param(2, 91, 91, 16, 5003, False, id="91x91"),
    pytest.param(3, 150, 200, 8, 10007, True, id="150x200-rays"),
])
def test_plain_lookup_past_the_limit_matches_grid_sample(b, hl, wl, c, n, rays):
    """The plain gather and scatter on a map past 8,192 pixels against
    grid_sample_2d and its autograd backward on the CPU, in float32 (a
    float32 map of bf16 values) and with the bf16 map."""
    rng = np.random.default_rng(hl + n)
    uv = torch.from_numpy(ray_uv(rng, b, n, 1.0 / wl) if rays else _uv(rng, b, n))
    feat = _bf16(rng.normal(size=(b, hl, wl, c)))
    assert not fused_supported(hl, wl)
    f32 = feat.float()
    got, want = bilerp_gather(f32, uv), grid_sample_2d(f32, uv)
    mag = bilerp_gather(f32.abs(), uv)
    assert ((got - want).abs() <= 8 * 2.0 ** -24 * mag).all()
    got, want = bilerp_gather(feat, uv), grid_sample_2d(feat, uv)
    assert got.dtype == want.dtype == torch.bfloat16
    assert ((got.float() - want.float()).abs() <= BF16_ULP * want.float().abs() + 1e-6).all()
    g = _bf16(rng.normal(size=(b, n, c)))
    f = f32.clone().requires_grad_(True)
    grid_sample_2d(f, uv).backward(g.float())
    ref, bound = scatter_reference(*_taps(uv, hl, wl), g, hl * wl)
    for grad in (bilerp_scatter_add(uv, g, hl, wl), f.grad):
        assert ((grad.double().reshape(ref.shape) - ref).abs() <= bound).all()
    # the map's gradient through grid_sample_border_train: the scatter, cast
    fb = feat.clone().requires_grad_(True)
    grid_sample_border_train(fb, uv).backward(g)
    assert torch.equal(fb.grad, bilerp_scatter_add(uv, g, hl, wl).to(torch.bfloat16))


def test_index_features_keeps_grid_sample_past_the_limit_on_the_cpu(monkeypatch):
    """On the CPU a bf16 map past 8,192 pixels still takes grid_sample_2d,
    as the JAX package's route: the parity tests see what they saw."""
    calls = []
    orig = tenc.grid_sample_2d
    monkeypatch.setattr(tenc, "grid_sample_2d", lambda *a, **k: calls.append(1) or orig(*a, **k))
    monkeypatch.setattr(tenc, "grid_sample_border_train", lambda *a: pytest.fail("took the kernels"))
    uv = torch.rand(2, 9, 2) * 180
    size, scale = torch.tensor([182.0, 182.0]), torch.tensor([2.0, 2.0])
    latent = torch.randn(2, 91, 91, 4).to(torch.bfloat16)
    out = tenc.index_features(latent, scale, uv, size)
    assert calls == [1] and out.dtype == torch.bfloat16
    assert torch.equal(out, orig(latent, uv * (scale / size) - 1.0))


def _interval(k, size, total):
    return k * size, min((k + 1) * size, total)


def _decoded_units(plan):
    """Each block of the launch as `csrc/scatter_accum.cuh:scatter_block`
    decodes its index: (map, b, channel interval, point interval)."""
    units = []
    for u in range(plan.units):
        seg = [s for s in plan.segments if s.first <= u][-1]
        k = u - seg.first
        chunk, k = k % seg.nchunks, k // seg.nchunks
        units.append((seg.map, k // seg.nslices, seg.slice * (k % seg.nslices), seg.chunk * chunk))
    return units


def _tiles(starts, size, total):
    """The intervals of `size` from `starts` tile [0, total) once."""
    ends = [min(s + size, total) for s in starts]
    return sorted(starts) == list(range(0, total, size)) and max(ends) == total


# the plans of the flagship's lookups (8 maps; 65,536 coarse and 32,768 new
# fine points a map; srn.conf's three packed levels with 3x3 taps, or one
# composed 64x64x512 map with 2x2) and of the card tests' shapes
# (tests/test_torch_cuda_kernels.py)
PLAN_CASES = [
    ([(64, 64, 128), (16, 16, 128), (8, 8, 256)], 8, 65536, 3),
    ([(64, 64, 128), (16, 16, 128), (8, 8, 256)], 8, 32768, 3),
    ([(64, 64, 512)], 8, 65536, 2),
    ([(64, 64, 512)], 8, 32768, 2),
    ([(16, 16, 64), (4, 4, 64), (2, 2, 128)], 6, 1003, 3),
    ([(64, 128, 16), (32, 64, 16), (16, 32, 32), (8, 16, 64)], 2, 3001, 3),
    ([(16, 16, 6), (8, 8, 10), (4, 4, 130)], 2, 777, 3),
    ([(64, 64, 130), (16, 16, 10), (8, 8, 6)], 1, 1, 3),
    ([(5, 7, 8)], 2, 33, 2),
    ([(8, 8, 512)], 1, 513, 2),
    ([(64, 64, 10)], 2, 1000, 2),
]


@pytest.mark.parametrize("maps,nb,n,taps", PLAN_CASES)
def test_scatter_plan_covers_each_map_channel_and_point_once(maps, nb, n, taps):
    """Every (map, b, channel, point) in exactly one unit of the launch, the
    shared-memory segments first, every unit's block and tap table within a
    Hopper block's shared memory and a 16-byte vector only where the
    channels allow it."""
    plan = plan_scatter(maps, nb, n, [True] * len(maps), 132, taps)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert [s.first for s in plan.segments] == sorted(s.first for s in plan.segments)
    assert [s.smem for s in plan.segments] == sorted((s.smem for s in plan.segments), reverse=True)
    assert sorted(s.map for s in plan.segments) == list(range(len(maps)))
    assert sum(s.units for s in plan.segments) == plan.units
    units = _decoded_units(plan)
    assert len(set(units)) == len(units) == plan.units
    for seg in plan.segments:
        h, w, c = maps[seg.map]
        assert c % seg.vec == 0 and seg.slice % seg.vec == 0 and (seg.vec == 2 or c % 4 == 0)
        if seg.smem:
            assert min(c, SLICE_MIN) <= seg.slice <= SLICE_MAX
            pts = min(THREADS, max(32, STAGE // (2 * seg.slice) // 32 * 32))
            # taps, bf16 stage, the warps' lists
            batch = pts * (16 * -(-(taps * taps + 3) // 4) + 2 * seg.slice) + 4 * WARPS + 2 * WARPS * pts
            assert seg.smem_bytes == 16 * -(-(h * w * seg.slice) // 4) + batch <= plan.smem_bytes
        else:
            assert (seg.slice, seg.nslices, seg.chunk) == (c, 1, WARPS * RUN)
        mine = [u for u in units if u[0] == seg.map]
        assert sorted({u[1] for u in mine}) == list(range(nb))
        for b in range(nb):
            cs = {u[2] for u in mine if u[1] == b}
            ps = {u[3] for u in mine if u[1] == b}
            assert _tiles(cs, seg.slice, c) and _tiles(ps, seg.chunk, n)
            assert len([u for u in mine if u[1] == b]) == len(cs) * len(ps)


def test_scatter_plan_keeps_the_flagship_small_levels_in_shared_memory():
    """srn.conf's 16x16x128 and 8x8x256 levels take shared-memory units of
    64 and 256 channels; its fine level and the composed map do not fit."""
    plan = plan_scatter([(64, 64, 128), (16, 16, 128), (8, 8, 256)], 8, 65536, [True] * 3, 132, 3)
    got = {s.map: (s.smem, s.slice, s.vec) for s in plan.segments}
    assert got == {0: (False, 128, 4), 1: (True, 64, 4), 2: (True, 256, 4)}
    # the f32 block, then a batch of 256 (level 1) points' taps, bf16
    # cotangents and the warps' lists
    assert plan.smem_bytes == 64 * 1024 + 256 * (48 + 128) + 4 * 8 + 2 * 8 * 256
    (seg,) = plan_scatter([(64, 64, 512)], 8, 65536, [True], 132, 2).segments
    assert not seg.smem and seg.vec == 4
    (seg,) = plan_scatter([(64, 64, 512)], 8, 65536, [False], 132, 2).segments
    assert seg.vec == 2  # rows not 8-byte aligned: 8-byte vectors


@pytest.mark.parametrize("maps,n", [([(64, 64, 130)], 100), ([(16, 16, 6)], 1000)])
def test_count_reductions_at_one_point(maps, n):
    """Every point at one uv: a global map's warps make one reduction a
    lane and tap a run; a shared-memory map's units one flush vector a lane
    and tapped pixel; the scalar design one atomic a channel and tap a
    point."""
    (h, w, c), nb = maps[0], 2
    uv = torch.full((nb, n, 2), 0.3)
    idx, wt = _taps(uv, h, w)
    plan = plan_scatter(maps, nb, n, [True], 132, 2)
    got = count_reductions(plan, maps, [(idx, wt)])
    (seg,) = plan.segments
    taps = int((wt[0, 0] != 0).sum())
    assert got["scalar"] == nb * n * taps * c
    lanes = -(-c // seg.vec)
    if seg.smem:
        assert got["vector"] == 0 and got["shared"] == got["scalar"]
        assert got["flush"] == nb * seg.nchunks * taps * lanes
    else:
        assert got["flush"] == got["shared"] == 0
        assert got["vector"] == nb * -(-n // RUN) * taps * lanes


def _brute_tap_bytes(plan, maps, taps):
    """count_tap_bytes as the kernels walk their points: each unit's streams
    in order, map 0's cache holding the rows it loaded while the tap base
    holds."""
    out = dict(window=0, nonzero=0, shared=0, device=0, staged=0)
    for i, ((h, w, c), (idx, wt)) in enumerate(zip(maps, taps)):
        idx, wt = idx.numpy(), wt.numpy()
        b, n, t = wt.shape
        nz = int((wt != 0).sum()) * 2 * c
        out["window"] += b * n * t * 2 * c
        out["nonzero"] += nz
        if plan.soff[i] >= 0:
            out["shared"] += nz
            out["staged"] += plan.units * h * w * 2 * c
        elif i > 0 or not plan.cached:
            out["device"] += nz
        else:
            for bb in range(b):
                for p0 in range(0, n, plan.chunk):
                    p1 = min(n, p0 + plan.chunk)
                    slen = -(-(p1 - p0) // plan.streams)
                    for s in range(plan.streams):
                        key, have = -1, set()
                        for q in range(p0 + s * slen, min(p1, p0 + (s + 1) * slen)):
                            if idx[bb, q, 0] != key:
                                key, have = idx[bb, q, 0], set()
                            for k in range(t):
                                if wt[bb, q, k] != 0 and k not in have:
                                    have.add(k)
                                    out["device"] += 2 * c
    return out


# the pyramid's lookup (16 lanes a point, map 0 cached when not staged) and
# the bilerp map's (32 lanes), on random and ray-coherent points; few SMs,
# so that the units are long and the streams cross tap bases
TAP_CASES = [
    ("pyramid", [(32, 32, 8), (8, 8, 8), (4, 4, 16)], 2, 700, "rays", 4),
    ("pyramid", [(32, 32, 8), (8, 8, 8), (4, 4, 16)], 3, 515, "random", 4),
    ("pyramid", [(16, 16, 8), (5, 5, 8), (4, 4, 16)], 2, 600, "rays", 1),
    ("pyramid", [(32, 32, 130), (8, 8, 6)], 1, 333, "rays", 2),
    ("bilerp", [(24, 24, 16)], 2, 1000, "rays", 2),
    ("bilerp", [(9, 7, 8)], 3, 257, "random", 1),
]


@pytest.mark.parametrize("kind,maps,b,n,uvs,sms", TAP_CASES)
def test_count_tap_bytes_matches_the_kernels_walk(kind, maps, b, n, uvs, sms):
    from pixelnerf_tpu_torch.ops.pyramid import _level_taps

    rng = np.random.default_rng(n + b)
    hf, wf = maps[0][:2]
    uv = torch.from_numpy(
        ray_uv(rng, b, n, 0.4 / wf) if uvs == "rays"
        else rng.uniform(-1.2, 1.2, size=(b, n, 2)).astype(np.float32)
    )
    lanes, rows = (16, 1) if kind == "pyramid" else (32, 2)
    plan = plan_gather(maps, b, n, sms, lanes, rows, True)
    if kind == "pyramid":
        taps = [_level_taps(uv, h, w, hf, wf, torch.bfloat16) for h, w, _ in maps]
    else:
        taps = [_taps(uv, hf, wf)]
    got = count_tap_bytes(plan, maps, taps)
    assert got == _brute_tap_bytes(plan, maps, taps)
    assert got["nonzero"] == got["shared"] + sum(
        int((t[1] != 0).sum()) * 2 * c for i, (t, (_, _, c)) in enumerate(zip(taps, maps))
        if plan.soff[i] < 0
    )
    assert got["device"] <= got["nonzero"] - got["shared"] < got["window"]


def test_gather_plan_stages_the_flagship_small_levels():
    """srn.conf's 16x16x128 and 8x8x256 levels go to shared memory, the
    fine level to the register cache; a map just past the budget, a call of
    fewer points than a map's pixels, and the composed 64x64x512 map stay
    in device memory."""
    levels = [(64, 64, 128), (16, 16, 128), (8, 8, 256)]
    plan = plan_gather(levels, 8, 65536, 132, 16, 1, True)
    table = table_bytes(3)  # 15 words a thread
    assert table == 15 * 4 * 256
    assert plan.soff == (-1, table + 32768, table)
    assert plan.smem_bytes == table + 98304 <= STAGE_BYTES
    assert plan.cached and plan.vec == 8 and plan.units == 8 * plan.nchunks
    assert plan.chunk * plan.nchunks >= 65536 and plan.units <= BLOCKS_PER_SM * 132
    # 16 x 16 x c bf16 beside two maps' table: c = 200 fits the budget, 208 not
    fits = plan_gather([(64, 64, 128), (16, 16, 200)], 8, 65536, 132, 16, 1, True)
    assert fits.soff == (-1, table_bytes(2)) and fits.smem_bytes <= STAGE_BYTES
    assert plan_gather([(64, 64, 128), (16, 16, 208)], 8, 65536, 132, 16, 1, True).soff == (-1, -1)
    one = plan_gather(levels, 3, 1, 132, 16, 1, True)
    assert one.soff == (-1, -1, -1) and one.smem_bytes == table and (one.chunk, one.units) == (1, 3)
    few = plan_gather(levels, 2, 200, 132, 16, 1, True)  # fewer points than 16x16 pixels
    assert few.soff == (-1, -1, table)
    odd = plan_gather([(64, 64, 130), (16, 16, 10), (8, 8, 6)], 2, 999, 132, 16, 1, True)
    assert odd.vec == 2 and not odd.cached  # 130 channels: 8 groups of 2 a lane
    (soff,) = plan_gather([(64, 64, 512)], 8, 65536, 132, 32, 2, True).soff
    bil = plan_gather([(64, 64, 512)], 8, 65536, 132, 32, 2, True)
    assert soff == -1 and bil.cached and bil.vec == 8
    assert not plan_gather([(64, 64, 512)], 8, 65536, 132, 32, 2, False).cached  # 4-byte loads
    assert plan_gather([(8, 8, 512)], 1, 513, 132, 32, 2, True).soff == (table_bytes(1),)


def _brute_level_reductions(levels, uv, ns):
    """The backward chain's level scatter (csrc/bwd_chain.cuh: scatter_gz)
    walked point by point: each map's tiles of 64 // NS points, each level
    in turn; a run of points keeps one tap base, and at each change and at
    the tile's end its lanes make one reduction a nonzero tap of the run.
    Returns (one atomic a channel and nonzero tap, the walk's reductions)."""
    nb, n, _ = uv.shape
    run, (hf, wf), c0 = 64 // ns, levels[0][:2], 0
    scalar = vector = 0
    for h, w, c in levels:
        lanes = -(-c // (4 if c % 4 == 0 and c0 % 4 == 0 else 2))
        c0 += c
        idx, wt = _level_taps(uv, h, w, hf, wf, torch.bfloat16)
        for m in range(nb):
            for p0 in range(0, n, run):
                cur, touched = None, set()
                for q in range(p0, min(p0 + run, n)):
                    nz = {t for t in range(9) if wt[m, q, t] != 0}
                    scalar += len(nz) * c
                    if int(idx[m, q, 0]) != cur:
                        vector += len(touched) * lanes
                        cur, touched = int(idx[m, q, 0]), set()
                    touched |= nz
                vector += len(touched) * lanes
    return scalar, vector


@pytest.mark.parametrize("ns", [1, 2, 3])
@pytest.mark.parametrize("kind", ["rays", "random"])
def test_level_scatter_reductions_match_the_chains_walk(kind, ns):
    """`count_reductions` over `level_scatter_plan` against the walk of the
    chain's epilogue, on levels whose channel counts or offsets are not all
    quads (8-byte reductions there), tiles of 64, 32 and 21 points."""
    levels, nb, n = [(16, 16, 62), (8, 8, 66), (4, 4, 128)], 2, 150
    rng = np.random.default_rng(ns * 10 + len(kind))
    uv = ray_uv(rng, nb, n, 1.0 / 16) if kind == "rays" else rng.uniform(-1.2, 1.2, (nb, n, 2))
    uv = torch.from_numpy(np.asarray(uv, np.float32))
    taps = [_level_taps(uv, h, w, 16, 16, torch.bfloat16) for h, w, _ in levels]
    plan = level_scatter_plan(levels, nb, ns, n)
    assert plan.run == 64 // ns and [s.vec for s in plan.segments] == [2, 2, 4]
    got = count_reductions(plan, levels, taps)
    scalar, vector = _brute_level_reductions(levels, uv, ns)
    assert (got["scalar"], got["vector"], got["flush"], got["shared"]) == (scalar, vector, 0, 0)
    assert vector < scalar


@pytest.mark.parametrize("kind", ["rays", "one"])
def test_scatter_reference_bounds_a_float32_scatter(kind):
    """The card tests' yardstick (ops/scatter_plan.py:scatter_reference):
    the plain float32 scatter, summed in its own order, lies within the
    float32 sum's bound of the float64 one, and the same scatter with one
    point's contribution dropped does not."""
    rng = np.random.default_rng(len(kind))
    nb, n, levels = 2, 400, [(16, 16, 6), (4, 4, 10)]
    uv = ray_uv(rng, nb, n, 1.0 / 16) if kind == "rays" else np.full((nb, n, 2), 0.3, np.float32)
    uv = torch.from_numpy(np.asarray(uv, np.float32))
    dz = torch.from_numpy(rng.normal(size=(nb, n, 16)).astype(np.float32)).to(torch.bfloat16)
    csizes, hws = [c for *_, c in levels], [(h, w) for h, w, _ in levels]
    got = tpyr_scatter_plain(uv, dz, csizes, hws, hws[0])
    dropped = tpyr_scatter_plain(uv[:, 1:], dz[:, 1:], csizes, hws, hws[0])
    c0 = 0
    for grad, less, (h, w, c) in zip(got, dropped, levels):
        idx, wt = _level_taps(uv, h, w, *hws[0], torch.bfloat16)
        want, bound = scatter_reference(idx, wt, dz[..., c0 : c0 + c], h * w)
        c0 += c
        assert bool((bound > 0).any())
        assert ((grad.double().reshape(want.shape) - want).abs() <= bound).all()
        assert not ((less.double().reshape(want.shape) - want).abs() <= bound).all()
