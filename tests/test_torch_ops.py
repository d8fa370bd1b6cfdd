"""Port parity: rays, sampling, compositing, resize and grid-sample.

Each test builds its inputs with numpy from a seed, runs the JAX function
and its counterpart in `pixelnerf_tpu_torch` on the CPU, and compares in
float32. Tolerance: 1e-5 relative (plus a small absolute floor) — the
same float32 formula evaluated by two libraries differs only in rounding
and summation order. Random draws are made with the JAX key the JAX
function uses and handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.ops import composite as jcomp
from pixelnerf_tpu.ops import sampling as jsamp
from pixelnerf_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample
from pixelnerf_tpu.ops.interpolate import resize_bilinear as j_resize
from pixelnerf_tpu.utils import rays as jrays
from pixelnerf_tpu_torch.ops import composite as tcomp
from pixelnerf_tpu_torch.ops import sampling as tsamp
from pixelnerf_tpu_torch.ops.grid_sample import grid_sample_2d as t_grid_sample
from pixelnerf_tpu_torch.ops.interpolate import resize_bilinear as t_resize
from pixelnerf_tpu_torch.utils import rays as trays

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32),
        rtol=rtol, atol=atol,
    )


def _rays(rng, n):
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = rng.uniform(0.5, 1.0, size=(n, 1)).astype(np.float32)
    far = near + rng.uniform(0.5, 2.0, size=(n, 1)).astype(np.float32)
    return np.concatenate([o, d, near, far], axis=-1)


@pytest.mark.parametrize("focal,c", [(30.0, None), ((25.0, 35.0), (7.0, 9.5))])
def test_unproj_map_and_gen_rays(focal, c):
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, :3, :3] = np.linalg.qr(rng.normal(size=(2, 3, 3)))[0]
    poses[:, :3, 3] = rng.normal(size=(2, 3))
    _close(trays.unproj_map(16, 12, focal, c), jrays.unproj_map(16, 12, focal, c))
    got = trays.gen_rays(_t(poses), 16, 12, focal, 0.8, 1.8, c=c)
    want = jrays.gen_rays(jnp.asarray(poses), 16, 12, focal, 0.8, 1.8, c=c)
    assert got.shape == (2, 12, 16, 8)
    _close(got, want)


@pytest.mark.parametrize("agg", ["average", "max"])
def test_repeat_and_combine_interleaved(agg):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    _close(trays.repeat_interleave(_t(x), 2), jrays.repeat_interleave(jnp.asarray(x), 2))
    t = rng.normal(size=(2 * 3 * 5, 7)).astype(np.float32)
    got = trays.combine_interleaved(_t(t), (3, 5), agg)
    want = jrays.combine_interleaved(jnp.asarray(t), (3, 5), agg)
    assert got.shape == (2, 5, 7)
    _close(got, want)


@pytest.mark.parametrize("perturb,lindisp", [(0.0, False), (1.0, False), (0.5, True)])
def test_sample_coarse(perturb, lindisp):
    rng = np.random.default_rng(2)
    rays = _rays(rng, 20)
    key = jax.random.PRNGKey(3)
    want = jsamp.sample_coarse(key, jnp.asarray(rays), 16, lindisp, perturb=perturb)
    jitter = np.asarray(jax.random.uniform(key, (20, 16)))
    got = tsamp.sample_coarse(_t(rays), 16, lindisp, perturb=perturb, jitter=_t(jitter))
    _close(got, want)


@pytest.mark.parametrize("perturb", [0.0, 1.0])
def test_sample_fine(perturb):
    rng = np.random.default_rng(4)
    rays = _rays(rng, 24)
    weights = rng.uniform(0, 1, size=(24, 16)).astype(np.float32) ** 3
    key = jax.random.PRNGKey(5)
    want = jsamp.sample_fine(key, jnp.asarray(rays), jnp.asarray(weights), 8, perturb=perturb)
    k_u, k_j = jax.random.split(key)
    u = np.asarray(jax.random.uniform(k_u, (24, 8), dtype=jnp.float32))
    bj = np.asarray(jax.random.uniform(k_j, (24, 8)))
    got = tsamp.sample_fine(
        _t(rays), _t(weights), 8, perturb=perturb, u=_t(u), bin_jitter=_t(bj)
    )
    _close(got, want)


@pytest.mark.parametrize("perturb", [0.0, 1.0])
def test_sample_fine_depth(perturb):
    rng = np.random.default_rng(6)
    rays = _rays(rng, 24)
    depth = rays[:, 6] + (rays[:, 7] - rays[:, 6]) * rng.uniform(-0.1, 1.1, size=24)
    depth = depth.astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jsamp.sample_fine_depth(
        key, jnp.asarray(rays), jnp.asarray(depth), 6, 0.05, perturb=perturb
    )
    noise = np.asarray(jax.random.normal(key, (24, 6)))
    got = tsamp.sample_fine_depth(
        _t(rays), _t(depth), 6, 0.05, perturb=perturb, noise=_t(noise)
    )
    _close(got, want)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_alpha_composite(white_bkgd):
    rng = np.random.default_rng(8)
    rays = _rays(rng, 32)
    z = np.sort(
        rays[:, 6:7] + (rays[:, 7:8] - rays[:, 6:7]) * rng.uniform(size=(32, 12)),
        axis=-1,
    ).astype(np.float32)
    rgbs = rng.uniform(size=(32, 12, 3)).astype(np.float32)
    sigmas = rng.normal(scale=5.0, size=(32, 12)).astype(np.float32)
    _close(
        tcomp.composite_deltas(_t(z), _t(rays)),
        jcomp.composite_deltas(jnp.asarray(z), jnp.asarray(rays)),
    )
    got = tcomp.alpha_composite(_t(rgbs), _t(sigmas), _t(z), _t(rays), white_bkgd)
    want = jcomp.alpha_composite(
        jnp.asarray(rgbs), jnp.asarray(sigmas), jnp.asarray(z), jnp.asarray(rays),
        white_bkgd,
    )
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize(
    "in_hw,out_hw,align", [((4, 4), (16, 16), True), ((5, 3), (9, 12), True), ((6, 8), (4, 5), False)]
)
def test_resize_bilinear(in_hw, out_hw, align):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2,) + in_hw + (6,)).astype(np.float32)
    got = t_resize(_t(x), out_hw, align_corners=align)
    want = j_resize(jnp.asarray(x), out_hw, align_corners=align)
    assert got.shape == (2,) + out_hw + (6,)
    _close(got, want)


@pytest.mark.parametrize("hw", [(8, 8), (5, 11)])
def test_grid_sample_border_align_corners(hw):
    rng = np.random.default_rng(10)
    feat = rng.normal(size=(3,) + hw + (5,)).astype(np.float32)
    uv = rng.uniform(-1.3, 1.3, size=(3, 40, 2)).astype(np.float32)
    got = t_grid_sample(_t(feat), _t(uv))
    want = j_grid_sample(jnp.asarray(feat), jnp.asarray(uv))
    assert got.shape == (3, 40, 5)
    _close(got, want)
