"""Port parity: ResNet-34 trunk, pyramid packing and the feature lookup.

The JAX `SpatialEncoder` is initialized, its BatchNorm scales, biases and
running statistics are replaced with random values (so eval-mode BN is
not the identity), the variables go through `convert.state_dict_from_jax`
into the port's encoder, and both encode the same 32x32 images made by
numpy from a seed. Float32 throughout. Tolerance 1e-4 absolute and
relative: ~30 convolutions deep, two libraries' float32 convolutions sum
in different orders (about 1e-6 relative each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.models import encoder as jenc
from pixelnerf_tpu_torch.convert import state_dict_from_jax
from pixelnerf_tpu_torch.models import encoder as tenc

TOL = 1e-4


def _randomize_bn(variables, seed):
    rng = np.random.default_rng(seed)

    def walk(tree, kind):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, kind)
            elif kind == "stats" and k == "var":
                out[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
            elif kind == "stats" or k in ("scale", "bias"):
                out[k] = rng.normal(scale=0.3, size=v.shape).astype(np.float32) + (k == "scale")
            else:
                out[k] = np.asarray(v)
        return out

    return {
        "params": walk(variables["params"], "params"),
        "batch_stats": walk(variables["batch_stats"], "stats"),
    }


@pytest.fixture(scope="module")
def encoders():
    jmod = jenc.SpatialEncoder(backbone="resnet34", num_layers=4)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    variables = _randomize_bn(jax.device_get(jmod.init(jax.random.PRNGKey(0), x)), 1)
    tmod = tenc.SpatialEncoder(backbone="resnet34", num_layers=4)
    sd = state_dict_from_jax({"params": {"encoder": variables["params"]},
                              "batch_stats": {"encoder": variables["batch_stats"]}})
    sd = {k[len("encoder."):]: v for k, v in sd.items()}
    tmod.load_state_dict(sd, strict=True)
    tmod.eval()
    return jmod, variables, tmod


def _images(seed, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, size=(n, 32, 32, 3)).astype(np.float32)


def test_trunk_and_packing_match_jax(encoders):
    jmod, variables, tmod = encoders
    imgs = _images(2)
    jlevels, jscale = jmod.apply(variables, jnp.asarray(imgs))
    with torch.no_grad():
        tlevels, tscale = tmod(torch.from_numpy(imgs))
    # stem + layer1 packed into one 128-channel level; layer2; layer3
    assert [tuple(l.shape) for l in tlevels] == [(2, 16, 16, 128), (2, 4, 4, 128), (2, 2, 2, 256)]
    for t, j in zip(tlevels, jlevels):
        assert t.is_contiguous()
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tscale.numpy(), np.asarray(jscale), rtol=1e-6)


def test_compose_and_index_features_match_jax(encoders):
    jmod, variables, tmod = encoders
    imgs = _images(3)
    jlevels, jscale = jmod.apply(variables, jnp.asarray(imgs))
    with torch.no_grad():
        tlevels, tscale = tmod(torch.from_numpy(imgs))
    np.testing.assert_allclose(
        tenc.compose_pyramid(tlevels).numpy(),
        np.asarray(jenc.compose_pyramid(jlevels)), rtol=TOL, atol=TOL,
    )
    uv = np.random.default_rng(4).uniform(-3, 35, size=(2, 50, 2)).astype(np.float32)
    size = np.array([32.0, 32.0], np.float32)
    want = jenc.index_features(
        jlevels, jscale, jnp.asarray(uv), jnp.asarray(size), allow_fused=False
    )
    got = tenc.index_features(tlevels, tscale, torch.from_numpy(uv), torch.from_numpy(size))
    assert got.shape == (2, 50, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hw", [(64, 64), (16, 24)])
def test_latent_scaling_for(hw):
    np.testing.assert_allclose(
        tenc.latent_scaling_for(hw).numpy(), np.asarray(jenc.latent_scaling_for(hw)), rtol=0
    )


@pytest.mark.parametrize("index_interp", ["bilinear", "nearest", "nearest "])
def test_compose_pyramid_align_corners_quirk(index_interp):
    """Only index_interp == "nearest " (trailing space) turns align_corners
    off for the upsampling, as the reference compares it."""
    rng = np.random.default_rng(6)
    levels = [rng.normal(size=s).astype(np.float32) for s in [(1, 8, 8, 4), (1, 3, 3, 4)]]
    want = jenc.compose_pyramid([jnp.asarray(l) for l in levels], "bilinear", index_interp)
    got = tenc.compose_pyramid([torch.from_numpy(l) for l in levels], "bilinear", index_interp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    aligned = tenc.compose_pyramid([torch.from_numpy(l) for l in levels])
    assert torch.equal(got, aligned) == (index_interp != "nearest ")


def test_pack_pyramid_levels_matches_jax():
    rng = np.random.default_rng(5)
    levels = [
        rng.normal(size=s).astype(np.float32)
        for s in [(1, 16, 16, 64), (1, 8, 8, 64), (1, 4, 4, 128), (1, 2, 2, 256)]
    ]
    want = jenc.pack_pyramid_levels([jnp.asarray(l) for l in levels])
    got = tenc.pack_pyramid_levels([torch.from_numpy(l) for l in levels])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
