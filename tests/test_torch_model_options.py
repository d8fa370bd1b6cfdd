"""Port parity for the model options off the flagship, forward and
gradients, against the JAX modules on the same numpy inputs and weights
(carried across by `convert.state_dict_from_jax` / `params_from_jax`):

- the trunk's norms `group`, `instance` and `none` (train and eval mode);
- `resize_area` and `SpatialEncoder.feature_scale` (area below 1,
  bilinear with aligned corners above);
- the global `ImageEncoder` (with and without its `fc` projection), and
  the global latent in `query` and `QueryCache` (coarse pass with a cache,
  fine pass from it);
- `ConvEncoder` (`backbone = custom`) in train and eval mode, and at the
  128x128 input size whose global code is 2x2 pixels;
- `ImplicitNet` (`mlp.type = mlp`) with its geometric init, skips, pooling
  and softplus;
- ResnetFC with softplus `beta`, SPADE and latent-only `d_in = 0`;
- `rgb_with_uncertainty`, `rgb_with_background` and `rgb_loss_from_conf`;
- the routing predicate of every option against JAX's `supported_config`.

float32 throughout but for the routing. Tolerances: 1e-4 absolute plus
1e-4 relative on forwards (two libraries' float32 convolutions and products
summing in other orders, ~1e-6 relative each, through up to ~35 layers);
each gradient within 1e-3 of its largest magnitude (the same sums, run
backward, and the group norms' statistics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.models import encoder as jenc
from pixelnerf_tpu.models import losses as jlosses
from pixelnerf_tpu.models.mlp import ImplicitNet as JImplicitNet
from pixelnerf_tpu.models.pixelnerf import make_model as j_make_model
from pixelnerf_tpu.models.resnet import ResNetTrunk as JTrunk
from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.ops.interpolate import resize_area as j_resize_area
from pixelnerf_tpu.ops.resnetfc_pallas import supported_config as j_supported
from pixelnerf_tpu.utils.hocon import loads as j_loads
from pixelnerf_tpu_torch.convert import params_from_jax, state_dict_from_jax
from pixelnerf_tpu_torch.models import encoder as tenc
from pixelnerf_tpu_torch.models import losses as tlosses
from pixelnerf_tpu_torch.models.mlp import ImplicitNet
from pixelnerf_tpu_torch.models.pixelnerf import make_model
from pixelnerf_tpu_torch.models.resnet import ResNetTrunk
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops.interpolate import resize_area
from pixelnerf_tpu_torch.utils.hocon import loads

TOL = 1e-4
GTOL = 1e-3


def _randomize(variables, seed):
    """Every leaf random: kernels over fan-in, norm scales about 1, biases
    and BatchNorm means small, variances positive."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v)
            if k == "var":
                out[k] = rng.uniform(0.5, 1.5, size=v.shape)
            elif k in ("mean", "bias"):
                out[k] = rng.normal(scale=0.1, size=v.shape)
            elif k == "scale":
                out[k] = 1.0 + rng.normal(scale=0.1, size=v.shape)
            else:
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = rng.normal(scale=np.sqrt(1.0 / fan_in), size=v.shape)
            out[k] = out[k].astype(np.float32)
        return out

    return {c: walk(t) for c, t in jax.device_get(variables).items()}


def _scoped(variables, scope):
    return {c: {scope: t} for c, t in variables.items()}


def _load(tmod, variables, scope):
    sd = state_dict_from_jax(_scoped(variables, scope))
    tmod.load_state_dict({k[len(scope) + 1:]: v for k, v in sd.items()}, strict=True)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _grads_close(tmod, jgrads, scope, tol=GTOL):
    want = params_from_jax({scope: jax.device_get(jgrads)})
    got = {f"{scope}.{k}": p.grad for k, p in tmod.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k].numpy()
        assert g is not None, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * (np.abs(w).max() + 1e-6),
                                   err_msg=k)


def _vjp_parity(jmod, variables, jargs, tmod, targs, scope, cot_seed, tol=TOL, gtol=GTOL,
                jkw=None, mutable=False):
    """Forward and parameter gradients of <out, cot> on both sides."""
    jkw = jkw or {}
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def f(p):
        out = jmod.apply({"params": p, **rest}, *jargs, mutable=["batch_stats"] if mutable else False,
                         **jkw)
        return out[0] if mutable else out

    jout, vjp = jax.vjp(f, params)
    cot = np.random.default_rng(cot_seed).normal(size=np.shape(jout)).astype(np.float32)
    (jg,) = vjp(jnp.asarray(cot))
    tout = tmod(*targs)
    _close(tout.detach(), jout, tol)
    (tout * torch.from_numpy(cot)).sum().backward()
    _grads_close(tmod, jg, scope, gtol)


# ------------------------------------------------------------------- norms


@pytest.mark.parametrize("norm", ["group", "instance", "none"])
@pytest.mark.parametrize("train", [False, True])
def test_trunk_norms_match_jax(norm, train):
    jmod = JTrunk(backbone="resnet18", num_stages=2, norm_type=norm)
    x = np.random.default_rng(1).uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    variables = _randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    tmod = ResNetTrunk(backbone="resnet18", num_stages=2, norm_type=norm)
    _load(tmod, variables, "t")
    tmod.train(train)
    jfn = lambda v, xx: jnp.concatenate(
        [l.reshape(l.shape[0], -1) for l in jmod.apply(v, xx, train=train)], -1)
    tfn = lambda xx: torch.cat([l.reshape(l.shape[0], -1) for l in tmod(xx)], -1)
    jout, vjp = jax.vjp(lambda p: jfn({**variables, "params": p}, jnp.asarray(x)),
                        variables["params"])
    cot = np.random.default_rng(3).normal(size=jout.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(cot))
    tout = tfn(torch.from_numpy(x))
    _close(tout.detach(), jout)
    (tout * torch.from_numpy(cot)).sum().backward()
    _grads_close(tmod, jg, "t")
    names = dict(tmod.named_parameters())
    if norm == "group":
        assert "bn1.weight" in names and "layer1_0.bn2.bias" in names
    else:
        assert not any("bn" in k for k in names)


# ---------------------------------------------------- resize_area, feature_scale


@pytest.mark.parametrize("hw,out", [((32, 32), (16, 16)), ((30, 40), (15, 20)),
                                    ((17, 23), (8, 11)), ((9, 9), (9, 9))])
def test_resize_area_matches_jax(hw, out):
    x = np.random.default_rng(4).normal(size=(2,) + hw + (3,)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: j_resize_area(a, out), jnp.asarray(x))
    cot = np.random.default_rng(5).normal(size=want.shape).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = resize_area(tx, out)
    _close(got.detach(), want, 1e-6)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad, vjp(jnp.asarray(cot))[0], 1e-6)


@pytest.mark.parametrize("scale", [0.5, 1.5])
def test_feature_scale_matches_jax(scale):
    kw = dict(backbone="resnet18", num_layers=3, feature_scale=scale)
    jmod = jenc.SpatialEncoder(**kw)
    x = np.random.default_rng(6).uniform(-1, 1, size=(2, 24, 32, 3)).astype(np.float32)
    variables = _randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 7)
    tmod = tenc.SpatialEncoder(**kw)
    _load(tmod, variables, "e")
    tmod.eval()
    jlevels, jscale = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        tlevels, tscale = tmod(torch.from_numpy(x))
    assert len(tlevels) == len(jlevels)
    stem = (int(round(24 * scale)) + 1) // 2
    assert tlevels[0].shape[1] == stem
    for t, j in zip(tlevels, jlevels):
        _close(t, j)
    _close(tscale, jscale, 1e-6)


# ---------------------------------------------------------- global encoder


@pytest.mark.parametrize("latent_size", [128, 512])
def test_image_encoder_matches_jax(latent_size):
    jmod = jenc.ImageEncoder(backbone="resnet18", latent_size=latent_size)
    x = np.random.default_rng(8).uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    variables = _randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 9)
    tmod = tenc.ImageEncoder(backbone="resnet18", latent_size=latent_size)
    _load(tmod, variables, "g")
    tmod.eval()
    assert (tmod.fc is None) == (latent_size == 512)
    _vjp_parity(jmod, variables, (jnp.asarray(x),), tmod, (torch.from_numpy(x),), "g", 10)


GLOBAL_CONF = """
model {
    use_encoder = True
    use_global_encoder = True
    use_xyz = True
    use_code = True
    code {
        num_freqs = 2
        freq_factor = 1.5
        include_input = True
    }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse {
        type = resnet
        n_blocks = 3
        d_hidden = 32
        combine_layer = 2
    }
    mlp_fine {
        type = resnet
        n_blocks = 3
        d_hidden = 32
        combine_layer = 2
    }
    encoder {
        backbone = resnet18
        num_layers = 3
    }
    global_encoder {
        backbone = resnet18
        latent_size = 24
    }
}
"""


def _look_at(eye):
    eye = np.asarray(eye, np.float64)
    back = eye / np.linalg.norm(eye)
    x = np.cross([0.0, 1.0, 0.0], back)
    x /= np.linalg.norm(x)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, np.cross(back, x), back, eye
    return pose.astype(np.float32)


def _model_pair(conf_text, seed, hw=32, dtype="float32"):
    jmodel = j_make_model(j_loads(conf_text)["model"], dtype=getattr(jnp, dtype), use_pallas=False)
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, size=(1, 2, hw, hw, 3)).astype(np.float32)
    poses = np.stack([_look_at([1.3, 0.2, 0.1]), _look_at([0.2, 0.3, 1.3])])[None]
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(poses), jnp.asarray(35.0),
        jnp.zeros((1, 8, 3)), viewdirs=jnp.zeros((1, 8, 3)))
    variables = _randomize(variables, seed + 1)
    model = make_model(loads(conf_text)["model"], dtype=getattr(torch, dtype), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, model))
    return jmodel, variables, model, images, poses


def _points(seed, r=5, k=4):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.4, 0.4, size=(1, r * k, 3)).astype(np.float32)
    vd = rng.normal(size=(1, r * k, 3)).astype(np.float32)
    return xyz, vd / np.linalg.norm(vd, axis=-1, keepdims=True)


def test_global_latent_in_query_and_cache_matches_jax():
    """encode computes the global latent; the coarse query prepends it to
    z (d_latent 256 + 24) and hands it to the cache; the fine query from
    the cache, forward and every parameter's gradient."""
    jmodel, variables, model, images, poses = _model_pair(GLOBAL_CONF, 11)
    assert model.mlp_coarse.d_latent == 256 + 24
    xyz, vd = _points(12)
    xyz_f, vd_f = _points(13, k=2)
    kc = 4

    def jrun(p):
        v = {**variables, "params": p}
        enc = jmodel.apply(v, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(35.0),
                           method=jmodel.encode)
        out_c, cache = jmodel.apply(v, enc, jnp.asarray(xyz), viewdirs=jnp.asarray(vd),
                                    coarse=True, want_cache=kc, method=jmodel.query)
        out_f = jmodel.apply(v, enc, jnp.asarray(xyz_f), viewdirs=jnp.asarray(vd_f),
                             coarse=False, cache=cache, method=jmodel.query)
        return out_c, out_f, cache.z

    (jc, jf, jz), vjp = jax.vjp(jrun, variables["params"])
    rng = np.random.default_rng(14)
    cots = [rng.normal(size=np.shape(a)).astype(np.float32) for a in (jc, jf)]
    (jg,) = vjp((jnp.asarray(cots[0]), jnp.asarray(cots[1]), jnp.zeros_like(jz)))

    enc = model.encode(torch.from_numpy(images), torch.from_numpy(poses), 35.0)
    assert enc.global_latent.shape == (2, 24)
    out_c, cache = model.query(enc, torch.from_numpy(xyz), torch.from_numpy(vd), True,
                               want_cache=kc)
    out_f = model.query(enc, torch.from_numpy(xyz_f), torch.from_numpy(vd_f), False, cache=cache)
    assert cache.z.shape == (2, 5, kc, 280)
    _close(cache.z.detach(), jz)
    _close(out_c.detach(), jc)
    _close(out_f.detach(), jf)
    loss = (out_c * torch.from_numpy(cots[0])).sum() + (out_f * torch.from_numpy(cots[1])).sum()
    loss.backward()
    want = params_from_jax(jax.device_get(jg))
    for k, p in model.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=GTOL * (np.abs(w).max() + 1e-6), err_msg=k)
    assert np.abs(want["global_encoder.fc.weight"].numpy()).max() > 0


def test_global_encoder_bf16_routes_to_the_kernels_without_dual_or_field():
    """A bf16 global-encoder model: the MLP takes the fused ResnetFC at
    d_latent 256 + 24 (the plain versions on the CPU), the lookup is
    single-output and the field path stays off, as in JAX."""
    _, _, model, images, poses = _model_pair(GLOBAL_CONF, 15, dtype="bfloat16")
    assert model.mlp_coarse.fused_ok((2, 20))
    fused = model.with_field_fusion()
    enc = fused.encode(torch.from_numpy(images), torch.from_numpy(poses), 35.0)
    assert not fused._field_fused_ok(enc, fused.mlp_coarse, 2)
    assert fused.supports_query_cache is False and model.supports_query_cache
    xyz, vd = _points(16)
    with torch.no_grad():
        out, cache = model.query(enc, torch.from_numpy(xyz), torch.from_numpy(vd), want_cache=4)
    assert torch.isfinite(out).all() and cache.z.dtype == torch.bfloat16


# ------------------------------------------------------------- ConvEncoder


@pytest.mark.parametrize("hw,train", [(64, False), (64, True), (128, False)])
def test_conv_encoder_matches_jax(hw, train):
    """SAME padding, group norm, leaky relu, the global code broadcast back,
    transposed convolutions cropped to the skips; at 128 the global code
    is 2x2 pixels (512 channels)."""
    jmod = jenc.SpatialEncoder(backbone="custom")
    x = np.random.default_rng(17).uniform(-1, 1, size=(2, hw, hw, 3)).astype(np.float32)
    variables = _randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 18)
    tmod = tenc.SpatialEncoder(backbone="custom")
    _load(tmod, variables, "e")
    tmod.train(train)
    assert tmod.latent_size == 128
    jfn = lambda p: jmod.apply({**variables, "params": p}, jnp.asarray(x), train=train)[0]
    jout, vjp = jax.vjp(jfn, variables["params"])
    cot = np.random.default_rng(19).normal(size=jout.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(cot))
    tout, tscale = tmod(torch.from_numpy(x))
    assert tout.shape == (2, hw, hw, 128)
    _close(tout.detach(), jout)
    _close(tscale, jenc.latent_scaling_for((hw, hw)), 1e-6)
    (tout * torch.from_numpy(cot)).sum().backward()
    _grads_close(tmod, jg, "e")


@pytest.mark.parametrize("hw,scale", [(128, 0.5), (48, 1.5)])
def test_conv_encoder_with_feature_scale_matches_jax(hw, scale):
    """The ConvEncoder runs on the input resized by `feature_scale`, and
    its global code is sized from that input (1x1 from 128 at 0.5, 2x2
    from 48 at 1.5), as Flax infers it at init. The reference is the JAX
    encoder evaluated in float64 on the same float32 values: at 128 and 0.5
    XLA's float32 CPU gradient of conv_in lies 2.9e-3 of its largest value
    from that, the port's float32 one 1.2e-6."""
    x = np.random.default_rng(22).uniform(-1, 1, size=(2, hw, hw, 3)).astype(np.float32)
    init = jenc.SpatialEncoder(backbone="custom", feature_scale=scale).init(
        jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _randomize(jax.device_get(init), 23)
    tmod = tenc.SpatialEncoder(backbone="custom", feature_scale=scale)
    _load(tmod, variables, "e")
    with jax.enable_x64(True):
        jmod = jenc.SpatialEncoder(backbone="custom", feature_scale=scale, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jfn = lambda p: jmod.apply({**v64, "params": p}, jnp.asarray(x, jnp.float64))
        (jout, jscale), vjp = jax.vjp(jfn, v64["params"])
        cot = np.random.default_rng(24).normal(size=jout.shape).astype(np.float32)
        (jg,) = vjp((jnp.asarray(cot, jnp.float64), jnp.zeros_like(jscale)))
        jout, jscale, jg = jax.device_get((jout, jscale, jg))
    tout, tscale = tmod(torch.from_numpy(x))
    assert tout.shape == jout.shape == (2, round(hw * scale), round(hw * scale), 128)
    _close(tout.detach(), jout)
    _close(tscale, jscale, 1e-6)
    (tout * torch.from_numpy(cot)).sum().backward()
    _grads_close(tmod, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jg), "e")


def test_conv_encoder_sizes_its_global_code_at_the_first_input():
    """Seeded and unbuilt, the global-code convolution is made at the first
    call from that input's width (a 512-channel code and 512 skip channels
    at 128x128), with the same values for the same seed."""
    made = []
    for _ in range(2):
        torch.manual_seed(3)
        tmod = tenc.SpatialEncoder(backbone="custom")
        assert torch.nn.parameter.is_lazy(tmod.model.deconv2.weight)
        tmod(torch.zeros((1, 128, 128, 3)))
        made.append(tmod.model.deconv2.weight.detach().clone())
    assert made[0].shape == (256, 512 + 512, 3, 3) and torch.equal(made[0], made[1])


def test_conv_encoder_refuses_another_image_size():
    tmod = tenc.SpatialEncoder(backbone="custom")
    tmod(torch.zeros((1, 64, 64, 3)))
    with pytest.raises(ValueError, match="global code"):
        tmod(torch.zeros((1, 128, 128, 3)))


CUSTOM_CONF = GLOBAL_CONF.replace("use_global_encoder = True", "use_global_encoder = False") \
    .replace("backbone = resnet18\n        num_layers = 3", "backbone = custom")


def test_custom_backbone_model_query_matches_jax():
    """The whole model on the ConvEncoder's single map: encode keeps it
    as one map, query looks it up (grid_sample_2d in float32)."""
    jmodel, variables, model, images, poses = _model_pair(CUSTOM_CONF, 20, hw=64)
    xyz, vd = _points(21)
    jenc_ = jmodel.apply(variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(35.0),
                         method=jmodel.encode)
    want = jmodel.apply(variables, jenc_, jnp.asarray(xyz), viewdirs=jnp.asarray(vd),
                        method=jmodel.query)
    enc = model.encode(torch.from_numpy(images), torch.from_numpy(poses), 35.0)
    assert torch.is_tensor(enc.latent) and enc.latent.shape == (2, 64, 64, 128)
    with torch.no_grad():
        got = model.query(enc, torch.from_numpy(xyz), torch.from_numpy(vd))
    _close(got, want)


# ------------------------------------------------------------ ImplicitNet


@pytest.mark.parametrize("beta,combine,excl", [(0.0, 1000, False), (2.0, 2, True)])
def test_implicit_net_matches_jax(beta, combine, excl):
    kw = dict(d_in=20, dims=(32, 32, 32), skip_in=(2,), d_out=4, beta=beta,
              combine_layer=combine, dim_excludes_skip=excl)
    jmod = JImplicitNet(**kw)
    rng = np.random.default_rng(22)
    z = rng.normal(size=(2 * 3 * 5, 12)).astype(np.float32)
    x = rng.normal(size=(2 * 3 * 5, 8)).astype(np.float32)
    dims = (3, 5) if combine < 1000 else (1,)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), (jnp.asarray(z), jnp.asarray(x)),
                                         dims))
    tmod = ImplicitNet(**kw)
    # the port's own init has the JAX init's shapes and its geometric layout
    for k, v in tmod.state_dict().items():
        assert tuple(v.shape) == tuple(state_dict_from_jax(_scoped(variables, "m"))["m." + k].shape)
    assert tmod.lin3.bias[0].item() == pytest.approx(0.3)
    assert (tmod.lin0.weight[:, 3:] == 0).all()
    _load(tmod, variables, "m")
    _vjp_parity(jmod, variables, ((jnp.asarray(z), jnp.asarray(x)), dims), tmod,
                ((torch.from_numpy(z), torch.from_numpy(x)), dims), "m", 23)


MLP_CONF = GLOBAL_CONF.replace("use_global_encoder = True", "use_global_encoder = False") \
    .replace("mlp_coarse {\n        type = resnet\n        n_blocks = 3\n        d_hidden = 32",
             "mlp_coarse {\n        type = mlp\n        dims = [32, 32, 32]\n        skip_in = [1]\n"
             "        dim_excludes_skip = true")


def test_mlp_type_model_query_matches_jax():
    jmodel, variables, model, images, poses = _model_pair(MLP_CONF, 24)
    assert isinstance(model.mlp_coarse, ImplicitNet) and isinstance(model.mlp_fine, ResnetFC)
    xyz, vd = _points(25)
    jenc_ = jmodel.apply(variables, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(35.0),
                         method=jmodel.encode)
    enc = model.encode(torch.from_numpy(images), torch.from_numpy(poses), 35.0)
    for coarse in (True, False):
        want = jmodel.apply(variables, jenc_, jnp.asarray(xyz), viewdirs=jnp.asarray(vd),
                            coarse=coarse, method=jmodel.query)
        with torch.no_grad():
            got = model.query(enc, torch.from_numpy(xyz), torch.from_numpy(vd), coarse)
        _close(got, want)


# -------------------------------------------------------- ResnetFC options


@pytest.mark.parametrize("beta,spade,d_in,combine", [
    (2.0, False, 10, 2), (0.0, True, 10, 2), (0.0, False, 0, 2), (1.5, True, 0, 1000),
])
def test_resnetfc_options_match_jax(beta, spade, d_in, combine):
    kw = dict(d_in=d_in, d_out=4, n_blocks=3, d_latent=12, d_hidden=16, beta=beta,
              combine_layer=combine, use_spade=spade)
    jmod = JResnetFC(**kw, use_pallas=False)
    rng = np.random.default_rng(26)
    z = rng.normal(size=(2 * 3 * 5, 12)).astype(np.float32)
    x = rng.normal(size=(2 * 3 * 5, d_in)).astype(np.float32)
    dims = (3, 5)
    jin = (jnp.asarray(z), jnp.asarray(x)) if d_in else jnp.asarray(z)
    variables = _randomize(jmod.init(jax.random.PRNGKey(0), jin, dims), 27)
    tmod = ResnetFC(**kw)
    _load(tmod, variables, "m")
    names = dict(tmod.named_parameters())
    assert ("scale_z_0.weight" in names) == spade and ("lin_in.weight" in names) == (d_in > 0)
    tin = (torch.from_numpy(z), torch.from_numpy(x)) if d_in else torch.from_numpy(z)
    _vjp_parity(jmod, variables, (jin, dims), tmod, (tin, dims), "m", 28)


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("use_l1", [False, True])
def test_uncertainty_and_background_losses_match_jax(use_l1):
    rng = np.random.default_rng(29)
    out, tgt = rng.uniform(size=(2, 50, 3)).astype(np.float32)
    betas = rng.uniform(0.2, 2.0, size=(50,)).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (out, tgt, betas)]
    for jfn, tfn in ((jlosses.rgb_with_uncertainty, tlosses.rgb_with_uncertainty),
                     (jlosses.rgb_with_background, tlosses.rgb_with_background)):
        want, vjp = jax.vjp(lambda a, b, c: jfn(a, b, c, use_l1=use_l1), *map(jnp.asarray,
                                                                              (out, tgt, betas)))
        got = tfn(*args, use_l1=use_l1)
        _close(got.detach(), want, 1e-6)
        for a in args:
            a.grad = None
        got.backward()
        for a, w in zip(args, vjp(jnp.ones(()))):
            _close(a.grad, w, 1e-6)
    conf = "use_uncertainty = True\nuse_l1 = %s" % ("true" if use_l1 else "false")
    fn = tlosses.rgb_loss_from_conf(loads(conf), coarse=False, allow_uncertainty=True)
    jfn = jlosses.rgb_loss_from_conf(j_loads(conf), coarse=False, allow_uncertainty=True)
    _close(fn(*[torch.from_numpy(a) for a in (out, tgt, betas)]), jfn(out, tgt, betas), 1e-6)
    with pytest.raises(tlosses.ConfigError):
        tlosses.rgb_loss_from_conf(loads(conf), coarse=False)
    assert tlosses.rgb_loss_from_conf(loads(conf), coarse=True) is (
        tlosses.l1_loss if use_l1 else tlosses.mse_loss)


# ----------------------------------------------------------------- routing


@pytest.mark.parametrize("beta,spade,combine_type,d_latent,d_in,combine", [
    (0.0, False, "average", 512, 42, 3), (2.0, False, "average", 512, 42, 3),
    (0.0, True, "average", 512, 42, 3), (0.0, False, "average", 512, 0, 3),
    (0.0, False, "max", 512, 42, 3), (0.0, False, "average", 640, 42, 3),
    (0.0, False, "average", 1024, 42, 3), (0.0, False, "average", 512, 42, 5),
])
def test_routing_mirrors_supported_config(beta, spade, combine_type, d_latent, d_in, combine):
    """A bf16 ResnetFC takes the kernels (fused_ok) and the field path
    (field_path_ok) exactly where JAX's `supported_config` lets its Pallas
    kernels run; on the CPU a float32 model keeps the per-layer chain under
    use_pallas "auto" (on the card it takes the kernels:
    tests/test_torch_float32_kernels.py)."""
    for dtype in (torch.bfloat16, torch.float32):
        m = ResnetFC(d_in=d_in, n_blocks=5, d_latent=d_latent, d_hidden=32, beta=beta,
                     combine_layer=combine, combine_type=combine_type, use_spade=spade,
                     dtype=dtype)
        for ns in (1, 2):
            want = j_supported(beta, spade, combine_type, d_latent, d_in, combine, 5, ns)
            assert m.fused_ok((ns, 8)) == (want and dtype == torch.bfloat16), (ns, dtype)
            assert m.field_path_ok(ns) == want, ns
