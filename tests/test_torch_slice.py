"""Port parity for the whole serving slice: encode -> render_full.

A narrow srn-shaped model (ResNet-34 encoder with 4 levels, 5-block
ResnetFC heads pooling 2 views at block 3, coarse + importance + depth
samples, white background) is built by the JAX `make_model`, given
random non-zero weights (fc_1 and BatchNorm statistics included), and
carried into the port by `convert.state_dict_from_jax`. Both encode the
same two 32x32 views and render the same target rays through their own
`render_full` with perturb=0, in chunks that need padding.

float32: tolerance 1e-4 absolute — the same math in two libraries, whose
float32 convolutions and products sum in different orders; the fine
samples depend smoothly on the coarse weights, so the fine pass inherits
no more than that.

bf16 (the flagship dtype, where the port takes its posenc and fused
field path, plain versions on the CPU): one query is held against the
JAX model's fused field path (Pallas kernel in interpret mode), at
5e-2 absolute and 1e-2 on average on sigmoid/relu outputs: each
library rounds ~30 bf16 convolutions differently before the field sees
the latent, on top of the field's own bf16 differences (test_torch_field).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.eval.common import encode_views as j_encode_views
from pixelnerf_tpu.eval.render_utils import render_full as j_render_full
from pixelnerf_tpu.models.pixelnerf import make_model as j_make_model
from pixelnerf_tpu.render.renderer import RendererConfig as JRendererConfig
from pixelnerf_tpu.utils.hocon import loads as j_loads
from pixelnerf_tpu.utils.rays import gen_rays as j_gen_rays
from pixelnerf_tpu_torch.convert import state_dict_from_jax
from pixelnerf_tpu_torch.eval.common import encode_views
from pixelnerf_tpu_torch.eval.render_utils import render_full
from pixelnerf_tpu_torch.models.pixelnerf import make_model
from pixelnerf_tpu_torch.render.renderer import RendererConfig
from pixelnerf_tpu_torch.utils.hocon import loads

CONF = """
model {
    use_encoder = True
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
        combine_type = average
    }
    mlp_fine {
        type = resnet
        n_blocks = 5
        d_hidden = 64
        combine_layer = 3
        combine_type = average
    }
    encoder {
        backbone = resnet34
        num_layers = 4
    }
}
renderer {
    n_coarse = 8
    n_fine = 6
    n_fine_depth = 2
    depth_std = 0.01
    white_bkgd = True
}
"""
H = W = 32
FOCAL = 35.0
NEAR, FAR = 0.8, 1.8


def _look_at(eye):
    eye = np.asarray(eye, np.float64)
    back = eye / np.linalg.norm(eye)  # camera +z points away from the origin
    x = np.cross([0.0, 1.0, 0.0], back)
    x /= np.linalg.norm(x)
    y = np.cross(back, x)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, y, back, eye
    return pose.astype(np.float32)


def _scene(seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, size=(2, H, W, 3)).astype(np.float32)
    poses = np.stack([_look_at([1.3, 0.2, 0.1]), _look_at([0.2, 0.3, 1.3])])
    target = _look_at([0.9, 0.4, 0.9])[None]
    return images, poses, target


def _random_variables(variables, seed):
    """Every leaf random (fc_1 included); BN variances positive."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k == "var":
                out[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
            elif k in ("mean", "bias"):
                out[k] = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
            elif k == "scale":
                out[k] = (1.0 + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
            else:  # kernels: kaiming-like over fan-in
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = rng.normal(scale=np.sqrt(1.0 / fan_in), size=v.shape).astype(np.float32)
        return out

    return {c: walk(variables[c]) for c in ("params", "batch_stats")}


def _build(dtype_name, seed=0):
    conf_j = j_loads(CONF)
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    images, poses, target = _scene(seed)
    jmodel = j_make_model(conf_j["model"], dtype=jdtype, use_pallas=False)
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(images[None]), jnp.asarray(poses[None]),
        jnp.asarray(FOCAL), jnp.zeros((1, 8, 3)), viewdirs=jnp.zeros((1, 8, 3)),
    )
    variables = _random_variables(jax.device_get(variables), seed + 1)
    conf_t = loads(CONF)
    model = make_model(conf_t["model"], dtype=getattr(torch, dtype_name), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, model))
    return conf_j, conf_t, jmodel, variables, model, images, poses, target


def test_render_full_matches_jax_f32():
    conf_j, conf_t, jmodel, variables, model, images, poses, target = _build("float32")
    jenc = j_encode_views(jmodel, variables, images, poses, FOCAL)
    rays = np.asarray(j_gen_rays(jnp.asarray(target), 8, 6, FOCAL * 8 / W, NEAR, FAR))
    rays = rays.reshape(-1, 8)  # 48 rays
    jr = JRendererConfig.from_conf(conf_j["renderer"]).replace(perturb=0.0)
    want = j_render_full(jmodel, variables, jenc, rays, jr, chunk=32)

    enc = encode_views(model, images, poses, FOCAL)
    rcfg = RendererConfig.from_conf(conf_t["renderer"]).replace(perturb=0.0)
    got = render_full(model, enc, rays, rcfg, chunk=32)
    assert set(got) == {"coarse", "fine"}
    for head in ("coarse", "fine"):
        for k in ("rgb", "depth", "alpha"):
            g = got[head][k].numpy()
            assert g.shape == want[head][k].shape
            np.testing.assert_allclose(g, want[head][k], rtol=0, atol=1e-4)
    # a real scene: not all background, not all opaque
    alpha = got["fine"]["alpha"].numpy()
    assert 0.01 < alpha.mean() < 0.99


def test_query_bf16_field_path_matches_jax_fused(monkeypatch):
    import pixelnerf_tpu.models.encoder as jencoder_mod

    conf_j, conf_t, _, variables, model, images, poses, _ = _build("bfloat16", seed=3)
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-0.4, 0.4, size=(1, 40, 3)).astype(np.float32)
    vd = rng.normal(size=(1, 40, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)

    monkeypatch.setattr(jencoder_mod, "pyramid_fused_ok", lambda *a, **k: True)
    jfused = j_make_model(conf_j["model"], dtype=jnp.bfloat16, use_pallas=True)
    jfused = jfused.clone(use_field_fusion=True)
    jenc = jfused.apply(
        variables, jnp.asarray(images[None]), jnp.asarray(poses[None]),
        jnp.asarray(FOCAL), method=jfused.encode,
    )
    fused = model.with_field_fusion()
    enc = fused.encode(torch.from_numpy(images[None]), torch.from_numpy(poses[None]), FOCAL)
    assert isinstance(enc.latent, tuple) and enc.latent[0].dtype == torch.bfloat16
    for coarse in (True, False):
        want = np.asarray(jfused.apply(
            variables, jenc, jnp.asarray(xyz), viewdirs=jnp.asarray(vd),
            coarse=coarse, method=jfused.query,
        ))
        with torch.no_grad():
            got = fused.query(enc, torch.from_numpy(xyz), torch.from_numpy(vd), coarse).numpy()
        assert got.shape == (1, 40, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
        assert np.abs(got - want).mean() < 1e-2
