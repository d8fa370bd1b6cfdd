"""Port parity for the training slice: ray sampling, train-mode BatchNorm,
the query-cache render, the losses, and one whole train step against JAX
`make_train_step`.

The whole step runs a tiny srn-shaped model (ResNet-18 encoder with 3
levels packed to 16x16x128 and 4x4x128, two 3-block 32-wide ResnetFC heads
pooling 2 views at block 2, 6 coarse + 4 importance + 2 depth samples,
white background) on 2 objects x 16 injected rays, with perturb=0 and
noise_std=0 so that no random draw differs. Both sides start from the same
random non-zero weights and BatchNorm statistics.

- float32: the JAX model takes its per-layer MLP and composed lookup
  (use_pallas=False), the port the same plain chain. Loss to 1e-5
  relative; each parameter gradient to a relative Frobenius error of 1e-3
  (float32 convolutions and products summed in other orders, through 30
  layers of the trunk's backward); running statistics to 1e-5.
- bf16: the JAX model runs its Pallas kernels in interpret mode (the
  fused ResnetFC, and the native-pyramid gather/scatter made reachable on
  the CPU), the port the plain versions of its kernels. Loss to 2e-2
  relative; each gradient of the heads to a relative Frobenius error of
  5e-2 and of the encoder to 1e-1 (bf16 operands rounded at other places
  in two libraries' convolutions, and the interpret-mode scatter rounds
  its products to bf16, test_torch_pyramid); running statistics to 1e-2
  relative to their scale.
- Adam's first step moves each parameter by lr * g / (|g| + eps): the
  parameters after the step differ by no more than lr times the
  difference of that ratio between the two gradients, plus 1e-6 (float32
  rounding of parameters of O(1)), so the update itself adds nothing to
  the gradients' difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelnerf_tpu.models import losses as jlosses
from pixelnerf_tpu.models.pixelnerf import make_model as j_make_model
from pixelnerf_tpu.render.renderer import RendererConfig as JRendererConfig
from pixelnerf_tpu.train.step import create_train_state, make_train_step as j_make_train_step
from pixelnerf_tpu.train.step import sample_rays as j_sample_rays
from pixelnerf_tpu.utils.hocon import loads as j_loads
from pixelnerf_tpu_torch.convert import params_from_jax, state_dict_from_jax
from pixelnerf_tpu_torch.models import losses
from pixelnerf_tpu_torch.models.pixelnerf import make_model
from pixelnerf_tpu_torch.models.resnet import BatchNorm
from pixelnerf_tpu_torch.render.renderer import RendererConfig, render_rays
from pixelnerf_tpu_torch.train.step import (
    make_eval_step, make_optimizer, make_train_step, sample_rays,
)
from pixelnerf_tpu_torch.utils.hocon import loads
from tests.test_torch_slice import _look_at, _random_variables

CONF = """
model {
    use_encoder = True
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
}
renderer {
    n_coarse = 6
    n_fine = 6
    n_fine_depth = 2
    depth_std = 0.05
    white_bkgd = True
    perturb = 0.0
}
"""
SB, NV, NS, H, W, R = 2, 3, 2, 32, 32, 16
FOCAL, NEAR, FAR, LR = 35.0, 0.8, 1.8, 1e-3


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, size=(SB, NV, H, W, 3)).astype(np.float32)
    eyes = [[1.3, 0.2, 0.1], [0.2, 0.3, 1.3], [0.9, 0.4, 0.9]]
    poses = np.stack([np.stack([_look_at(e) for e in eyes])] * SB)
    focal = np.full((SB, 2), FOCAL, np.float32)
    c = np.full((SB, 2), W / 2.0, np.float32)
    # the target rays: pixels of the third view near its centre
    ys, xs = rng.integers(8, 24, size=(2, SB, R))
    pix = 2 * H * W + ys * W + xs
    rays, rgb_gt = sample_rays(
        torch.from_numpy(images), torch.from_numpy(poses), torch.from_numpy(focal),
        torch.from_numpy(c), NEAR, FAR, R, draws={"pix": torch.from_numpy(pix)},
    )
    return dict(
        images=images, poses=poses, focal=focal, c=c, src_images=images[:, :NS],
        src_poses=poses[:, :NS], rays=rays.numpy(), rgb_gt=rgb_gt.numpy(),
    )


# ---------------------------------------------------------------- sampling


@pytest.mark.parametrize("mode", ["uniform", "bbox", "z_bounds"])
def test_sample_rays_matches_jax_with_injected_draws(mode):
    b = _batch(1)
    key = jax.random.PRNGKey(7)
    rng = np.random.default_rng(2)
    bbox = rng.integers(0, 12, size=(SB, NV, 2)).astype(np.float32)
    bbox = np.concatenate([bbox, bbox + rng.integers(3, 18, size=(SB, NV, 2))], -1)
    z_bounds = np.array([[0.7, 1.9], [0.9, 1.6]], np.float32)
    kw = {"bbox": bbox} if mode == "bbox" else {}
    if mode == "z_bounds":
        kw["lindisp_bounds"] = z_bounds
    want_rays, want_rgb = j_sample_rays(
        key, jnp.asarray(b["images"]), jnp.asarray(b["poses"]), jnp.asarray(b["focal"]),
        jnp.asarray(b["c"]), NEAR, FAR, 64, **{k: jnp.asarray(v) for k, v in kw.items()},
    )
    # the JAX sampler's own draws, handed to the port
    k_view, k_x, k_y = jax.random.split(key, 3)
    if mode == "bbox":
        draws = {
            "vid": jax.random.randint(k_view, (SB, 64), 0, NV),
            "ux": jax.random.uniform(k_x, (SB, 64)), "uy": jax.random.uniform(k_y, (SB, 64)),
        }
    else:
        draws = {"pix": jax.random.randint(k_view, (SB, 64), 0, NV * H * W)}
    got_rays, got_rgb = sample_rays(
        torch.from_numpy(b["images"]), torch.from_numpy(b["poses"]),
        torch.from_numpy(b["focal"]), torch.from_numpy(b["c"]), NEAR, FAR, 64,
        **{k: torch.from_numpy(v) for k, v in kw.items()},
        draws={k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()},
    )
    assert got_rays.shape == (SB, 64, 8) and got_rgb.shape == (SB, 64, 3)
    np.testing.assert_allclose(got_rays.numpy(), np.asarray(want_rays), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_rgb.numpy(), np.asarray(want_rgb), rtol=0, atol=1e-6)


def test_prepare_batch_matches_jax():
    """A compact batch (uint8 images, source views by index) expands as in
    JAX: images to [-1, 1], the source views and poses gathered."""
    from pixelnerf_tpu.train.step import _prepare_batch as j_prepare
    from pixelnerf_tpu_torch.train.step import _prepare_batch

    rng = np.random.default_rng(9)
    b = _batch(2)
    u8 = rng.integers(0, 256, size=(SB, NV, H, W, 3)).astype(np.uint8)
    order = np.array([[2, 0], [1, 2]], np.int32)
    want = j_prepare({"images_u8": jnp.asarray(u8), "image_ord": jnp.asarray(order),
                      "poses": jnp.asarray(b["poses"])})
    got = _prepare_batch({"images_u8": torch.from_numpy(u8), "image_ord": torch.from_numpy(order),
                          "poses": torch.from_numpy(b["poses"])})
    assert set(got) == set(want) == {"images", "src_images", "src_poses", "poses"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)
    plain = {"images": torch.zeros(1)}
    assert _prepare_batch(plain) is plain


def test_sample_rays_draws_from_the_generator():
    b = _batch(1)
    args = [torch.from_numpy(b[k]) for k in ("images", "poses", "focal", "c")]
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    r1, _ = sample_rays(*args, NEAR, FAR, 32, generator=g1)
    r2, _ = sample_rays(*args, NEAR, FAR, 32, generator=g2)
    assert torch.equal(r1, r2)


# ------------------------------------------------------- train-mode BatchNorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    """Output, input and affine gradients, and the running statistics after
    one step (Flax momentum 0.9 on the old value, biased variance)."""
    import flax.linen as nn

    rng = np.random.default_rng(4)
    x = (rng.normal(size=(6, 5, 7, 8)) * 2 + 0.5).astype(np.float32)  # NHWC
    g = rng.normal(size=x.shape).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=8)).astype(np.float32)
    bias = (0.1 * rng.normal(size=8)).astype(np.float32)
    rmean = rng.normal(size=8).astype(np.float32)
    rvar = rng.uniform(0.5, 1.5, size=8).astype(np.float32)
    jdt = getattr(jnp, dtype)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(rmean), "var": jnp.asarray(rvar)}}

    def f(params, xx):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * g), (y, upd)

    xj = jnp.asarray(x, jdt)
    (_, (jy, jupd)), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], xj
    )

    tbn = BatchNorm(8).train()
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(rmean))
        tbn.running_var.copy_(torch.from_numpy(rvar))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2).requires_grad_(True)
    ty = tbn(tx)
    (ty.float() * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    assert ty.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        ty.detach().float().permute(0, 2, 3, 1).numpy(), np.asarray(jy, np.float32),
        rtol=tol, atol=tol,
    )
    np.testing.assert_allclose(
        tx.grad.float().permute(0, 2, 3, 1).numpy(), np.asarray(jgx, np.float32),
        rtol=tol, atol=tol,
    )
    np.testing.assert_allclose(tbn.weight.grad.numpy(), np.asarray(jgp["scale"]), rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(tbn.bias.grad.numpy(), np.asarray(jgp["bias"]), rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(jupd["batch_stats"]["mean"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(jupd["batch_stats"]["var"]), rtol=1e-5, atol=1e-5)
    # eval mode leaves the statistics alone
    before = tbn.running_mean.clone()
    tbn.eval()(tx.detach())
    assert torch.equal(tbn.running_mean, before)


# ------------------------------------------------------------------ losses


def test_losses_match_jax():
    from pixelnerf_tpu.utils.hocon import ConfigTree as JConfigTree
    from pixelnerf_tpu_torch.utils.hocon import ConfigTree

    rng = np.random.default_rng(5)
    p, t = rng.uniform(size=(2, 40, 3)).astype(np.float32)
    alpha = rng.uniform(size=(2, 40)).astype(np.float32)
    for fn, jfn in ((losses.mse_loss, jlosses.mse_loss), (losses.l1_loss, jlosses.l1_loss)):
        np.testing.assert_allclose(
            fn(torch.from_numpy(p), torch.from_numpy(t)).item(),
            float(jfn(jnp.asarray(p), jnp.asarray(t))), rtol=1e-6,
        )
    for force in (False, True):
        got = losses.alpha_loss_nv2(torch.from_numpy(alpha), 0.3, 2.0, 5, 3, force_opaque=force)
        want = jlosses.alpha_loss_nv2(jnp.asarray(alpha), 0.3, 2.0, 5, 3, force_opaque=force)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert losses.alpha_loss_nv2(torch.from_numpy(alpha), 0.3, 2.0, 2, 3).item() == 0.0
    conf = {"lambda_alpha": 0.5, "clamp_alpha": 3.0, "init_epoch": 1}
    fn, init = losses.alpha_loss_from_conf(ConfigTree(conf))
    jfn, jinit = jlosses.alpha_loss_from_conf(JConfigTree(conf))
    assert init == jinit == 1
    np.testing.assert_allclose(fn(torch.from_numpy(alpha), 2).item(), float(jfn(jnp.asarray(alpha), 2)), rtol=1e-6)
    assert losses.alpha_loss_from_conf(None) == (None, 0)
    assert losses.rgb_loss_from_conf(ConfigTree({"use_l1": True})) is losses.l1_loss
    assert losses.rgb_loss_from_conf(ConfigTree({})) is losses.mse_loss
    with pytest.raises(losses.ConfigError):
        losses.rgb_loss_from_conf(ConfigTree({"use_uncertainty": True}), coarse=False)


# ------------------------------------------------------ models and the step


def _models(dtype_name, seed=0, conf=CONF):
    conf_j, conf_t = j_loads(conf), loads(conf)
    b = _batch()
    jdtype = getattr(jnp, dtype_name)
    jmodel = j_make_model(conf_j["model"], dtype=jdtype, use_pallas=dtype_name == "bfloat16")
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(b["src_images"]), jnp.asarray(b["src_poses"]),
        jnp.asarray(b["focal"]), jnp.zeros((SB, 8, 3)), viewdirs=jnp.zeros((SB, 8, 3)),
    )
    variables = _random_variables(jax.device_get(variables), seed + 1)
    for head in ("mlp_coarse", "mlp_fine"):  # outputs of O(1), sigma mostly on
        lin = variables["params"][head]["lin_out"]
        lin["kernel"] = lin["kernel"] * 0.3
        lin["bias"][3] = 1.0
    model = make_model(conf_t["model"], dtype=getattr(torch, dtype_name), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, model))
    return conf_j, conf_t, jmodel, variables, model, b


def _render_port(model, b, rcfg, query_cache):
    enc = model.encode(torch.from_numpy(b["src_images"]), torch.from_numpy(b["src_poses"]),
                       torch.from_numpy(b["focal"]))

    def qf(xyz, vd, coarse, want_cache=0, cache=None):
        return model.query(enc, xyz, vd, coarse, want_cache, cache)

    return render_rays(qf, torch.from_numpy(b["rays"]), rcfg, want_weights=True,
                       use_viewdirs=True, train=True, query_cache=query_cache)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_query_cache_render_matches_plain_render(dtype_name):
    """The dedup path (cached coarse inputs, dual lookup, sorted outputs)
    reproduces the plain path's outputs and parameter gradients. float32:
    1e-5 and 1e-4 relative; bf16, where the plain path rounds the two
    lookups' cotangents apart and the dual one their sum: 1e-5 on the
    outputs and 2e-2 relative on the gradients."""
    _, conf_t, _, _, model, b = _models(dtype_name)
    model.train()
    rcfg = RendererConfig.from_conf(conf_t["renderer"])
    grads = []
    outs = []
    for qc in (False, True):
        model.zero_grad(set_to_none=True)
        out = _render_port(model, b, rcfg, qc)
        (out["coarse"]["rgb"].sum() + out["fine"]["rgb"].sum() + out["fine"]["depth"].sum()).backward()
        outs.append(out)
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for head in ("coarse", "fine"):
        for k in ("rgb", "depth", "weights"):
            torch.testing.assert_close(outs[1][head][k], outs[0][head][k], rtol=1e-5, atol=1e-5)
    gtol = 1e-4 if dtype_name == "float32" else 2e-2
    for n, g in grads[0].items():
        assert (grads[1][n] - g).norm() <= gtol * g.norm() + 1e-12, n
    assert grads[0]["encoder.model.conv1.weight"].norm() > 0


def test_stop_encoder_grad_detaches_the_latent():
    """stop_encoder_grad: the heads train, the encoder gets no gradient,
    on the cached (dual) lookup too."""
    conf_t, b = loads(CONF), _batch()
    model = make_model(conf_t["model"], dtype=torch.bfloat16, device="cpu", train=True,
                       stop_encoder_grad=True)
    out = _render_port(model, b, RendererConfig.from_conf(conf_t["renderer"]), True)
    (out["coarse"]["rgb"].sum() + out["fine"]["rgb"].sum()).backward()
    assert all(p.grad is None for p in model.encoder.parameters())
    assert model.mlp_coarse.lin_in.weight.grad.norm() > 0
    assert model.mlp_fine.lin_in.weight.grad.norm() > 0


def _jax_step(jmodel, variables, b, rcfg_j):
    captured = {}

    def capture(updates, state, params=None):
        captured["grads"] = updates
        return updates, state

    tx = optax.chain(
        optax.GradientTransformation(lambda p: optax.EmptyState(), capture), optax.adam(LR)
    )
    step = j_make_train_step(jmodel, rcfg_j, tx, R, NEAR, FAR)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    state, aux = step(create_train_state(variables, tx), batch, jax.random.PRNGKey(0))
    return jax.device_get(state), jax.device_get(aux), jax.device_get(captured["grads"])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_train_step_matches_jax(dtype_name, monkeypatch):
    conf_j, conf_t, jmodel, variables, model, b = _models(dtype_name)
    if dtype_name == "bfloat16":
        # the JAX package takes its native-pyramid kernels only on a TPU;
        # run them here in interpret mode, as its own tests run Pallas
        import pixelnerf_tpu.models.encoder as jenc
        import pixelnerf_tpu.ops.pyramid_pallas as jpyr

        monkeypatch.setattr(jenc, "pyramid_fused_ok", lambda *a, **k: True)
        single, dual = jpyr.pyramid_index_train, jpyr.pyramid_index_train_dual
        monkeypatch.setattr(jpyr, "pyramid_index_train", lambda f, uv: single(f, uv, True))
        monkeypatch.setattr(jpyr, "pyramid_index_train_dual", lambda f, uv: dual(f, uv, True))
    rcfg_j = JRendererConfig.from_conf(conf_j["renderer"])
    jstate, jaux, jgrads = _jax_step(jmodel, variables, b, rcfg_j)
    _assert_step_matches(dtype_name, model, model, conf_t, variables, b, jstate, jaux, jgrads)


def _assert_step_matches(dtype_name, model, stepped, conf_t, variables, b, jstate, jaux, jgrads):
    """One port train step of `stepped` (`model`, or a view of it sharing
    its parameters) with an optimizer over `model`'s parameters, held
    against the JAX step's loss, gradients, parameters after Adam and
    running statistics."""
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    optimizer = make_optimizer(model, LR)
    step = make_train_step(stepped, RendererConfig.from_conf(conf_t["renderer"]), optimizer, R, NEAR, FAR)
    aux = step({k: torch.from_numpy(v) for k, v in b.items()})
    assert stepped.training

    ltol = 1e-5 if dtype_name == "float32" else 2e-2
    for k in ("rc", "rf", "t"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=ltol)
    assert 0.01 < aux["t"].item() < 1.0

    want = params_from_jax(jgrads, model)
    for n, p in model.named_parameters():
        g = p.grad
        gtol = 1e-3 if dtype_name == "float32" else (1e-1 if n.startswith("encoder") else 5e-2)
        assert g is not None and g.norm() > 0, n
        assert (g - want[n]).norm() <= gtol * want[n].norm(), (n, ((g - want[n]).norm() / want[n].norm()).item())

    new = params_from_jax(jstate.params, model)
    unit = lambda g: g / (g.abs() + 1e-8)  # Adam's first update over lr
    for n, p in model.named_parameters():
        explained = LR * (unit(p.grad) - unit(want[n])).abs() + 1e-6
        assert ((p.detach() - new[n]).abs() <= explained).all(), n
        assert ((p.detach() - before[n]).abs() <= LR + 1e-6).all(), n
    sd = state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    stol = 1e-5 if dtype_name == "float32" else 1e-2
    for n, buf in model.named_buffers():
        scale = sd[n].abs().max().item()
        np.testing.assert_allclose(buf.numpy(), sd[n].numpy(), rtol=0, atol=stol * max(scale, 1.0))
        assert not torch.equal(buf, state_dict_from_jax(variables)[n]), n  # the step moved it


def test_eval_step_runs_the_stash_free_forward(monkeypatch):
    """The eval step: eval-mode BatchNorm (no statistics move), no
    gradient, and the stash-free ResnetFC forward for its three MLP calls
    (coarse, then the fine pass's cached and new rows)."""
    import pixelnerf_tpu_torch.ops.resnetfc as ops_resnetfc

    _, conf_t, _, _, model, b = _models("bfloat16")
    calls = []
    for name in ("resnetfc_fwd", "resnetfc_fwd_stash"):
        orig = getattr(ops_resnetfc, name)
        monkeypatch.setattr(ops_resnetfc, name, lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))
    model.train()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rcfg = RendererConfig.from_conf(conf_t["renderer"])
    aux = make_eval_step(model, rcfg, R, NEAR, FAR)({k: torch.from_numpy(v) for k, v in b.items()})
    assert calls == ["resnetfc_fwd"] * 3
    assert not model.training and set(aux) == {"rc", "rf", "t"}
    assert all(torch.isfinite(v) for v in aux.values())
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in sd.items())


# --------------------------------------------------- the fused field's VJP


def test_fused_field_refuses_to_drop_gradients(monkeypatch):
    """A train-mode query through the fused field (`with_field_fusion`)
    computes every gradient: its outputs and the gradients of every
    parameter, the encoder's included, equal the unfused query's (the
    pyramid lookup + ResnetFC kernels' plain versions) bit for bit, and the
    field path was taken."""
    import pixelnerf_tpu_torch.ops.field as ops_field

    _, _, _, _, model, b = _models("bfloat16")
    fused = model.with_field_fusion()
    xyz = torch.from_numpy(b["rays"][:, :5, :3] + 1.2 * b["rays"][:, :5, 3:6])
    vd = torch.from_numpy(b["rays"][:, :5, 3:6])
    images, poses = torch.from_numpy(b["src_images"]), torch.from_numpy(b["src_poses"])
    calls = []
    for name in ("pyramid_field_fused_fwd_stash", "pyramid_field_fused_bwd"):
        orig = getattr(ops_field, name)
        monkeypatch.setattr(ops_field, name, lambda *a, _o=orig, _n=name: calls.append(_n) or _o(*a))
    results = []
    for m in (fused, model):
        m.train()
        m.zero_grad(set_to_none=True)
        calls.clear()
        enc = m.encode(images, poses, torch.from_numpy(b["focal"]))
        out = m.query(enc, xyz, vd, coarse=False)
        torch.sin(out).sum().backward()
        want = ["pyramid_field_fused_fwd_stash", "pyramid_field_fused_bwd"] if m is fused else []
        assert calls == want
        results.append((out.detach(), {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}))
    (out_f, grads_f), (out_u, grads_u) = results
    assert torch.equal(out_f, out_u)
    assert set(grads_f) == set(grads_u) and "encoder.model.conv1.weight" in grads_f
    assert "mlp_fine.lin_z_0.weight" in grads_f and grads_f["mlp_fine.lin_in.weight"].norm() > 0
    for n, g in grads_u.items():
        assert torch.equal(grads_f[n], g), n
