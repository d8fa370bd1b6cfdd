"""Float32 models through the ResnetFC kernels, against the JAX package.

The JAX package runs its ResnetFC Pallas kernels on float32 models too:
`ResnetFC._pallas_ok` has no dtype test, the kernels cast each operand to
bf16 at the product, and their backward writes dz and dxin in the input's
dtype, so a float32 model gets unrounded float32 input gradients. The
port's `use_pallas` gives the same routes: on the card a float32 model
takes the kernels under "auto"; `use_pallas=True` takes their plain
versions on the CPU, the counterpart of the JAX interpret mode, which is
what these tests hold against the JAX package's `use_pallas=True`.

- `resnetfc_fused` on float32 z and xin (hidden 64, 5 blocks pooling at
  block 3, NS 1 and 2) against the Pallas kernel in interpret mode on the
  same float32 inputs. Tolerances, as tests/test_torch_resnetfc.py's bf16
  case derives them (bf16 operands summed in float32 in other orders): the
  output 2e-2 absolute plus 2e-2 relative; every gradient 2e-2 of its
  largest magnitude and 1e-2 relative Frobenius. dz and dxin come back
  float32 on both sides, so they take no extra bf16 ulp.
- The routes on every shipped config: the port's card route
  (`ResnetFC.fused_ok(dims, "cuda")`) and its remat rule on the card equal
  the JAX `_pallas_ok` and `_model_uses_fused_mlp` under `use_pallas=True`
  (the routing a TPU gives them) at views None, 1, 2 and 3.
- `make_model(use_pallas=...)`: True, False and "auto" give the JAX
  package's routes (the MLP, the lookup, posenc and the field), on the
  card as JAX on its TPU and, for float32, on the CPU as JAX off it; False
  runs no kernel and no plain version of one.
- One float32 train step of pollen.conf cut to ResNet-18 and 32-wide heads
  (the opacity loss on) with `use_pallas=True` on both sides, against JAX
  `make_train_step` on the same weights and injected rays. The two sides
  differ where the kernels' bf16 operands round apart (other orders of
  float32 sums): the losses to 1e-3 relative and every parameter's
  gradient to 2e-2 relative Frobenius (5.3e-3 at most when written), inside
  the bf16 step's 2e-2 and 5e-2 (heads) and 1e-1 (encoder)
  (tests/test_torch_train.py), whose trunk is bf16 too.
"""

import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.models.pixelnerf import make_model as j_make_model
from pixelnerf_tpu.ops.resnetfc_pallas import ResnetFCWeights
from pixelnerf_tpu.ops.resnetfc_pallas import resnetfc_fused as j_fused
from pixelnerf_tpu.render.renderer import RendererConfig as JRendererConfig
from pixelnerf_tpu.train.step import _model_uses_fused_mlp as j_uses_fused
from pixelnerf_tpu.utils.hocon import load as j_load
from pixelnerf_tpu.utils.hocon import loads as j_loads
from pixelnerf_tpu_torch.convert import params_from_jax, state_dict_from_jax
from pixelnerf_tpu_torch.models.pixelnerf import make_model
from pixelnerf_tpu_torch.ops import resnetfc as ops_resnetfc
from pixelnerf_tpu_torch.ops.field import FieldWeights
from pixelnerf_tpu_torch.ops.resnetfc import resnetfc_fused
from pixelnerf_tpu_torch.render.renderer import RendererConfig
from pixelnerf_tpu_torch.train.step import _model_uses_fused_mlp, make_optimizer, make_train_step
from pixelnerf_tpu_torch.utils.hocon import load, loads
from tests.test_torch_train import CONF, FAR, NEAR, R, SB, _batch
from tests.test_torch_slice import _random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = sorted(glob.glob(os.path.join(ROOT, "conf", "exp", "*.conf"))) + [
    os.path.join(ROOT, "conf", "default.conf"), os.path.join(ROOT, "conf", "default_mv.conf")]
D_IN, D_LATENT, HIDDEN, D_OUT, N_BLOCKS, COMBINE = 42, 64, 64, 4, 5, 3


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads a test: the suite runs six workers on the CPU's
    cores, and more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grad_close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.all(np.abs(got - want) <= 2e-2 * (np.abs(want).max() + 1e-12))
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want) + 1e-12


# ------------------------------------------------- the kernel, float32 in and out


@pytest.mark.parametrize("ns,sb,b", [(1, 2, 24), (2, 1, 20)])
def test_float32_inputs_match_pallas(ns, sb, b):
    rng = np.random.default_rng(ns * 10 + b)

    def m(shape, fan_in):
        return rng.normal(size=shape, scale=1.0 / np.sqrt(fan_in)).astype(np.float32)

    n_inj = COMBINE
    w = dict(
        w_in=m((D_IN, HIDDEN), D_IN), b_in=m((HIDDEN,), 10),
        wz=m((n_inj, D_LATENT, HIDDEN), D_LATENT), bz=m((n_inj, HIDDEN), 10),
        w0=m((N_BLOCKS, HIDDEN, HIDDEN), HIDDEN), b0=m((N_BLOCKS, HIDDEN), 10),
        w1=m((N_BLOCKS, HIDDEN, HIDDEN), HIDDEN), b1=m((N_BLOCKS, HIDDEN), 10),
        w_out=m((HIDDEN, D_OUT), HIDDEN), b_out=m((D_OUT,), 10),
    )
    z = rng.normal(size=(sb, ns, b, D_LATENT)).astype(np.float32)
    xin = rng.normal(size=(sb, ns, b, D_IN)).astype(np.float32)
    g = rng.normal(size=(sb, b, D_OUT)).astype(np.float32)

    jw = ResnetFCWeights(
        **{k: jnp.asarray(v[None] if k in ("b_in", "b_out") else v) for k, v in w.items()}
    )
    jfn = lambda zz, xx, ww: j_fused(zz, xx, ww, N_BLOCKS, COMBINE, ns, True)
    jout, vjp = jax.vjp(jfn, jnp.asarray(z), jnp.asarray(xin), jw)
    jdz, jdx, jdw = vjp(jnp.asarray(g))
    assert jdz.dtype == jdx.dtype == jnp.float32

    tz = torch.from_numpy(z).requires_grad_(True)
    tx = torch.from_numpy(xin).requires_grad_(True)
    tw = FieldWeights(**{k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()})
    out = resnetfc_fused(tz, tx, tw, N_BLOCKS, COMBINE, ns)
    out.backward(torch.from_numpy(g))

    want = np.asarray(jout)
    assert out.shape == (sb, b, D_OUT) and out.dtype == torch.float32
    assert np.abs(want).mean() > 0.3  # the chain is not trivial
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-2, atol=2e-2)
    for t, jt in ((tz.grad, jdz), (tx.grad, jdx)):
        assert t.dtype == torch.float32
        # unrounded: most entries lie between two bf16 values
        assert (t != t.to(torch.bfloat16).float()).float().mean() > 0.9
        _grad_close(t, jt)
    for name in FieldWeights._fields:
        got = getattr(tw, name).grad
        _grad_close(got, np.asarray(getattr(jdw, name)).reshape(got.shape))


def test_float32_inputs_save_bf16_copies(monkeypatch):
    """The forward saves one bf16 copy of each float32 input (what the
    kernels read) and hands the backward the dtype to write: the stash
    forward and the backward see bf16 z and xin, the backward's float32
    dz and dxin are the plain version's for those copies."""
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.normal(size=(1, 2, 5, D_LATENT)).astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.normal(size=(1, 2, 5, D_IN)).astype(np.float32)).requires_grad_(True)
    w = FieldWeights(*[torch.from_numpy(rng.normal(size=s, scale=0.2).astype(np.float32)) for s in (
        (D_IN, HIDDEN), (HIDDEN,), (COMBINE, D_LATENT, HIDDEN), (COMBINE, HIDDEN),
        (N_BLOCKS, HIDDEN, HIDDEN), (N_BLOCKS, HIDDEN), (N_BLOCKS, HIDDEN, HIDDEN),
        (N_BLOCKS, HIDDEN), (HIDDEN, D_OUT), (D_OUT,))])
    seen = []
    real = ops_resnetfc.resnetfc_bwd

    def bwd(zz, xx, *a, **k):
        seen.append((zz.dtype, xx.dtype, k.get("grad_dtype")))
        return real(zz, xx, *a, **k)

    monkeypatch.setattr(ops_resnetfc, "resnetfc_bwd", bwd)
    out = resnetfc_fused(z, x, w, N_BLOCKS, COMBINE, 2)
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    out.backward(g)
    assert seen == [(torch.bfloat16, torch.bfloat16, torch.float32)]
    zb, xb = z.detach().to(torch.bfloat16), x.detach().to(torch.bfloat16)
    _, spre, spost = ops_resnetfc.resnetfc_fwd_stash(zb, xb, w, N_BLOCKS, COMBINE, 2)
    dz, dxin, _ = ops_resnetfc.resnetfc_bwd_plain(zb, xb, g, spre, spost, w, N_BLOCKS, COMBINE, 2,
                                                  torch.float32)
    assert torch.equal(z.grad, dz) and torch.equal(x.grad, dxin)
    with pytest.raises(TypeError):
        resnetfc_fused(z.double(), x, w, N_BLOCKS, COMBINE, 2)


# ------------------------------------------------------------------ the routes


@pytest.mark.parametrize("path", CONFS, ids=os.path.basename)
def test_card_route_matches_jax_on_its_tpu(path):
    """The port's route on the card and its remat rule there against the
    JAX module's `_pallas_ok` and step's `_model_uses_fused_mlp` under
    use_pallas=True, the routing a TPU gives "auto"; float32 and bf16 alike.
    The heads alone: neither predicate reads the encoder."""
    jmodel = j_make_model(j_load(path)["model"], use_pallas=True)
    conf = load(path)["model"]
    dtype = getattr(torch, conf.get_string("dtype", "float32"))
    from pixelnerf_tpu_torch.models.pixelnerf import _make_mlp

    heads = {name: _make_mlp(conf.get_config(name), jmodel.d_in, jmodel.d_latent, 4, dtype,
                             allow_empty=name == "mlp_fine")
             for name in ("mlp_coarse", "mlp_fine")}
    model = types.SimpleNamespace(**heads)
    for nviews in (None, 1, 2, 3):
        for name, m in heads.items():
            jm = getattr(jmodel, name)
            if m is None or not hasattr(m, "fused_ok"):
                assert jm is None or not hasattr(jm, "_pallas_ok")
                continue
            want = jm._pallas_ok(jnp.zeros((1, 1)), (nviews, 1))
            assert m.fused_ok((nviews, 1), "cuda") == want, (name, nviews)
        assert _model_uses_fused_mlp(model, nviews, "cuda") == j_uses_fused(jmodel, nviews), nviews
    name = os.path.basename(path)
    if name in ("sn64.conf", "sn64_unseen.conf", "pollen.conf", "multi_obj.conf"):
        assert dtype == torch.float32
        assert _model_uses_fused_mlp(model, 2, "cuda")  # the stash, no remat, on the card
        assert not _model_uses_fused_mlp(model, 2, "cpu")  # the exact chain and remat off it


TINY = CONF.replace("num_layers = 3", "num_layers = 3\n        upsample_interp = bilinear")


def _routes(model, ns, device_type):
    return dict(
        mlp=model.mlp_coarse.fused_ok((ns, 8), device_type),
        gather=model.use_fused_gather,
        posenc=model._posenc_fused_ok(),
        field=model.mlp_coarse.field_path_ok(ns),
    )


def _jax_routes(jmodel, ns, backend, monkeypatch):
    """The JAX model's routes with `jax.default_backend` answering
    `backend` (the predicates read only the modules' fields)."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    return dict(
        mlp=jmodel.mlp_coarse._pallas_ok(jnp.zeros((1, 1)), (ns, 8)),
        gather=jmodel.use_fused_gather,
        posenc=jmodel._posenc_fused_ok(),
        field=jmodel.mlp_coarse.field_path_ok(ns),
    )


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [True, False, "auto"])
def test_make_model_routes_as_jax(dtype_name, use_pallas, monkeypatch):
    """On the card every route is the JAX package's on its TPU. On the CPU
    a float32 model's MLP, lookup and posenc routes are the JAX package's
    off the TPU (its field path, which needs bf16 levels, is never taken);
    a bf16 model's are its card routes (the kernels' plain versions, where
    the JAX package runs XLA)."""
    jmodel = j_make_model(j_loads(TINY)["model"], dtype=getattr(jnp, dtype_name),
                          use_pallas=use_pallas)
    model = make_model(loads(TINY)["model"], dtype=getattr(torch, dtype_name), device="cpu",
                       use_pallas=use_pallas)
    assert model.mlp_coarse.use_pallas == model.mlp_fine.use_pallas == use_pallas
    for ns in (1, 2):
        card = _routes(model, ns, "cuda")
        assert card == _jax_routes(jmodel, ns, "tpu", monkeypatch), ns
        assert card["mlp"] == (use_pallas is not False)
        cpu = _routes(model, ns, "cpu")
        if dtype_name == "float32":
            want = _jax_routes(jmodel, ns, "cpu", monkeypatch)
            assert {k: cpu[k] for k in ("mlp", "gather", "posenc")} == {
                k: want[k] for k in ("mlp", "gather", "posenc")}, ns
            assert cpu["mlp"] == (use_pallas is True)
        else:
            assert cpu == card, ns
    with pytest.raises(ValueError):
        make_model(loads(TINY)["model"], device="cpu", use_pallas="yes")


def test_use_pallas_false_runs_no_kernel(monkeypatch):
    """A bf16 model built with use_pallas=False renders through the
    per-layer MLP, the composed lookup and plain posenc: no kernel wrapper
    and no plain version of one runs; under "auto" they do."""
    import importlib

    called = []
    for mod_name, names in (
        ("resnetfc", ("resnetfc_fwd", "resnetfc_fwd_stash", "resnetfc_bwd")),
        ("pyramid", ("pyramid_index_train", "pyramid_index_train_dual")),
        ("posenc", ("posenc_concat",)), ("scatter", ("grid_sample_border_train",)),
        ("field", ("pyramid_field_fused",)),
    ):
        mod = importlib.import_module(f"pixelnerf_tpu_torch.ops.{mod_name}")
        for name in names:
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k: called.append(_n) or _r(*a, **k))
    from pixelnerf_tpu_torch.models import encoder as tenc, pixelnerf as tpix, resnetfc as tres

    for mod, names in ((tenc, ("pyramid_index_train", "pyramid_index_train_dual",
                               "grid_sample_border_train")),
                       (tpix, ("posenc_concat",)), (tres, ("resnetfc_fused", "pyramid_field_fused"))):
        for name in names:
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k: called.append(_n) or _r(*a, **k))
    b = _batch()
    for use_pallas, want_calls in ((False, False), ("auto", True)):
        called.clear()
        model = make_model(loads(TINY)["model"], dtype=torch.bfloat16, device="cpu",
                           use_pallas=use_pallas).with_field_fusion()
        with torch.no_grad():
            enc = model.encode(torch.from_numpy(b["src_images"]), torch.from_numpy(b["src_poses"]),
                               torch.from_numpy(b["focal"]))
            xyz = torch.from_numpy(b["rays"][..., :3] + 1.2 * b["rays"][..., 3:6])
            out = model.query(enc, xyz, torch.from_numpy(b["rays"][..., 3:6]))
        assert out.shape == (SB, R, 4) and torch.isfinite(out).all()
        assert bool(called) == want_calls, (use_pallas, called)


# ------------------------------------------------- one pollen.conf step, float32

POLLEN_CUT = """
model {
    mlp_coarse {
        d_hidden = 32
    }
    mlp_fine {
        d_hidden = 32
    }
    encoder {
        backbone = resnet18
    }
}
renderer {
    n_coarse = 8
    n_fine = 4
    n_fine_depth = 2
    perturb = 0.0
}
"""


def test_pollen_float32_step_through_the_kernels_matches_jax(monkeypatch):
    """The JAX step is jitted (its Pallas kernels traced once in interpret
    mode); its gradients come back in the state of an optax stage that
    keeps them. The weights start from the port's init, made random."""
    import optax

    from pixelnerf_tpu.models import losses as jlosses
    from pixelnerf_tpu.train.step import create_train_state
    from pixelnerf_tpu.train.step import make_train_step as j_make_train_step
    from pixelnerf_tpu_torch.convert import jax_from_state_dict
    from pixelnerf_tpu_torch.models import losses

    path = os.path.join(ROOT, "conf", "exp", "pollen.conf")
    text = f'include required("{path}")\n' + POLLEN_CUT
    conf_j, conf_t = j_loads(text, base_dir=os.path.dirname(path)), loads(text, base_dir=os.path.dirname(path))
    b = _batch()
    model = make_model(conf_t["model"], device="cpu", use_pallas=True)
    assert model.dtype == torch.float32 and model.mlp_coarse.fused_ok((2, R))
    variables = _random_variables(jax_from_state_dict(model.state_dict()), 5)
    for head in ("mlp_coarse", "mlp_fine"):  # outputs of O(1), sigma mostly on
        lin = variables["params"][head]["lin_out"]
        lin["kernel"] = lin["kernel"] * 0.3
        lin["bias"][3] = 1.0
    model.load_state_dict(state_dict_from_jax(variables, model))

    j_alpha, j_init = jlosses.alpha_loss_from_conf(conf_j["loss"].get_config("alpha"))
    t_alpha, t_init = losses.alpha_loss_from_conf(conf_t["loss"].get_config("alpha"))
    assert j_alpha is not None and t_alpha is not None and j_init == t_init == 0
    jmodel = j_make_model(conf_j["model"], use_pallas=True)
    assert j_uses_fused(jmodel, 2)  # the JAX step keeps its stash too
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    tx = optax.chain(keep, optax.adam(1e-3))
    jstep = jax.jit(j_make_train_step(jmodel, JRendererConfig.from_conf(conf_j["renderer"]), tx, R,
                                      NEAR, FAR, alpha_loss_fn=lambda a: j_alpha(a, 0)))
    jstate, jaux = jstep(create_train_state({k: jax.tree_util.tree_map(jnp.asarray, v)
                                             for k, v in variables.items()}, tx),
                         {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    jgrads = jax.device_get(jstate.opt_state[0])

    calls = []
    real = ops_resnetfc.resnetfc_bwd
    monkeypatch.setattr(ops_resnetfc, "resnetfc_bwd",
                        lambda *a, **k: calls.append(k.get("grad_dtype")) or real(*a, **k))
    step = make_train_step(model, RendererConfig.from_conf(conf_t["renderer"]),
                           make_optimizer(model, 1e-3), R, NEAR, FAR,
                           alpha_loss_fn=lambda a: t_alpha(a, 0))
    aux = step({k: torch.from_numpy(v) for k, v in b.items()})
    # three MLP calls (coarse, the fine pass's cached and new samples), each
    # backward writing float32 dz and dxin, and no rematerialization
    assert calls == [torch.float32] * 3
    assert set(aux) == set(jaux) == {"rc", "rf", "ra", "t"} and aux["ra"].item() != 0
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-3, err_msg=k)
    want = params_from_jax(jgrads, model)
    for n, p in model.named_parameters():
        assert p.grad is not None and p.grad.norm() > 0, n
        err = ((p.grad - want[n]).norm() / want[n].norm()).item()
        assert err <= 2e-2, (n, err)
