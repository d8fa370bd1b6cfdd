"""The layered ResnetFC path (ops/layer_chain.py) against the JAX package.

The card runs the fused ResnetFC and field on the layered kernels where
the block chains lack the widths: hidden (or the padded d_in) past 512 and
more than 64 views (`ops/resnetfc.py:takes_chains`). Here the same
sequence of launches runs on CPU tensors, each kernel wrapper taking its
plain version, and is held against the JAX package:

- `layered_fwd` / `layered_bwd` (forward, stash, dz, dxin and every weight
  gradient) against the Pallas ResnetFC in interpret mode at hidden 576
  (3 blocks pooling at block 2, 2 views) and at 65 and 80 views (hidden
  64), tests/test_torch_resnetfc.py's tolerances; their stash equal to the
  whole plain forward's, bit for bit; `layered_field_fwd` /
  `layered_field_bwd` against the Pallas field at hidden 576 and 65 views.
- bf16 models at hidden 576 and at 65 source views, one train step and
  one render each, through the card's route (the wrappers' device test
  answering "cuda", the layered kernels on their plain versions) against
  the JAX model with its Pallas kernels in interpret mode, at
  tests/test_torch_train.py's and tests/test_torch_slice.py's bf16
  tolerances.
- the card's route through a stand-in for the kernels' libraries that
  records each launch (tests/test_torch_chain_widths.py's): at hidden
  576, 640 and 1024 and at 65, 80 and 128 views, the ResnetFC and field
  wrappers launch the layered kernels only, never a chain, never a plain
  version, and the models route as the JAX package's `_pallas_ok` /
  `field_path_ok`.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pixelnerf_tpu_torch.ops.field as ops_field
import pixelnerf_tpu_torch.ops.layer_chain as ops_layer_chain
import pixelnerf_tpu_torch.ops.pyramid as ops_pyramid
import pixelnerf_tpu_torch.ops.resnetfc as ops_resnetfc
from pixelnerf_tpu.eval.common import encode_views as j_encode_views
from pixelnerf_tpu.eval.render_utils import render_full as j_render_full
from pixelnerf_tpu.models.pixelnerf import make_model as j_make_model
from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.ops.field_pallas import pyramid_field_fused as j_field
from pixelnerf_tpu.ops.resnetfc_pallas import resnetfc_fused as j_fused
from pixelnerf_tpu.render.renderer import RendererConfig as JRendererConfig
from pixelnerf_tpu.utils.hocon import loads as j_loads
from pixelnerf_tpu_torch.convert import params_from_jax, state_dict_from_jax
from pixelnerf_tpu_torch.eval.common import encode_views
from pixelnerf_tpu_torch.eval.render_utils import render_full
from pixelnerf_tpu_torch.models.pixelnerf import make_model
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops.layer_chain import (
    layered_bwd, layered_field_bwd, layered_field_fwd, layered_fwd,
)
from pixelnerf_tpu_torch.ops.resnetfc import (
    FieldWeights, resnetfc_fwd_plain, stash_layout, takes_chains,
)
from pixelnerf_tpu_torch.render.renderer import RendererConfig
from pixelnerf_tpu_torch.train.step import make_optimizer, make_train_step, sample_rays
from pixelnerf_tpu_torch.utils.hocon import loads
from tests.test_torch_chain_widths import (
    _jax_fused_calls, _jax_kernels_in_interpret_mode, _jax_weights, _Lib, _numpy_weights,
)
from tests.test_torch_resnetfc import _grad_close
from tests.test_torch_slice import _look_at, _random_variables
from tests.test_torch_train import (
    CONF, FAR, FOCAL, LR, NEAR, R, _assert_step_matches, _jax_step, _models,
)

N_BLOCKS, COMBINE, D_IN, D_LATENT = 3, 2, 42, 48
# (hidden, NS, SB, B)
PALLAS_CASES = {"hidden 576": (576, 2, 1, 21), "views 65": (64, 65, 1, 5),
                "views 80": (64, 80, 1, 3)}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads a test: the suite runs six workers on the CPU's
    cores, and more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(hidden, ns, sb, b, d_latent=D_LATENT, seed=0):
    rng = np.random.default_rng(seed + hidden + ns)
    w = _numpy_weights(rng, hidden, d_latent, 4, n_blocks=N_BLOCKS, n_inj=COMBINE)
    z = rng.normal(size=(sb, ns, b, d_latent)).astype(np.float32)
    xin = rng.normal(size=(sb, ns, b, D_IN)).astype(np.float32)
    g = rng.normal(size=(sb, b, 4)).astype(np.float32)
    return rng, w, z, xin, g


def _torch(w, z, xin, g):
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    return (FieldWeights(**{k: torch.from_numpy(v) for k, v in w.items()}), bf(z), bf(xin),
            torch.from_numpy(g))


def _assert_grads(dz, dxin, dw, jdz, jdx, jdw, shapes):
    for got, want in ((dz, jdz), (dxin, jdx)):
        if got is not None:
            _grad_close(got.float(), np.asarray(want.astype(jnp.float32)), extra_ulp=True)
    for name in FieldWeights._fields:
        got = getattr(dw, name)
        assert got.shape == getattr(shapes, name).shape, name
        _grad_close(got, np.asarray(getattr(jdw, name)).reshape(got.shape))


@pytest.mark.parametrize("hidden,ns,sb,b", PALLAS_CASES.values(), ids=PALLAS_CASES.keys())
def test_layered_resnetfc_matches_the_pallas_kernel(hidden, ns, sb, b):
    """The layered forward (primal and stash) and backward, each launch
    on its plain version, against the Pallas ResnetFC's VJP in interpret
    mode; the stash equal to the whole plain forward's."""
    assert not takes_chains(hidden, D_LATENT, D_IN, 4, ns)
    _, w, z, xin, g = _inputs(hidden, ns, sb, b)
    jfn = lambda zz, xx, ww: j_fused(zz, xx, ww, N_BLOCKS, COMBINE, ns, True)
    jout, vjp = jax.vjp(jfn, jnp.asarray(z, jnp.bfloat16), jnp.asarray(xin, jnp.bfloat16),
                        _jax_weights(w))
    jdz, jdx, jdw = vjp(jnp.asarray(g))

    tw, tz, tx, tg = _torch(w, z, xin, g)
    args = (N_BLOCKS, COMBINE, ns)
    primal = layered_fwd(tz, tx, tw, *args, stash=False)[0]
    out, spre, spost = layered_fwd(tz, tx, tw, *args, stash=True)
    assert torch.equal(primal, out)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-2, atol=2e-2)
    _, wpre, wpost = resnetfc_fwd_plain(tz, tx, tw, *args, stash=True)
    k, m = stash_layout(*args)
    assert spost.shape == (2 * m + 1, sb, b, hidden) and torch.equal(spost, wpost)
    assert (spre is None) == (k == 0) and (spre is None or torch.equal(spre, wpre))
    dz, dxin, dw, _ = layered_bwd(tz, tx, tg, spre, spost, tw, *args)
    _assert_grads(dz, dxin, dw, jdz, jdx, jdw, tw)


FIELD_CASES = {"hidden 576": (576, 2, 1, 24), "views 65": (64, 65, 1, 2)}
FIELD_LEVELS = [(4, 4, 16), (2, 2, 32)]


@pytest.mark.parametrize("hidden,ns,sb,b", FIELD_CASES.values(), ids=FIELD_CASES.keys())
def test_layered_field_matches_the_pallas_field(hidden, ns, sb, b):
    """The field at the layered widths (the pyramid gather, the layered
    forward, the layered backward and the pyramid scatter, each on its
    plain version) against the Pallas field's VJP in interpret mode: the
    output, dxin, every weight gradient and the bf16 level gradients."""
    dl = sum(c for *_, c in FIELD_LEVELS)
    rng, w, _, xin, g = _inputs(hidden, ns, sb, b, d_latent=dl, seed=7)
    feats = [rng.normal(size=(sb * ns, h, ww, c)).astype(np.float32) for h, ww, c in FIELD_LEVELS]
    grid = rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)).astype(np.float32)
    jfn = lambda fs, x, ww: j_field(fs, jnp.asarray(grid), x, ww, N_BLOCKS, COMBINE, ns, True)
    jout, vjp = jax.vjp(jfn, tuple(jnp.asarray(f, jnp.bfloat16) for f in feats),
                        jnp.asarray(xin, jnp.bfloat16), _jax_weights(w))
    jdf, jdx, jdw = vjp(jnp.asarray(g))

    tw, _, tx, tg = _torch(w, np.zeros(1, np.float32), xin, g)
    tf = [torch.from_numpy(f).to(torch.bfloat16) for f in feats]
    tgrid = torch.from_numpy(grid)
    args = (N_BLOCKS, COMBINE, ns)
    out, zs, spre, spost = layered_field_fwd(tf, tgrid, tx, tw, *args, stash=True)
    assert torch.equal(out, layered_field_fwd(tf, tgrid, tx, tw, *args, stash=False)[0])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-2, atol=2e-2)
    d_feats, dxin, dw = layered_field_bwd(tgrid, tx, tg, zs, spre, spost, tw, *args, FIELD_LEVELS)
    _assert_grads(None, dxin, dw, None, jdx, jdw, tw)
    for got, want in zip(d_feats, jdf):
        assert got.shape == want.shape
        _grad_close(got.to(torch.bfloat16).float(), np.asarray(want.astype(jnp.float32)),
                    extra_ulp=True)


# ---------------------------------------------------------------- the card's route


def _no_plain(monkeypatch):
    """Every plain version of the ResnetFC and field kernels raises."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card's route")

    for mod, names in ((ops_resnetfc, ("resnetfc_fwd_plain", "resnetfc_bwd_plain")),
                       (ops_field, ("field_plain", "field_bwd_plain")),
                       (ops_layer_chain, ("layer_fwd_plain", "layer_bwd_plain",
                                          "view_pool_fwd_plain", "view_pool_bwd_plain",
                                          "resnetfc_wgrad_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)


def _stand_in(monkeypatch):
    """The card's route with a stand-in library for every kernel (the
    lookups' wrappers recorded by name)."""
    import types

    lib = _Lib()
    for mod in (ops_resnetfc, ops_field, ops_layer_chain):
        monkeypatch.setattr(mod, "_device_of", lambda t, what: "cuda")
    monkeypatch.setattr(ops_resnetfc, "_library", lambda name: lib)
    monkeypatch.setattr(ops_field, "_library", lambda: lib)
    monkeypatch.setattr(ops_layer_chain, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))

    def gather(feats, uv):
        lib.launches.append("pyramid_gather")
        return torch.zeros(uv.shape[:2] + (sum(f.shape[3] for f in feats),), dtype=torch.bfloat16)

    def scatter(uv, dz, csizes, hws, fine_hw):
        lib.launches.append("pyramid_scatter_add")
        return [torch.zeros((uv.shape[0], h, w, c)) for c, (h, w) in zip(csizes, hws)]

    monkeypatch.setattr(ops_layer_chain, "pyramid_gather", gather)
    monkeypatch.setattr(ops_layer_chain, "pyramid_scatter_add", scatter)
    _no_plain(monkeypatch)
    return lib


SWEEP = {"hidden 576": (576, 2), "hidden 640": (640, 2), "hidden 1024": (1024, 2),
         "views 65": (512, 65), "views 80": (512, 80), "views 128": (64, 128)}
LAYERED = {"pnt_layer", "pnt_view_pool_fwd", "pnt_view_pool_bwd", "pnt_layer_wgrad",
           "pyramid_gather", "pyramid_scatter_add"}


@pytest.mark.parametrize("hidden,ns", SWEEP.values(), ids=SWEEP.keys())
def test_the_card_launches_the_layered_kernels_past_the_chain_widths(hidden, ns, monkeypatch):
    """Past the chains' widths every bf16 configuration the JAX predicate
    takes runs on the card: the models route as the JAX package's, and the
    ResnetFC and field wrappers (primal, stash forward, backward) launch
    the layered kernels alone, no chain and no plain version, with one
    count a launch."""
    sb, b, dl, n_blocks, combine = 1, 3, 512, 5, 3
    m = ResnetFC(42, 4, n_blocks=n_blocks, d_latent=dl, d_hidden=hidden, combine_layer=combine,
                 dtype=torch.bfloat16)
    jm = JResnetFC(d_in=42, d_out=4, n_blocks=n_blocks, d_latent=dl, d_hidden=hidden,
                   combine_layer=combine, dtype=jnp.bfloat16, use_pallas=True)
    assert m.fused_ok((ns, b)) == jm._pallas_ok(jnp.zeros((ns * b, 1)), (ns, b)) is True
    assert m.field_path_ok(ns) == jm.field_path_ok(ns) is True
    assert not takes_chains(hidden, dl, 42, 4, ns)
    lib = _stand_in(monkeypatch)
    counts = lambda: [getattr(ops_layer_chain, n).launches for n in (
        "layer_fwd", "layer_bwd", "view_pool_fwd", "view_pool_bwd", "layer_wgrad")]
    chains = lambda: [f.launches for f in (
        ops_resnetfc.resnetfc_fwd, ops_resnetfc.resnetfc_fwd_stash, ops_resnetfc.resnetfc_bwd,
        ops_field.pyramid_field_fused, ops_field.pyramid_field_fused_fwd_stash,
        ops_field.pyramid_field_fused_bwd)]
    before, before_chains = counts(), chains()
    z = torch.zeros(ns * b, dl)
    x = torch.zeros(ns * b, 42)
    with torch.no_grad():
        assert m((z, x), combine_inner_dims=(ns, b)).shape == (b, 4)
    w = m.weights()
    t = lambda *s: torch.zeros(s, dtype=torch.bfloat16)
    args = (n_blocks, combine, ns)
    _, spre, spost = ops_resnetfc.resnetfc_fwd_stash(t(sb, ns, b, dl), t(sb, ns, b, 42), w, *args)
    ops_resnetfc.resnetfc_bwd(t(sb, ns, b, dl), t(sb, ns, b, 42), torch.zeros(sb, b, 4), spre,
                              spost, w, *args)
    levels = [(8, 8, 256), (4, 4, 256)]
    feats = [t(sb * ns, h, wd, c) for h, wd, c in levels]
    grid = torch.zeros(sb, ns, b, 2)
    ops_field.pyramid_field_fused(feats, grid, t(sb, ns, b, 42), w, *args)
    _, zs, fpre, fpost = ops_field.pyramid_field_fused_fwd_stash(feats, grid, t(sb, ns, b, 42), w,
                                                                 *args)
    d_feats, _, _ = ops_field.pyramid_field_fused_bwd(grid, t(sb, ns, b, 42), torch.zeros(sb, b, 4),
                                                      zs, fpre, fpost, w, *args, levels)
    assert [d.shape for d in d_feats] == [f.shape for f in feats]
    assert set(lib.launches) == LAYERED and chains() == before_chains
    # a forward: w_in, 3 injections, 2 a block, lin_out and a pooling; a
    # backward: lin_out, 2 a block, 3 injections, dxin, bf(g) and the pooling
    # and a call of the weight gradients (whose 2 launches the library
    # reports: none from the stand-in); four forwards and two backwards here.
    # The products that sum bias gradients (lin_out's and 2 a block but the
    # one before the pooling) count their column sums' reduction too, and so
    # do bf(g) and the pooling's backward (b_out's and the sums before it).
    fwd, bwd = 2 * n_blocks + combine + 2, 2 * n_blocks + combine + 2
    sums = 1 + 2 * n_blocks - 1
    assert [a - c for a, c in zip(counts(), before)] == [4 * fwd, 2 * (bwd + sums), 4, 2 * 4, 0]
    assert lib.launches.count("pnt_layer") == 4 * fwd + 2 * bwd
    assert lib.launches.count("pnt_layer_wgrad") == 2


# ---------------------------------------------------------------- whole models


def _layered_route(monkeypatch):
    """The card's route on the CPU: the wrappers' device test answers
    "cuda", and the layered kernels (whose own device test sees the CPU)
    run their plain versions; returns the layered calls by name."""
    calls = []
    for mod in (ops_resnetfc, ops_field):
        monkeypatch.setattr(mod, "_device_of", lambda t, what: "cuda")
    for name in ("layered_fwd", "layered_bwd", "layered_field_fwd", "layered_field_bwd"):
        fn = getattr(ops_layer_chain, name)
        monkeypatch.setattr(ops_layer_chain, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    monkeypatch.setattr(ops_resnetfc, "_launch_fwd", None)  # no chain on this route
    monkeypatch.setattr(ops_resnetfc, "launch_bwd", None)
    monkeypatch.setattr(ops_field, "_launch", None)
    return calls


CONF_576 = CONF.replace("d_hidden = 32", "d_hidden = 576")
VIEWS = 65


def _views_batch(ns, seed=0):
    """tests/test_torch_train.py's batch with one object and `ns` source
    views on a ring around it, the rays from one more view."""
    rng = np.random.default_rng(seed)
    h = w = 32
    nv = ns + 1
    images = rng.uniform(-1, 1, size=(1, nv, h, w, 3)).astype(np.float32)
    ang = np.linspace(0.0, 2.0 * np.pi, nv, endpoint=False)
    eyes = np.stack([1.3 * np.cos(ang), 0.3 + 0.1 * np.sin(3 * ang), 1.3 * np.sin(ang)], -1)
    poses = np.stack([_look_at(e) for e in eyes])[None].astype(np.float32)
    focal = np.full((1, 2), FOCAL, np.float32)
    c = np.full((1, 2), w / 2.0, np.float32)
    ys, xs = rng.integers(8, 24, size=(2, 1, R))
    pix = ns * h * w + ys * w + xs
    rays, rgb_gt = sample_rays(
        torch.from_numpy(images), torch.from_numpy(poses), torch.from_numpy(focal),
        torch.from_numpy(c), NEAR, FAR, R, draws={"pix": torch.from_numpy(pix)},
    )
    return dict(images=images, poses=poses, focal=focal, c=c, src_images=images[:, :ns],
                src_poses=poses[:, :ns], rays=rays.numpy(), rgb_gt=rgb_gt.numpy())


def _models_views(ns):
    """tests/test_torch_train.py's `_models` in bf16 on `_views_batch`."""
    conf_j, conf_t = j_loads(CONF), loads(CONF)
    b = _views_batch(ns)
    jmodel = j_make_model(conf_j["model"], dtype=jnp.bfloat16, use_pallas=True)
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(b["src_images"]), jnp.asarray(b["src_poses"]),
        jnp.asarray(b["focal"]), jnp.zeros((1, 8, 3)), viewdirs=jnp.zeros((1, 8, 3)),
    )
    variables = _random_variables(jax.device_get(variables), 1)
    for head in ("mlp_coarse", "mlp_fine"):
        lin = variables["params"][head]["lin_out"]
        lin["kernel"] = lin["kernel"] * 0.3
        lin["bias"][3] = 1.0
    model = make_model(conf_t["model"], dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, model))
    return conf_j, conf_t, jmodel, variables, model, b


MODELS = {"hidden 576": lambda: _models("bfloat16", conf=CONF_576),
          "views 65": lambda: _models_views(VIEWS)}


@pytest.fixture(scope="module")
def views_step():
    """`_models_views`' model at a view count and its bf16 JAX train step
    (the Pallas kernels in interpret mode), each made once for the module:
    a function of NS. Its `ports` cache the port's steps from the same
    parameters (`_port_grads`)."""
    made = {}

    def get(ns):
        if ns not in made:
            conf_j, conf_t, jmodel, variables, model, b = _models_views(ns)
            with pytest.MonkeyPatch.context() as mp:
                _jax_kernels_in_interpret_mode(mp)
                jcalls = _jax_fused_calls(mp)
                jstate, jaux, jgrads = _jax_step(jmodel, variables, b,
                                                 JRendererConfig.from_conf(conf_j["renderer"]))
            made[ns] = types.SimpleNamespace(
                conf_t=conf_t, model=model, b=b, jcalls=list(jcalls), jstate=jstate, jaux=jaux,
                jgrads=jgrads, init={k: v.clone() for k, v in model.state_dict().items()},
                ports={})
        return made[ns]

    return get


@pytest.mark.parametrize("which", MODELS.keys())
def test_layered_model_train_step_matches_jax(which, monkeypatch, views_step):
    """One bf16 train step of the hidden-576 and the 65-view model through
    the layered path against the JAX step through its Pallas kernels, at
    tests/test_torch_train.py's bf16 tolerances. At 65 views the trunk's
    first convolution's gradient reads 0.113 relative to the JAX one, on
    the port's whole plain route as on the layered one (the two equal bit
    for bit): the two libraries' bf16 rounding, which reads the same at 2
    and 16 views (`test_trunk_gradient_is_bf16_rounding_at_every_view_count`),
    not the layered path. There the encoder's gradients are held equal to
    the plain route's and within 0.15 of JAX's, every other quantity at
    test_torch_train.py's bounds."""
    if which == "hidden 576":
        conf_j, conf_t, jmodel, variables, model, b = MODELS[which]()
        _jax_kernels_in_interpret_mode(monkeypatch)
        jcalls = _jax_fused_calls(monkeypatch)
        jstate, jaux, jgrads = _jax_step(jmodel, variables, b,
                                         JRendererConfig.from_conf(conf_j["renderer"]))
        assert jcalls and all(jcalls)
        calls = _layered_route(monkeypatch)
        _assert_step_matches("bfloat16", model, model, conf_t, variables, b, jstate, jaux, jgrads)
        assert {"layered_fwd", "layered_bwd"} <= set(calls)
        return
    case = views_step(VIEWS)
    assert case.jcalls and all(case.jcalls)
    model, conf_t, b, jstate, jaux = case.model, case.conf_t, case.b, case.jstate, case.jaux
    plain_aux, plain = _port_grads(case, "bf16 taps")
    model.load_state_dict(case.init)
    calls = _layered_route(monkeypatch)
    aux, grads = _port_step(model, conf_t, b)
    assert {"layered_fwd", "layered_bwd"} <= set(calls)
    for k in ("rc", "rf", "t"):
        assert aux[k].item() == plain_aux[k].item()
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=2e-2)
    want = params_from_jax(case.jgrads, model)
    for n, g in grads.items():
        rel = ((g - want[n]).norm() / want[n].norm()).item()
        if n.startswith("encoder"):
            assert torch.equal(g, plain[n]) and rel <= 0.15, (n, rel)
        else:
            assert rel <= 5e-2, (n, rel)
    sd = state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    for n, buf in model.named_buffers():
        scale = max(sd[n].abs().max().item(), 1.0)
        np.testing.assert_allclose(buf.numpy(), sd[n].numpy(), rtol=0, atol=1e-2 * scale)


def _scatter_f32_products(uv, dz, csizes, hws, fine_hw, dz2=None):
    """The plain pyramid scatter with its products held in float32: the
    composed tap weights unrounded (the TPU kernel and the plain version
    round them to the cotangent's bf16) and a second cotangent added in
    float32."""
    b = dz.shape[0]
    g_all = dz.float() if dz2 is None else dz.float() + dz2.float()
    outs, c0 = [], 0
    for c, (hn, wn) in zip(csizes, hws):
        idx, w = ops_pyramid._level_taps(uv, hn, wn, *fine_hw, torch.float32)
        g = g_all[..., c0:c0 + c]
        c0 += c
        acc = torch.zeros((b * hn * wn, c), dtype=torch.float32)
        rows = torch.arange(b)[:, None] * (hn * wn)
        for t in range(idx.shape[-1]):
            acc.index_add_(0, (rows + idx[..., t]).reshape(-1), (w[..., t, None] * g).reshape(-1, c))
        outs.append(acc.reshape(b, hn, wn, c))
    return outs


def _port_grads(case, how):
    """The port's train step from `case`'s parameters, made once: (aux,
    gradients) of the bf16 model on the plain route ("bf16 taps", the
    scatter as it stands; "f32 products", `_scatter_f32_products`), or of
    the same parameters in a float32 model ("float32")."""
    if how not in case.ports:
        with pytest.MonkeyPatch.context() as mp:
            model = case.model
            if how == "float32":
                model = make_model(case.conf_t["model"], dtype=torch.float32, device="cpu")
                model.load_state_dict({k: v.float() if v.is_floating_point() else v
                                       for k, v in case.init.items()})
            else:
                case.model.load_state_dict(case.init)
            if how == "f32 products":
                mp.setattr(ops_pyramid, "pyramid_scatter_add_plain", _scatter_f32_products)
            case.ports[how] = _port_step(model, case.conf_t, case.b)
    return case.ports[how]


# The trunk's gradient against JAX by view count, measured on this file's
# batch (one object, 32x32 views on a ring, 16 rays), at 2 / 16 / 65 views:
# the worst encoder parameter's relative error 0.125 / 0.127 / 0.113
# (conv1: 0.112 / 0.127 / 0.113), the same with the scatter's products in
# float32 (within 1.5e-3 of it); over the whole trunk the port lies 0.099 /
# 0.083 / 0.044 from JAX, and each bf16 step 0.19 / 0.11 / 0.067 from the
# float32 step's; the f32 scatter moves the port's trunk 0.006 / 0.005 /
# 0.003.
TRUNK_VIEWS = (2, 16, VIEWS)
TRUNK_SCATTERS = ("bf16 taps", "f32 products")
TRUNK_TOL = 0.15  # every encoder parameter, port against JAX
SCATTER_MOVES = 0.02  # the f32 scatter's move of the port's trunk


@pytest.mark.parametrize("scatter", TRUNK_SCATTERS)
@pytest.mark.parametrize("ns", TRUNK_VIEWS)
def test_trunk_gradient_is_bf16_rounding_at_every_view_count(ns, scatter, views_step):
    """The bf16 trunk's gradient against the JAX step's at 2, 16 and 65
    views, with the port's pyramid scatter as it stands and with its
    products held in float32: rounding, not a fault of the port, and no
    larger with more views. Every encoder parameter within TRUNK_TOL of
    JAX's at every view count; over the whole trunk the two bf16 steps
    lie closer to each other than either lies to the float32 step from the
    same parameters (the port's float32 step is JAX's within 1e-3,
    tests/test_torch_train.py), so what separates them is the bf16
    rounding each does; and holding the scatter's products in float32
    moves the port's trunk by at most SCATTER_MOVES, a sixth of the gap:
    the interpret-mode scatter's bf16 products and the port's rounded tap
    weights do not cause it."""
    case = views_step(ns)
    got = _port_grads(case, scatter)[1]
    f32 = _port_grads(case, "float32")[1]
    want = params_from_jax(case.jgrads, case.model)
    trunk = [n for n in got if n.startswith("encoder")]
    for n in trunk:
        rel = ((got[n] - want[n]).norm() / want[n].norm()).item()
        assert rel <= TRUNK_TOL, (ns, n, rel)
    flat = lambda g: torch.cat([g[n].flatten() for n in trunk])
    dist = lambda a, b: ((flat(a) - flat(b)).norm() / flat(b).norm()).item()
    gap = dist(got, want)
    assert gap < min(dist(got, f32), dist(want, f32)), (ns, gap, dist(got, f32), dist(want, f32))
    moved = dist(got, _port_grads(case, "bf16 taps")[1])
    assert moved <= SCATTER_MOVES, (ns, moved)


def _port_step(model, conf_t, b):
    """One port train step from the model's parameters: (aux, gradients)."""
    model.zero_grad()
    step = make_train_step(model, RendererConfig.from_conf(conf_t["renderer"]),
                           make_optimizer(model, LR), R, NEAR, FAR)
    aux = step({k: torch.from_numpy(v) for k, v in b.items()})
    return aux, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("which", MODELS.keys())
def test_layered_model_render_matches_jax(which, monkeypatch):
    """The same models' eval render of the target rays through the layered
    field against the JAX `render_full` through its Pallas field, at
    tests/test_torch_slice.py's bf16 tolerance (5e-2, 1e-2 on average)."""
    conf_j, conf_t, jmodel, variables, model, b = MODELS[which]()
    _jax_kernels_in_interpret_mode(monkeypatch)
    jcalls = _jax_fused_calls(monkeypatch)
    images, poses, rays = b["src_images"][0], b["src_poses"][0], b["rays"][0]
    jenc = j_encode_views(jmodel, variables, images, poses, FOCAL)
    want = j_render_full(jmodel, variables, jenc, rays,
                         JRendererConfig.from_conf(conf_j["renderer"]).replace(perturb=0.0), chunk=8)
    calls = _layered_route(monkeypatch)
    model.eval()
    with torch.no_grad():
        enc = encode_views(model, images, poses, FOCAL)
        got = render_full(model, enc, rays, RendererConfig.from_conf(conf_t["renderer"])
                          .replace(perturb=0.0), chunk=8)
    assert jcalls and set(jcalls) == {"field"}
    assert set(calls) == {"layered_field_fwd", "layered_fwd"}  # the field's runs layered_fwd
    for head in ("coarse", "fine"):
        for key in ("rgb", "alpha"):
            g, wnt = got[head][key].numpy(), np.asarray(want[head][key])
            assert g.shape == wnt.shape and np.isfinite(g).all()
            np.testing.assert_allclose(g, wnt, rtol=0, atol=5e-2)
            assert np.abs(g - wnt).mean() < 1e-2
