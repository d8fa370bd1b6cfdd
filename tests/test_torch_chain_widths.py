"""The widths of the card's block chains, the wrappers' zero padding to
them, and bf16 models off the chains' widths held against the JAX package.

The port's ResnetFC routes as the JAX package's `_pallas_ok`: every bf16
model the TPU predicate (`supported_config`) takes goes to the fused
wrappers, on the card as on the CPU. `chain_widths_ok` is the predicate
of the widths the chains are built for; the wrappers bring a model's
widths to them first, exactly (`chain_plan`, `even_d_in`): an odd d_in
gets a zero column, hidden zero channels up to the next of 64, 128, 256
and 512, d_latent zero columns up to a multiple of 64, and d_out above 16
runs in groups of 16 outputs. A hidden width past 512 and more than 64
views take the layered kernels (`ops/layer_chain.py`, `takes_chains`)
instead, never a plain version on the card (tests/test_torch_layer_chain.py
holds that path against the JAX package).

The card's route is shown here with the wrappers' device test answering
"cuda" for CPU tensors and either a stand-in for the kernels' libraries
that records each launch's arguments and runs nothing, or the chain
launches replaced by the kernels' plain versions at the padded widths
(`_plain_chains`), so that the padding, the output groups, the sums of
their gradients and the cuts back run on the CPU. Through the latter the
ResnetFC at hidden 16, 192 and 384, d_latent 96 and d_out 20 is held
against the Pallas kernel in interpret mode (tests/test_torch_resnetfc.py's
tolerances), the field at d_latent 96 (on the last level's zero channels),
hidden 16 and d_out 20 against the Pallas field and the port's unpadded
plain version, and whole bf16 models at hidden 16, 192 and 384 (train step
and render) against the JAX model. The d_in-39 model's train step and
render go through the kernels' plain versions on the CPU. Model
tolerances are tests/test_torch_train.py's and tests/test_torch_slice.py's
bf16 ones.
"""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pixelnerf_tpu_torch.models.resnetfc as mod_resnetfc
import pixelnerf_tpu_torch.ops.field as ops_field
import pixelnerf_tpu_torch.ops.layer_chain as ops_layer_chain
import pixelnerf_tpu_torch.ops.resnetfc as ops_resnetfc
from pixelnerf_tpu.eval.common import encode_views as j_encode_views
from pixelnerf_tpu.eval.render_utils import render_full as j_render_full
from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.render.renderer import RendererConfig as JRendererConfig
from pixelnerf_tpu_torch.eval.common import encode_views
from pixelnerf_tpu_torch.eval.render_utils import render_full
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops.resnetfc import (
    FieldWeights, chain_plan, chain_widths_ok, check_chain_widths, even_d_in, stash_layout,
)
from pixelnerf_tpu_torch.render.renderer import RendererConfig
from tests.test_torch_train import CONF, FOCAL, _assert_step_matches, _jax_step, _models

FLAGSHIP = dict(hidden=512, d_latent=512, d_in=42, d_out=4, ns=2)
# each one width off the flagship's that the chains lack
OFF_WIDTHS = {
    "hidden 192": dict(hidden=192),
    "views 65": dict(ns=65),
    "d_out 17": dict(d_out=17),
    "d_latent 96": dict(d_latent=96),
}
# the widths the card routes: d_in 39 (bf16 without view directions), the
# above, and hidden 16, 384 and 576 (past the widest chain)
ROUTED = {"d_in 39": dict(d_in=39), **OFF_WIDTHS, "hidden 16": dict(hidden=16),
          "hidden 384": dict(hidden=384), "hidden 576": dict(hidden=576)}
# what the wrappers launch for each: (hidden, d_latent, d_in, d_in_pad, output groups)
LAUNCHED = {"d_in 39": (512, 512, 40, 48, 1), "hidden 192": (256, 512, 42, 48, 1),
            "d_out 17": (512, 512, 42, 48, 2), "d_latent 96": (512, 128, 42, 48, 1),
            "hidden 16": (64, 512, 42, 48, 1), "hidden 384": (512, 512, 42, 48, 1)}


def _widths(**over):
    w = dict(FLAGSHIP)
    w.update(over)
    return w


def test_chain_widths_ok_takes_the_flagship_and_its_views():
    for ns in (1, 2, 3, 64):
        assert chain_widths_ok(**_widths(ns=ns))
    for hidden in (64, 128, 256, 512):
        assert chain_widths_ok(**_widths(hidden=hidden, d_in=42))
    for d_in in (39, 15, 63):  # odd: the wrappers add a zero column first
        assert not chain_widths_ok(**_widths(hidden=64, d_in=d_in))
        assert chain_widths_ok(**_widths(hidden=64, d_in=d_in + 1))


@pytest.mark.parametrize("over", OFF_WIDTHS.values(), ids=OFF_WIDTHS.keys())
def test_chain_widths_ok_refuses_and_the_check_raises(over):
    w = _widths(**over)
    assert not chain_widths_ok(**w)
    with pytest.raises(ValueError, match="chain kernels take"):
        check_chain_widths(w["hidden"], w["d_latent"], w["d_in"], w["d_out"], w["ns"])


def test_even_d_in_adds_one_zero_column_to_an_odd_width_only():
    x = torch.randn(2, 3, 5, 39).to(torch.bfloat16)
    y = even_d_in(x)
    assert y.shape == (2, 3, 5, 40) and torch.equal(y[..., :39], x) and not y[..., 39].any()
    x42 = torch.randn(2, 42).to(torch.bfloat16)
    assert even_d_in(x42) is x42


class _Lib:
    """A stand-in for a kernel library: shared-memory sizes, the
    workspaces (the weight gradients', the pooling's column sums') and the
    layered products' plans are 0, and
    each launch records its arguments and succeeds without running. The
    ResnetFC forward's launch also copies the positional code's bytes as
    its kernel would read them."""

    def __init__(self):
        self.calls = {}
        self.launches = []
        self.xin = None

    def __getattr__(self, name):
        if name.endswith("_smem_bytes"):
            return lambda *a: 0
        if name.endswith("_workspace"):
            return lambda *a: 0
        if name == "pnt_layer_plan":  # a query, no launch: an empty plan
            return lambda ints, out: 0

        def launch(*args):
            self.calls[name] = args
            self.launches.append(name)
            if name == "pnt_resnetfc_fwd":
                sb, ns, b, d_in = args[15], args[16], args[17], args[19]
                raw = ctypes.string_at(args[1], sb * ns * b * d_in * 2)
                self.xin = np.frombuffer(raw, np.uint16).reshape(sb * ns * b, d_in)
            return 0

        return launch


def _card_route(monkeypatch, lib):
    """The wrappers take CPU tensors as the card's: their device test says
    "cuda" and `lib` stands in for every kernel library."""
    monkeypatch.setattr(ops_resnetfc, "_device_of", lambda t, what: "cuda")
    monkeypatch.setattr(ops_field, "_device_of", lambda t, what: "cuda")
    monkeypatch.setattr(ops_resnetfc, "_library", lambda name: lib)
    monkeypatch.setattr(ops_field, "_library", lambda: lib)
    monkeypatch.setattr(ops_layer_chain, "_device_of", lambda t, what: "cuda")
    monkeypatch.setattr(ops_layer_chain, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


def _module(hidden, d_latent, d_in, d_out, device="cpu"):
    return ResnetFC(d_in, d_out, n_blocks=5, d_latent=d_latent, d_hidden=hidden,
                    combine_layer=3, dtype=torch.bfloat16).to(device)


@pytest.mark.parametrize("over", ROUTED.values(), ids=ROUTED.keys())
def test_the_card_routes_as_the_jax_package_and_never_to_a_plain_version(over, monkeypatch):
    """Each width goes to the fused wrapper exactly where the JAX package's
    `_pallas_ok` takes its Pallas kernel. There every width but a hidden
    one past 512 and more than 64 views launches the forward at the
    chain's widths (`chain_plan`: d_in 39 as 40, hidden zero-padded,
    d_latent 96 as 128, d_out 17 as two runs of the chain); those two
    launch the layered kernels, one a product (15 at 5 blocks and 3
    injections) and one pooling, and no chain."""
    w = _widths(**over)
    ns, b = w["ns"], 3
    m = _module(w["hidden"], w["d_latent"], w["d_in"], w["d_out"])
    jm = JResnetFC(d_in=w["d_in"], d_out=w["d_out"], n_blocks=5, d_latent=w["d_latent"],
                   d_hidden=w["hidden"], combine_layer=3, dtype=jnp.bfloat16, use_pallas=True)
    assert m.fused_ok((ns, b)) == jm._pallas_ok(jnp.zeros((ns * b, 1)), (ns, b)) is True
    lib = _Lib()
    _card_route(monkeypatch, lib)
    z = torch.randn(ns * b, w["d_latent"])
    x = torch.randn(ns * b, w["d_in"])
    name = next(k for k, v in ROUTED.items() if v is over)
    if name in LAUNCHED:
        hidden, dl, d_in, d_in_pad, groups = LAUNCHED[name]
        assert chain_plan(w["hidden"], w["d_latent"], w["d_in"], w["d_out"]) == (hidden, dl, groups)
        before = ops_resnetfc.resnetfc_fwd.launches
        with torch.no_grad():
            out = m((z, x), combine_inner_dims=(ns, b))
        assert out.shape == (b, w["d_out"])
        args = lib.calls["pnt_resnetfc_fwd"]
        assert lib.launches == ["pnt_resnetfc_fwd"] * groups
        assert ops_resnetfc.resnetfc_fwd.launches == before + groups  # one count a launch
        assert args[18:22] == (dl, d_in, d_in_pad, hidden)  # d_latent, d_in, d_in_pad, hidden
        assert args[22] == min(16, w["d_out"] - 16 * (groups - 1))  # the last group's outputs
        want = x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        assert (lib.xin[:, :w["d_in"]] == want).all() and not lib.xin[:, w["d_in"]:].any()
    else:
        before = (ops_resnetfc.resnetfc_fwd.launches, ops_layer_chain.layer_fwd.launches,
                  ops_layer_chain.view_pool_fwd.launches)
        with torch.no_grad():
            out = m((z, x), combine_inner_dims=(ns, b))
        assert out.shape == (b, w["d_out"])
        assert lib.launches == ["pnt_layer"] * 10 + ["pnt_view_pool_fwd"] + ["pnt_layer"] * 5
        assert (ops_resnetfc.resnetfc_fwd.launches, ops_layer_chain.layer_fwd.launches,
                ops_layer_chain.view_pool_fwd.launches) == (before[0], before[1] + 15, before[2] + 1)


@pytest.mark.parametrize("over", ROUTED.values(), ids=ROUTED.keys())
def test_routed_widths_train_on_the_cpu(over):
    """On the CPU the fused wrappers take their plain versions at every
    width: a forward and backward of each routed width through
    `resnetfc_fused` give finite outputs and a gradient for every
    parameter."""
    w = _widths(**over)
    ns, b = w["ns"], 3
    m = _module(w["hidden"], w["d_latent"], w["d_in"], w["d_out"])
    assert m.fused_ok((ns, b))
    g = torch.Generator().manual_seed(1)
    z = torch.randn(ns * b, w["d_latent"], generator=g)
    x = torch.randn(ns * b, w["d_in"], generator=g)
    out = m((z, x), combine_inner_dims=(ns, b))
    assert out.shape == (b, w["d_out"]) and torch.isfinite(out).all()
    out.float().square().sum().backward()
    for name, p in m.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert m.lin_in.weight.grad.norm() > 0


def test_odd_d_in_backward_launches_even_and_returns_the_callers_widths(monkeypatch):
    """The backward (the ResnetFC's, which the field's shares) launches
    with d_in 40 and hands back dxin and the w_in gradient at d_in 39; the
    field's forward launches with d_in 40."""
    lib = _Lib()
    _card_route(monkeypatch, lib)
    sb, ns, b, hidden, dl, d_in, n_blocks, combine = 1, 2, 5, 64, 64, 39, 5, 3
    k, m = stash_layout(n_blocks, combine, ns)
    t = lambda *shape: torch.zeros(shape)
    w = FieldWeights(
        w_in=t(d_in, hidden), b_in=t(hidden), wz=t(3, dl, hidden), bz=t(3, hidden),
        w0=t(n_blocks, hidden, hidden), b0=t(n_blocks, hidden),
        w1=t(n_blocks, hidden, hidden), b1=t(n_blocks, hidden), w_out=t(hidden, 4), b_out=t(4),
    )
    bf = lambda *shape: t(*shape).to(torch.bfloat16)
    z, xin = bf(sb, ns, b, dl), bf(sb, ns, b, d_in)
    dz, dxin, dw = ops_resnetfc.resnetfc_bwd(
        z, xin, t(sb, b, 4), bf(2 * k, sb, ns, b, hidden), bf(2 * m + 1, sb, b, hidden), w,
        n_blocks, combine, ns)
    dims = ctypes.cast(lib.calls["pnt_resnetfc_bwd"][1], ctypes.POINTER(ctypes.c_int))
    assert (dims[4], dims[5]) == (40, 48)
    assert dxin.shape == xin.shape and dw.w_in.shape == (d_in, hidden) and dz.shape == z.shape
    ops_field.pyramid_field_fused([bf(sb * ns, 4, 4, dl)], t(sb, ns, b, 2), xin, w,
                                  n_blocks, combine, ns)
    assert lib.calls["pnt_field_fwd"][22:24] == (40, 48)


# tests/test_torch_train.py's model with 6 frequencies and no view
# directions: d_in = 3 + 3 * 2 * 6 = 39
CONF_39 = CONF.replace("num_freqs = 2", "num_freqs = 6").replace(
    "use_viewdirs = True", "use_viewdirs = False")


def _jax_kernels_in_interpret_mode(monkeypatch):
    """The JAX package's native-pyramid kernels run only on a TPU: run them
    here in interpret mode, as tests/test_torch_train.py does."""
    import pixelnerf_tpu.models.encoder as jenc
    import pixelnerf_tpu.ops.pyramid_pallas as jpyr

    monkeypatch.setattr(jenc, "pyramid_fused_ok", lambda *a, **k: True)
    single, dual = jpyr.pyramid_index_train, jpyr.pyramid_index_train_dual
    monkeypatch.setattr(jpyr, "pyramid_index_train", lambda f, uv: single(f, uv, True))
    monkeypatch.setattr(jpyr, "pyramid_index_train_dual", lambda f, uv: dual(f, uv, True))


def _fused_calls(monkeypatch):
    """Record the port's fused ResnetFC and field wrappers by name."""
    calls = []
    for mod, names in ((ops_resnetfc, ("resnetfc_fwd", "resnetfc_fwd_stash", "resnetfc_bwd")),
                       (mod_resnetfc, ("pyramid_field_fused",))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name,
                                lambda *a, _f=fn, _n=name, **kw: calls.append(_n) or _f(*a, **kw))
    return calls


def _jax_fused_calls(monkeypatch):
    """Record which of the JAX ResnetFC's Pallas paths each call takes:
    True for the fused MLP, "field" for the fused gather and field."""
    calls = []
    ok, field = JResnetFC._pallas_ok, JResnetFC._call_field
    monkeypatch.setattr(JResnetFC, "_pallas_ok",
                        lambda self, *a: (lambda r: calls.append(r) or r)(ok(self, *a)))
    monkeypatch.setattr(JResnetFC, "_call_field",
                        lambda self, *a: calls.append("field") or field(self, *a))
    return calls


def test_d_in_39_train_step_matches_jax(monkeypatch):
    """One bf16 train step of the d_in-39 model against the JAX step: the
    loss, every gradient, the parameters after Adam and the running
    statistics at tests/test_torch_train.py's bf16 tolerances, with both
    sides on their fused ResnetFC."""
    conf_j, conf_t, jmodel, variables, model, b = _models("bfloat16", conf=CONF_39)
    assert model.d_in == 39 and model.dtype == torch.bfloat16
    _jax_kernels_in_interpret_mode(monkeypatch)
    jcalls, calls = _jax_fused_calls(monkeypatch), _fused_calls(monkeypatch)
    jstate, jaux, jgrads = _jax_step(jmodel, variables, b, JRendererConfig.from_conf(conf_j["renderer"]))
    assert jcalls and all(jcalls)
    _assert_step_matches("bfloat16", model, model, conf_t, variables, b, jstate, jaux, jgrads)
    assert "resnetfc_fwd_stash" in calls and "resnetfc_bwd" in calls


def test_d_in_39_render_matches_jax(monkeypatch):
    """The d_in-39 model's eval render of one object's target rays against
    the JAX `render_full`, both through their fused gather and field: rgb
    and alpha at
    tests/test_torch_slice.py's bf16 tolerance, 5e-2 absolute and 1e-2 on
    average."""
    conf_j, conf_t, jmodel, variables, model, b = _models("bfloat16", conf=CONF_39)
    _jax_kernels_in_interpret_mode(monkeypatch)
    jcalls, calls = _jax_fused_calls(monkeypatch), _fused_calls(monkeypatch)
    images, poses, rays = b["src_images"][0], b["src_poses"][0], b["rays"][0]
    jenc = j_encode_views(jmodel, variables, images, poses, FOCAL)
    want = j_render_full(jmodel, variables, jenc, rays,
                         JRendererConfig.from_conf(conf_j["renderer"]).replace(perturb=0.0), chunk=8)
    model.eval()
    with torch.no_grad():
        enc = encode_views(model, images, poses, FOCAL)
        got = render_full(model, enc, rays, RendererConfig.from_conf(conf_t["renderer"])
                          .replace(perturb=0.0), chunk=8)
    assert jcalls and set(jcalls) == {"field"} and set(calls) == {"pyramid_field_fused"}, calls
    for head in ("coarse", "fine"):
        for key in ("rgb", "alpha"):
            g, wnt = got[head][key].numpy(), np.asarray(want[head][key])
            assert g.shape == wnt.shape and np.isfinite(g).all()
            np.testing.assert_allclose(g, wnt, rtol=0, atol=5e-2)
            assert np.abs(g - wnt).mean() < 1e-2


def _plain_chains(monkeypatch):
    """The card's route with each chain launch replaced by the kernels'
    plain versions at the widths the wrappers launch, which must be
    widths the chains are built for; returns the launches' widths
    (hidden, d_latent, d_out) in order."""
    from pixelnerf_tpu_torch.ops.field import field_bwd_plain, field_plain
    from pixelnerf_tpu_torch.ops.resnetfc import resnetfc_bwd_plain, resnetfc_fwd_plain

    launched = []

    def widths(z_dl, xin, w, ns):
        hidden, d_out = w.w_in.shape[1], w.w_out.shape[1]
        check_chain_widths(hidden, z_dl, xin.shape[-1] + xin.shape[-1] % 2, d_out, ns)
        launched.append((hidden, z_dl, d_out))

    def fwd(z, xin, w, n_blocks, combine, ns, stash):
        widths(z.shape[3], xin, w, ns)
        res = resnetfc_fwd_plain(z, xin, w, n_blocks, combine, ns, stash=stash)
        return res if stash else (res, None, None)

    def bwd(z, xin, g, spre, spost, w, n_blocks, combine, ns, levels, grid):
        widths(z.shape[3], xin, w, ns)
        if levels:
            d_feats, dxin, dw = field_bwd_plain(grid, xin, g, z, spre, spost, w, n_blocks, combine,
                                                ns, levels)
            return [d.float() for d in d_feats], dxin, dw, None
        return (*resnetfc_bwd_plain(z, xin, g, spre, spost, w, n_blocks, combine, ns), None)

    def field(feats, grid, xin, w, n_blocks, combine, ns, stash):
        widths(sum(f.shape[3] for f in feats), xin, w, ns)
        res = field_plain(feats, grid, xin, w, n_blocks, combine, ns, stash=stash)
        return res if stash else (res, None, None, None)

    monkeypatch.setattr(ops_resnetfc, "_device_of", lambda t, what: "cuda")
    monkeypatch.setattr(ops_field, "_device_of", lambda t, what: "cuda")
    monkeypatch.setattr(ops_resnetfc, "_launch_fwd_chain", fwd)
    monkeypatch.setattr(ops_resnetfc, "_launch_bwd_chain", bwd)
    monkeypatch.setattr(ops_field, "_launch_chain", field)
    return launched


# widths off the chains' that the wrappers pad: (hidden, d_latent, d_out)
PADDED = {"hidden 16": (16, 64, 4), "hidden 192": (192, 64, 4), "hidden 384": (384, 64, 4),
          "d_latent 96": (64, 96, 4), "d_out 20": (64, 64, 20)}


def _grad_close(got, want, extra=0.0):
    """tests/test_torch_resnetfc.py's gradient tolerance: 2e-2 of the
    largest magnitude, 1e-2 relative Frobenius, `extra` elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 2e-2 * (np.abs(want).max() + 1e-12) + extra)
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want) + 1e-12


def _numpy_weights(rng, hidden, d_latent, d_out, d_in=42, n_blocks=5, n_inj=3):
    m = lambda shape, fan: rng.normal(size=shape, scale=1.0 / np.sqrt(fan)).astype(np.float32)
    return dict(
        w_in=m((d_in, hidden), d_in), b_in=m((hidden,), 10), wz=m((n_inj, d_latent, hidden), d_latent),
        bz=m((n_inj, hidden), 10), w0=m((n_blocks, hidden, hidden), hidden),
        b0=m((n_blocks, hidden), 10), w1=m((n_blocks, hidden, hidden), hidden),
        b1=m((n_blocks, hidden), 10), w_out=m((hidden, d_out), hidden), b_out=m((d_out,), 10),
    )


def _jax_weights(w):
    from pixelnerf_tpu.ops.resnetfc_pallas import ResnetFCWeights

    return ResnetFCWeights(**{k: jnp.asarray(v[None] if k in ("b_in", "b_out") else v)
                              for k, v in w.items()})


@pytest.mark.parametrize("widths", PADDED.values(), ids=PADDED.keys())
def test_padded_resnetfc_matches_the_pallas_kernel(widths, monkeypatch):
    """The fused ResnetFC through the padded wrappers (forward with stash,
    backward from it) against the Pallas kernel's VJP in interpret mode:
    the output, dz, dxin and every weight gradient at the caller's widths;
    every launch at a chain width, d_out 20 as two runs each way."""
    import jax

    from pixelnerf_tpu.ops.resnetfc_pallas import resnetfc_fused as j_fused
    from pixelnerf_tpu_torch.ops.resnetfc import resnetfc_fused

    hidden, dl, d_out = widths
    sb, ns, b, n_blocks, combine = 1, 2, 21, 5, 3
    rng = np.random.default_rng(hidden + dl + d_out)
    w = _numpy_weights(rng, hidden, dl, d_out)
    z = rng.normal(size=(sb, ns, b, dl)).astype(np.float32)
    xin = rng.normal(size=(sb, ns, b, 42)).astype(np.float32)
    g = rng.normal(size=(sb, b, d_out)).astype(np.float32)
    jfn = lambda zz, xx, ww: j_fused(zz, xx, ww, n_blocks, combine, ns, True)
    jout, vjp = jax.vjp(jfn, jnp.asarray(z, jnp.bfloat16), jnp.asarray(xin, jnp.bfloat16),
                        _jax_weights(w))
    jdz, jdx, jdw = vjp(jnp.asarray(g))

    launched = _plain_chains(monkeypatch)
    tz = torch.from_numpy(z).to(torch.bfloat16).requires_grad_(True)
    tx = torch.from_numpy(xin).to(torch.bfloat16).requires_grad_(True)
    tw = FieldWeights(**{k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()})
    out = resnetfc_fused(tz, tx, tw, n_blocks, combine, ns)
    out.backward(torch.from_numpy(g))
    groups = -(-d_out // 16)
    plan = chain_plan(hidden, dl, 42, d_out)
    assert len(launched) == 2 * groups and {(h, d) for h, d, _ in launched} == {plan[:2]}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=2e-2, atol=2e-2)
    for got, want in ((tz.grad, jdz), (tx.grad, jdx)):
        want = np.asarray(want.astype(jnp.float32))
        _grad_close(got.float(), want, 2.0 ** -7 * np.abs(want))
    for name, p in zip(FieldWeights._fields, tw):
        _grad_close(p.grad, np.asarray(getattr(jdw, name)).reshape(p.shape))


FIELD_PADDED = {"d_latent 96": (32, [(8, 8, 32), (4, 4, 64)], 4),
                "hidden 16": (16, [(8, 8, 32), (4, 4, 32)], 4),
                "d_out 20": (32, [(8, 8, 32), (4, 4, 32)], 20)}


@pytest.mark.parametrize("hidden,levels,d_out", FIELD_PADDED.values(), ids=FIELD_PADDED.keys())
def test_padded_field_matches_pallas_and_plain(hidden, levels, d_out, monkeypatch):
    """The fused field through the padded wrappers: d_latent 96 as 128 on
    32 zero channels of the last level, hidden 16 as 64, d_out 20 as two
    runs. The output, dxin and the weight gradients against the Pallas
    field's VJP in interpret mode; the bf16 level gradients (zero channels
    cut off) against the port's unpadded plain backward, one bf16 ulp of
    their magnitude plus the gradient tolerance."""
    import jax

    from pixelnerf_tpu.ops.field_pallas import pyramid_field_fused as j_field
    from pixelnerf_tpu_torch.ops.field import (
        pyramid_field_fused, pyramid_field_fused_bwd, pyramid_field_fused_fwd_stash,
    )

    sb, ns, b, n_blocks, combine = 1, 2, 24, 5, 3
    dl = sum(c for *_, c in levels)
    rng = np.random.default_rng(dl + hidden + d_out)
    feats = [rng.normal(size=(sb * ns, h, ww, c)).astype(np.float32) for h, ww, c in levels]
    grid = rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)).astype(np.float32)
    xin = rng.normal(size=(sb, ns, b, 42)).astype(np.float32)
    w = _numpy_weights(rng, hidden, dl, d_out)
    g = rng.normal(size=(sb, b, d_out)).astype(np.float32)
    jfn = lambda fs, x, ww: j_field(fs, jnp.asarray(grid), x, ww, n_blocks, combine, ns, True)
    jout, vjp = jax.vjp(jfn, tuple(jnp.asarray(f, jnp.bfloat16) for f in feats),
                        jnp.asarray(xin, jnp.bfloat16), _jax_weights(w))
    _, jdx, jdw = vjp(jnp.asarray(g))

    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    tf, tgrid, tx, tg = [bf(f) for f in feats], torch.from_numpy(grid), bf(xin), torch.from_numpy(g)
    tw = FieldWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    args = (n_blocks, combine, ns)
    want_fwd = pyramid_field_fused_fwd_stash(tf, tgrid, tx, tw, *args)
    want_bwd = pyramid_field_fused_bwd(tgrid, tx, tg, *want_fwd[1:], tw, *args, levels)
    launched = _plain_chains(monkeypatch)
    primal = pyramid_field_fused(tf, tgrid, tx, tw, *args)
    out, zstash, spre, spost = pyramid_field_fused_fwd_stash(tf, tgrid, tx, tw, *args)
    d_feats, dxin, dw = pyramid_field_fused_bwd(tgrid, tx, tg, zstash, spre, spost, tw, *args, levels)
    groups = -(-d_out // 16)
    plan = chain_plan(hidden, dl, 42, d_out)
    assert len(launched) == 3 * groups and {(h, d) for h, d, _ in launched} == {plan[:2]}
    assert zstash.shape[3] == plan[1] and spost.shape[-1] == plan[0]
    assert torch.equal(primal, out)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-2, atol=2e-2)
    jdx = np.asarray(jdx.astype(jnp.float32))
    _grad_close(dxin.float(), jdx, 2.0 ** -7 * np.abs(jdx))
    for name in FieldWeights._fields:
        got = getattr(dw, name)
        assert got.shape == getattr(tw, name).shape, name
        _grad_close(got, np.asarray(getattr(jdw, name)).reshape(got.shape))
    for got, want, (h, ww, c) in zip(d_feats, want_bwd[0], levels):
        assert got.shape == (sb * ns, h, ww, c) and got.dtype == torch.bfloat16
        want = want.float().numpy()
        _grad_close(got.float(), want, 2.0 ** -7 * np.abs(want))


# d_latent 640 (a ResNet-34's 512 and a 128-wide global latent) and 1024
# (five encoder levels): past the z tile the forward chain holds at hidden
# 512, which runs them in bands of 512 columns, and past the backward's
# 512-column g_z pass. The wrappers launch them as they are (multiples of
# 64: no padding); here through the plain versions on the card's route.
WIDE_LATENT = {"d_latent 640": (64, 640, 4), "d_latent 1024": (64, 1024, 4)}
WIDE_FIELD = {"d_latent 640": (32, [(8, 8, 128), (4, 4, 128), (4, 4, 384)], 4),
              "d_latent 1024": (32, [(8, 8, 128), (4, 4, 384), (2, 2, 512)], 4)}


@pytest.mark.parametrize("widths", WIDE_LATENT.values(), ids=WIDE_LATENT.keys())
def test_wide_latent_resnetfc_matches_the_pallas_kernel(widths, monkeypatch):
    test_padded_resnetfc_matches_the_pallas_kernel(widths, monkeypatch)


@pytest.mark.parametrize("hidden,levels,d_out", WIDE_FIELD.values(), ids=WIDE_FIELD.keys())
def test_wide_latent_field_matches_pallas_and_plain(hidden, levels, d_out, monkeypatch):
    test_padded_field_matches_pallas_and_plain(hidden, levels, d_out, monkeypatch)


def _plan_hidden(model):
    mlp = model.mlp_coarse
    return chain_plan(mlp.d_hidden, mlp.d_latent, mlp.d_in, mlp.d_out)[0]


MODEL_HIDDEN = {"hidden 16": 16, "hidden 192": 192, "hidden 384": 384}


@pytest.mark.parametrize("hidden", MODEL_HIDDEN.values(), ids=MODEL_HIDDEN.keys())
def test_padded_model_train_step_matches_jax(hidden, monkeypatch):
    """One bf16 train step of tests/test_torch_train.py's model at hidden
    16, 192 or 384 through the padded wrappers (the chain launches as
    plain versions at hidden 64, 256 and 512) against the JAX step, whose
    fused ResnetFC runs its Pallas kernel in interpret mode, at
    tests/test_torch_train.py's bf16 tolerances."""
    conf = CONF.replace("d_hidden = 32", f"d_hidden = {hidden}")
    conf_j, conf_t, jmodel, variables, model, b = _models("bfloat16", conf=conf)
    assert model.mlp_coarse.d_hidden == hidden
    _jax_kernels_in_interpret_mode(monkeypatch)
    jcalls = _jax_fused_calls(monkeypatch)
    jstate, jaux, jgrads = _jax_step(jmodel, variables, b, JRendererConfig.from_conf(conf_j["renderer"]))
    assert jcalls and all(jcalls)
    launched = _plain_chains(monkeypatch)
    _assert_step_matches("bfloat16", model, model, conf_t, variables, b, jstate, jaux, jgrads)
    assert launched and {h for h, _, _ in launched} == {_plan_hidden(model)}


@pytest.mark.parametrize("hidden", MODEL_HIDDEN.values(), ids=MODEL_HIDDEN.keys())
def test_padded_model_render_matches_jax(hidden, monkeypatch):
    """The same models' eval render of one object's target rays through
    the padded fused field against the JAX `render_full` through its
    Pallas field, at tests/test_torch_slice.py's bf16 tolerance."""
    conf = CONF.replace("d_hidden = 32", f"d_hidden = {hidden}")
    conf_j, conf_t, jmodel, variables, model, b = _models("bfloat16", conf=conf)
    _jax_kernels_in_interpret_mode(monkeypatch)
    jcalls = _jax_fused_calls(monkeypatch)
    images, poses, rays = b["src_images"][0], b["src_poses"][0], b["rays"][0]
    jenc = j_encode_views(jmodel, variables, images, poses, FOCAL)
    want = j_render_full(jmodel, variables, jenc, rays,
                         JRendererConfig.from_conf(conf_j["renderer"]).replace(perturb=0.0), chunk=8)
    launched = _plain_chains(monkeypatch)
    model.eval()
    with torch.no_grad():
        enc = encode_views(model, images, poses, FOCAL)
        got = render_full(model, enc, rays, RendererConfig.from_conf(conf_t["renderer"])
                          .replace(perturb=0.0), chunk=8)
    assert jcalls and set(jcalls) == {"field"}
    assert launched and {h for h, _, _ in launched} == {_plan_hidden(model)}
    for head in ("coarse", "fine"):
        for key in ("rgb", "alpha"):
            g, wnt = got[head][key].numpy(), np.asarray(want[head][key])
            assert g.shape == wnt.shape and np.isfinite(g).all()
            np.testing.assert_allclose(g, wnt, rtol=0, atol=5e-2)
            assert np.abs(g - wnt).mean() < 1e-2
