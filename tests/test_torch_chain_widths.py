"""The widths of the card's block chains, and a bf16 model without view
directions (d_in 39) held against the JAX package.

The port's ResnetFC routes as the JAX package's `_pallas_ok`: every bf16
model the TPU predicate (`supported_config`) takes goes to the fused
wrappers, on the card as on the CPU. There `chain_widths_ok` is the one
predicate of the widths the chains take. An odd d_in is given a zero
column (`even_d_in`) and launches; a hidden width, d_latent, d_out or
view count the chains lack raises in the wrapper (`check_chain_widths`)
instead of running a plain version on the card.

The card's route is shown here with the wrappers' device test answering
"cuda" for CPU tensors and a stand-in for the kernels' libraries that
records each launch's arguments and runs nothing. On the CPU every one
of those widths trains through the plain versions. The d_in-39 model's
train step and render go through the kernels' plain versions on the CPU
and are held against the JAX model, whose fused ResnetFC runs its Pallas
kernel in interpret mode, at tests/test_torch_train.py's and
tests/test_torch_slice.py's bf16 tolerances.
"""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pixelnerf_tpu_torch.models.resnetfc as mod_resnetfc
import pixelnerf_tpu_torch.ops.field as ops_field
import pixelnerf_tpu_torch.ops.resnetfc as ops_resnetfc
from pixelnerf_tpu.eval.common import encode_views as j_encode_views
from pixelnerf_tpu.eval.render_utils import render_full as j_render_full
from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.render.renderer import RendererConfig as JRendererConfig
from pixelnerf_tpu_torch.eval.common import encode_views
from pixelnerf_tpu_torch.eval.render_utils import render_full
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.ops.resnetfc import (
    FieldWeights, chain_widths_ok, check_chain_widths, even_d_in, stash_layout,
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
# the widths the card routes: d_in 39 (bf16 without view directions) and the above
ROUTED = {"d_in 39": dict(d_in=39), **OFF_WIDTHS}


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
    """A stand-in for a kernel library: shared-memory sizes and the
    weight-gradient workspace are 0, and each launch records its
    arguments and succeeds without running. The ResnetFC forward's launch
    also copies the positional code's bytes as its kernel would read them."""

    def __init__(self):
        self.calls = {}
        self.xin = None

    def __getattr__(self, name):
        if name.endswith("_smem_bytes"):
            return lambda *a: 0
        if name == "pnt_wgrad_workspace":
            return lambda dims, info: 0

        def launch(*args):
            self.calls[name] = args
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
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


def _module(hidden, d_latent, d_in, d_out, device="cpu"):
    return ResnetFC(d_in, d_out, n_blocks=5, d_latent=d_latent, d_hidden=hidden,
                    combine_layer=3, dtype=torch.bfloat16).to(device)


@pytest.mark.parametrize("over", ROUTED.values(), ids=ROUTED.keys())
def test_the_card_routes_as_the_jax_package_and_never_to_a_plain_version(over, monkeypatch):
    """Each width goes to the fused wrapper exactly where the JAX package's
    `_pallas_ok` takes its Pallas kernel. There d_in 39 launches the
    forward with d_in 40 (`even_d_in`); the other widths raise."""
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
    if chain_widths_ok(**dict(w, d_in=w["d_in"] + w["d_in"] % 2)):  # as `even_d_in` pads
        with torch.no_grad():
            m((z, x), combine_inner_dims=(ns, b))
        args = lib.calls["pnt_resnetfc_fwd"]
        assert args[19:21] == (40, 48)  # d_in, d_in_pad
        want = x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        assert (lib.xin[:, :39] == want).all() and not lib.xin[:, 39].any()
    else:
        with torch.no_grad(), pytest.raises(ValueError, match="chain kernels take"):
            m((z, x), combine_inner_dims=(ns, b))
        assert not lib.calls


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
