"""Rematerialization in the port's train step (`make_train_step(remat=...)`).

- remat=True against remat=False, bit for bit on the CPU (the plain
  versions of the kernels are deterministic, and a rematerialized query
  recomputes exactly what the first forward computed): the losses, every
  gradient, the parameters after Adam and the running statistics, at
  n_fine 0 (the renderer's 3-arg query) and 4 with the query cache (the
  5-arg form), float32 and bf16, the fused field (`with_field_fusion`) and
  a frozen encoder. The bf16 runs also count the kernel routes: under
  remat each MLP call runs the stash-free primal in the forward, then the
  stash forward and the backward inside the backward.
- The port's remat step against the JAX package's remat step
  (`jax.checkpoint` of the query) on the same weights and injected rays:
  tests/test_torch_train.py's float32 step, where `auto` rematerializes on
  both sides (loss 1e-5 relative, each gradient 1e-3 relative Frobenius).
- remat="auto" against the JAX package's `_model_uses_fused_mlp` on every
  shipped config, on the CPU. The JAX rule reads the Pallas routing, which
  is backend dependent under use_pallas="auto"; the JAX models here are
  built with use_pallas=True, the routing a TPU gives them. On the CPU
  the port's "auto" keeps a float32 model on the exact per-layer chain,
  as the JAX package's "auto" does off its TPU, so it rematerializes
  there; on the card a float32 model takes the kernels and keeps its
  stash, as on a TPU (the card's rule against JAX's:
  tests/test_torch_float32_kernels.py).
"""

import copy
import glob
import os

import pytest
import torch

from pixelnerf_tpu_torch.models.pixelnerf import make_model
from pixelnerf_tpu_torch.render.renderer import RendererConfig
from pixelnerf_tpu_torch.train.step import _model_uses_fused_mlp, make_optimizer, make_train_step
from pixelnerf_tpu_torch.utils.hocon import load
from tests.test_torch_train import CONF, FAR, NEAR, R, _models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads a test: the suite runs six workers on the CPU's
    cores, and more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _step_once(model, fused, rcfg, b, remat):
    m = copy.deepcopy(model)
    s = m.with_field_fusion() if fused else m
    step = make_train_step(s, rcfg, make_optimizer(m, 1e-3), R, NEAR, FAR, remat=remat)
    aux = step({k: torch.from_numpy(v) for k, v in b.items()})
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    return aux, grads, {k: v.clone() for k, v in m.state_dict().items()}


def _route_counter(monkeypatch):
    import pixelnerf_tpu_torch.ops.field as ops_field
    import pixelnerf_tpu_torch.ops.resnetfc as ops_resnetfc

    calls = []
    for mod, name in ((ops_resnetfc, "resnetfc_fwd"), (ops_resnetfc, "resnetfc_fwd_stash"),
                      (ops_resnetfc, "resnetfc_bwd"), (ops_field, "pyramid_field_fused_bwd")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))
    # the field's primal and stash forwards, on the CPU
    orig = ops_field.field_plain
    monkeypatch.setattr(ops_field, "field_plain", lambda *a, stash=False: calls.append(
        "field_stash" if stash else "field_primal") or orig(*a, stash=stash))
    return calls


@pytest.mark.parametrize("n_fine", [0, 4])
@pytest.mark.parametrize("variant", ["float32", "bfloat16", "fused", "frozen"])
def test_remat_step_matches_plain(variant, n_fine, monkeypatch):
    dtype = "float32" if variant == "float32" else "bfloat16"
    _, conf_t, _, _, model, b = _models(dtype)
    model.stop_encoder_grad = variant == "frozen"
    rcfg = RendererConfig.from_conf(conf_t["renderer"]).replace(
        n_fine=n_fine, n_fine_depth=min(n_fine, 2))
    calls = _route_counter(monkeypatch)
    plain = _step_once(model, variant == "fused", rcfg, b, remat=False)
    plain_calls, calls[:] = list(calls), []
    remat = _step_once(model, variant == "fused", rcfg, b, remat=True)

    assert set(plain[0]) == set(remat[0])
    for k in plain[0]:
        assert torch.equal(plain[0][k], remat[0][k]), k
    for n, g in plain[1].items():
        assert torch.equal(g, remat[1][n]), n
        if variant == "frozen" and n.startswith("encoder"):
            assert g.norm() == 0, n  # no gradient: the update's zeros
        else:
            assert g.norm() > 0 or (n_fine == 0 and n.startswith("mlp_fine")), n
    for k, v in plain[2].items():
        assert torch.equal(v, remat[2][k]), k

    # MLP calls: coarse, then fine on [cached | new] rows (the cached path)
    # or on the sorted samples (the fused field, which caches nothing)
    n_mlp = 1 + (n_fine > 0) * (1 if variant == "fused" else 2)
    if variant == "float32":
        assert plain_calls == calls == []
    elif variant == "fused":
        assert sorted(plain_calls) == sorted(["field_stash", "pyramid_field_fused_bwd"] * n_mlp)
        assert sorted(calls) == sorted(["field_primal", "field_stash", "pyramid_field_fused_bwd"] * n_mlp)
        assert calls[:n_mlp] == ["field_primal"] * n_mlp
    else:
        assert sorted(plain_calls) == sorted(["resnetfc_fwd_stash", "resnetfc_bwd"] * n_mlp)
        assert sorted(calls) == sorted(["resnetfc_fwd", "resnetfc_fwd_stash", "resnetfc_bwd"] * n_mlp)
        assert calls[:n_mlp] == ["resnetfc_fwd"] * n_mlp  # every primal runs before any stash


def test_float32_parity_step_is_a_remat_step():
    """tests/test_torch_train.py::test_train_step_matches_jax[float32] holds
    the port's remat step against JAX's: its float32 model leaves the
    fused kernels on both sides, so both steps' remat="auto" rematerializes
    (JAX's `jax.checkpoint` of the query, the port's reentrant checkpoint)."""
    from pixelnerf_tpu.train.step import _model_uses_fused_mlp as j_uses_fused

    _, _, jmodel, _, model, _ = _models("float32")
    assert not j_uses_fused(jmodel) and not _model_uses_fused_mlp(model)


CONFS = sorted(glob.glob(os.path.join(ROOT, "conf", "exp", "*.conf"))) + [
    os.path.join(ROOT, "conf", "default.conf"), os.path.join(ROOT, "conf", "default_mv.conf")]


@pytest.mark.parametrize("path", CONFS, ids=os.path.basename)
def test_auto_rule_matches_jax(path):
    from pixelnerf_tpu.models.pixelnerf import make_model as j_make_model
    from pixelnerf_tpu.train.step import _model_uses_fused_mlp as j_uses_fused
    from pixelnerf_tpu.utils.hocon import load as j_load

    conf = load(path)["model"]
    jmodel = j_make_model(j_load(path)["model"], use_pallas=True)
    model = make_model(conf, device="cpu")
    bf16 = conf.get_string("dtype", "float32") == "bfloat16"
    for nviews in (None, 1, 2, 3):
        want = j_uses_fused(jmodel, max_nviews=nviews)
        assert _model_uses_fused_mlp(model, nviews) == (want and bf16), nviews
    name = os.path.basename(path)
    if name in ("srn.conf", "srn_long.conf", "srn600.conf", "dtu.conf"):
        assert _model_uses_fused_mlp(model, 2)  # the flagship keeps its stash
    if name in ("sn64.conf", "sn64_unseen.conf", "pollen.conf", "multi_obj.conf"):
        assert not _model_uses_fused_mlp(model, 2)  # float32: remat on


def test_auto_rule_follows_the_mlp():
    """A bf16 model leaves the kernels (and gets remat) with softplus, and
    for one source view with the pooling past the last block."""
    from pixelnerf_tpu_torch.utils.hocon import loads

    base = CONF.replace("model {", "model {\n    dtype = bfloat16", 1)
    assert _model_uses_fused_mlp(make_model(loads(base)["model"], device="cpu"), 2)
    soft = base.replace("combine_layer = 2\n    }\n    mlp_fine", "combine_layer = 2\n        beta = 2.0\n    }\n    mlp_fine")
    assert not _model_uses_fused_mlp(make_model(loads(soft)["model"], device="cpu"), 2)
    late = base.replace("combine_layer = 2", "combine_layer = 5")
    m = make_model(loads(late)["model"], device="cpu")
    assert _model_uses_fused_mlp(m, 1) and not _model_uses_fused_mlp(m, 2)
    assert not _model_uses_fused_mlp(m, None)
