"""Port parity: one whole bf16 train step through the fused field.

The port's `make_train_step(model.with_field_fusion(), ...)` against JAX
`make_train_step` on `make_model(conf, use_pallas=True)
.clone(use_field_fusion=True)`, on tests/test_torch_train.py's tiny
srn-shaped model, batch and starting weights. With no query cache, each
ray's coarse and fine samples (6, then 6 + 6) go through the fused field
and its VJP: on the JAX side the Pallas kernel in interpret mode, with
the TPU-only `pyramid_fused_ok` patched true as
tests/test_field_pallas.py:240-242 does; on the port's side the plain
versions of the field's stash forward and backward. Both sides are seen
to take the field path. The step is held to tests/test_torch_train.py's
bf16 tolerances: loss 2e-2 relative, each gradient of the heads 5e-2 and
of the encoder 1e-1 in relative Frobenius norm, the parameters after Adam
to what the gradients' difference explains, running statistics 1e-2.
"""

from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.render.renderer import RendererConfig as JRendererConfig
from tests.test_torch_train import _assert_step_matches, _jax_step, _models


def test_fused_field_train_step_matches_jax(monkeypatch):
    import pixelnerf_tpu.models.encoder as jenc
    import pixelnerf_tpu_torch.ops.field as ops_field

    conf_j, conf_t, jmodel, variables, model, b = _models("bfloat16")
    monkeypatch.setattr(jenc, "pyramid_fused_ok", lambda *a, **k: True)
    jcalls, calls = [], []
    orig = JResnetFC._call_field
    monkeypatch.setattr(JResnetFC, "_call_field", lambda self, fi, d: jcalls.append(1) or orig(self, fi, d))
    for name in ("pyramid_field_fused_fwd_stash", "pyramid_field_fused_bwd"):
        fn = getattr(ops_field, name)
        monkeypatch.setattr(ops_field, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))

    jfused = jmodel.clone(use_field_fusion=True)
    assert not jfused.supports_query_cache
    jstate, jaux, jgrads = _jax_step(jfused, variables, b, JRendererConfig.from_conf(conf_j["renderer"]))
    assert jcalls, "the JAX step did not take the fused field path"

    fused = model.with_field_fusion()
    assert not fused.supports_query_cache and not model.use_field_fusion
    _assert_step_matches("bfloat16", model, fused, conf_t, variables, b, jstate, jaux, jgrads)
    # the coarse and the fine query: one stash forward and one backward each
    assert sorted(calls) == ["pyramid_field_fused_bwd"] * 2 + ["pyramid_field_fused_fwd_stash"] * 2


def test_fused_field_eval_step_runs_the_primal(monkeypatch):
    """The eval step of the fused view: eval-mode BatchNorm on the shared
    modules (no statistics move), no gradient, and the field's primal for
    the coarse and the fine query, never its stash forward."""
    import torch

    import pixelnerf_tpu_torch.ops.field as ops_field
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.train.step import make_eval_step
    from tests.test_torch_train import FAR, NEAR, R

    _, conf_t, _, _, model, b = _models("bfloat16")
    calls = []
    for name in ("field_plain", "pyramid_field_fused_fwd_stash"):
        fn = getattr(ops_field, name)
        monkeypatch.setattr(ops_field, name, lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    model.train()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    fused = model.with_field_fusion()
    step = make_eval_step(fused, RendererConfig.from_conf(conf_t["renderer"]), R, NEAR, FAR)
    aux = step({k: torch.from_numpy(v) for k, v in b.items()})
    assert calls == ["field_plain"] * 2
    assert not fused.training and not model.encoder.training
    assert all(torch.isfinite(v) for v in aux.values())
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in sd.items())
