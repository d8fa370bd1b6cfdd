"""Port parity: one whole bf16 train step with nearest upsampling.

tests/test_torch_train.py's tiny srn-shaped model with the reference's
`encoder.upsample_interp = nearest`: the packed level and the composed
pyramid are upsampled by selection (`resize_nearest`), the native-pyramid
path is off, and `encode` composes one 16x16x256 bf16 map, which the
lookups sample through `grid_sample_border_train` (the bilerp gather
forward, its scatter backward). The port's `make_train_step` is held
against JAX `make_train_step`, whose single-map lookup takes that path
only on a TPU: here the test patches the JAX encoder's lookup to call
`grid_sample_border_train(latent, grid, True)` (the Pallas kernels in
interpret mode), as tests/test_torch_train.py:369-380 patches the pyramid
lookup. Both sides are seen to take the path, and the port's parameter
tree converts from JAX's unchanged. The step is held to
tests/test_torch_train.py's bf16 tolerances: loss 2e-2 relative, each
gradient of the heads 5e-2 and of the encoder 1e-1 in relative Frobenius
norm, the parameters after Adam to what the gradients' difference
explains, running statistics 1e-2.
"""

from pixelnerf_tpu.render.renderer import RendererConfig as JRendererConfig
from tests.test_torch_train import CONF, _assert_step_matches, _jax_step, _models

NEAREST_CONF = CONF.replace("num_layers = 3", "num_layers = 3\n        upsample_interp = nearest")


def test_nearest_upsampling_train_step_matches_jax(monkeypatch):
    import pixelnerf_tpu.models.encoder as jenc
    import pixelnerf_tpu.ops.scatter_pallas as jsca
    import pixelnerf_tpu_torch.models.encoder as tenc

    assert NEAREST_CONF != CONF
    conf_j, conf_t, jmodel, variables, model, b = _models("bfloat16", conf=NEAREST_CONF)
    assert model.encoder.upsample_interp == "nearest"
    jcalls, calls = [], []

    def j_lookup(latent, grid, **kw):
        jcalls.append(latent.shape)
        return jsca.grid_sample_border_train(latent, grid, True)

    monkeypatch.setattr(jenc, "grid_sample_2d", j_lookup)
    orig = tenc.grid_sample_border_train
    monkeypatch.setattr(tenc, "grid_sample_border_train", lambda *a: calls.append(a[0].shape) or orig(*a))

    jstate, jaux, jgrads = _jax_step(jmodel, variables, b, JRendererConfig.from_conf(conf_j["renderer"]))
    _assert_step_matches("bfloat16", model, model, conf_t, variables, b, jstate, jaux, jgrads)
    # the coarse (dual) lookup and the fine pass's new samples, on one
    # composed (SB*NS, 16, 16, 256) map
    assert len(calls) == 2 and all(tuple(s) == (4, 16, 16, 256) for s in calls)
    assert jcalls and all(tuple(s) == (4, 16, 16, 256) for s in jcalls)
