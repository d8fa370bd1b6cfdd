"""The weight bridge on the trained flagship checkpoint.

`artifacts/srn600_bf16.ckpt` (the flagship srn.conf model, flax msgpack,
bf16 parameters and float32 BatchNorm statistics) is read on the JAX
side, converted with `convert.state_dict_from_jax`, and loaded into the
port; every leaf must be consumed. Trained weights carry non-zero fc_1
and real BatchNorm statistics, which random init does not. The port's
`encode` + `query` on two 32x32 views is then held against JAX's in
float32 (both cast the bf16 leaves up): 1e-4 absolute on sigmoid/relu
outputs, the float32 convolution and product orders of two libraries.
"""

import copy
from pathlib import Path

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.models.pixelnerf import make_model as j_make_model
from pixelnerf_tpu.utils.hocon import load as j_load
from pixelnerf_tpu_torch.convert import params_from_jax, state_dict_from_jax
from pixelnerf_tpu_torch.models.pixelnerf import make_model
from pixelnerf_tpu_torch.utils.hocon import load

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "artifacts" / "srn600_bf16.ckpt"
CONF = ROOT / "conf" / "exp" / "srn.conf"


@pytest.fixture(scope="module")
def trained():
    tree = flax.serialization.msgpack_restore(CKPT.read_bytes())
    variables = {
        c: _map(tree[c], lambda a: np.asarray(a).astype(np.float32))
        for c in ("params", "batch_stats")
    }
    model = make_model(load(str(CONF))["model"], dtype=torch.float32, device="cpu")
    sd = state_dict_from_jax(variables, model)
    model.load_state_dict(sd, strict=True)
    return variables, model, sd


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _count(tree):
    return sum(_count(v) if isinstance(v, dict) else 1 for v in tree.values())


def test_every_leaf_is_consumed(trained):
    variables, model, sd = trained
    # BatchNorm: scale, bias, mean, var -> 4 entries from 4 leaves; a
    # Dense/Conv kernel or bias is one entry each
    assert len(sd) == _count(variables["params"]) + _count(variables["batch_stats"])
    assert set(sd) == set(model.state_dict())
    fc1 = model.mlp_coarse.block_0.fc_1.weight
    assert fc1.abs().max() > 0  # trained fc_1 is not the zero init


def test_unused_or_missing_leaves_raise(trained):
    variables, model, _ = trained
    extra = copy.deepcopy(variables)
    extra["params"]["mlp_fine"]["lin_z_9"] = {"kernel": np.zeros((512, 512), np.float32)}
    with pytest.raises(ValueError):
        state_dict_from_jax(extra, model)
    missing = copy.deepcopy(variables)
    del missing["params"]["mlp_coarse"]["lin_out"]
    with pytest.raises(ValueError):
        state_dict_from_jax(missing, model)
    stray_stat = copy.deepcopy(variables)
    stray_stat["batch_stats"]["encoder"]["model"]["bn_x"] = {"mean": np.zeros(3, np.float32)}
    with pytest.raises(ValueError):
        state_dict_from_jax(stray_stat, model)


def test_encode_query_match_jax_on_trained_weights(trained):
    variables, model, _ = trained
    jmodel = j_make_model(j_load(str(CONF))["model"], dtype=jnp.float32)
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, size=(1, 2, 32, 32, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    poses[0, :, 2, 3] = 1.3
    poses[0, 1, 0, 3] = 0.3
    xyz = rng.uniform(-0.4, 0.4, size=(1, 64, 3)).astype(np.float32)
    vd = rng.normal(size=(1, 64, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    focal = 35.0

    jvars = {c: _map(variables[c], jnp.asarray) for c in variables}
    jenc = jmodel.apply(
        jvars, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(focal),
        method=jmodel.encode,
    )
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(images), torch.from_numpy(poses), focal)
        for coarse in (True, False):
            want = np.asarray(jmodel.apply(
                jvars, jenc, jnp.asarray(xyz), viewdirs=jnp.asarray(vd),
                coarse=coarse, method=jmodel.query,
            ))
            got = model.query(enc, torch.from_numpy(xyz), torch.from_numpy(vd), coarse)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
            assert want[..., 3].max() > 0  # some density


def test_params_from_jax_names_the_flagship_tree(trained):
    """A params-shaped tree (here the flagship's parameters standing in
    for a gradient tree of the same shapes) maps onto exactly the port's
    parameter names, in the port's orientation; a wrong tree raises."""
    variables, model, sd = trained
    named = params_from_jax(variables["params"], model)
    assert set(named) == {n for n, _ in model.named_parameters()}
    for n, t in named.items():
        assert torch.equal(t, sd[n]), n
    assert named["mlp_coarse.lin_in.weight"].shape == (512, 42)  # (out, in)
    assert named["encoder.model.conv1.weight"].shape == (64, 3, 7, 7)  # OIHW
    bad = copy.deepcopy(variables["params"])
    bad["mlp_fine"]["lin_out"]["kernel"] = np.zeros((4, 512), np.float32)
    with pytest.raises(ValueError):
        params_from_jax(bad, model)
    del bad["mlp_fine"]["lin_out"]
    with pytest.raises(ValueError):
        params_from_jax(bad, model)
