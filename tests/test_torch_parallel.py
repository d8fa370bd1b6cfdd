"""Data and ray parallel training over torch.distributed (`parallel/mesh.py`).

- `parse_mesh_spec` against the JAX function, and the backend rule.
- One sharded train step on gloo ranks spawned on the CPU, against the
  JAX package's `shard_train_step_shmap` on a mesh of the same shape (2
  or 4 of the 8 virtual CPU devices the conftest makes), from the same
  weights and the same injected rays with perturb 0, as
  tests/test_train_parallel.py holds the JAX step:
  - `data:1,rays:2` with the BatchNorm ResNet-18 encoder (both rays
    ranks encode the same objects, so the batch statistics agree);
  - `data:2,rays:2` with the group-norm ConvEncoder (per-sample norm, so
    the step does not depend on how the objects split; train-mode
    BatchNorm over a split data axis is the one deliberate shard-local
    deviation, as in JAX).
  Tolerances: the JAX test's loss rtol 1e-5, and its rtol 2e-3, atol
  1e-4 on the parameters after Adam and the running statistics. Adam's
  first step moves a parameter by lr * g / (|g| + eps), so a gradient
  element near zero whose sign two libraries round apart moves it by up
  to 2 lr the other way: a parameter element outside the JAX tolerance
  must be explained by that, within lr * |u(g) - u(g')| + 1e-6 with u(g)
  = g / (|g| + eps) (tests/test_torch_train.py's bound); and every
  gradient, the JAX step's taken from a transformation that keeps it in
  the optimizer state, is held to a relative Frobenius error of 1e-3
  (tests/test_torch_train.py's float32 bound). The same step is held to
  the port's one-process step on the whole batch in the same way, and
  every rank's state and gradients to rank 0's bit for bit.
- The training CLI with `--mesh data:2` on two gloo ranks: two epochs,
  only rank 0 writes, then `--resume` to a third epoch on both ranks.

Every spawned world meets at a `file://` rendezvous in `tmp_path` and is
waited for at most 120 s (`parallel.launch.run_ranks`), one torch thread
a rank. This module imports no JAX at the top, so that a spawned rank
that imports it by name stays light.
"""

import json
import os

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.convert import params_from_jax, state_dict_from_jax
from pixelnerf_tpu_torch.models.pixelnerf import make_model
from pixelnerf_tpu_torch.parallel import (
    DATA_AXIS, RAYS_AXIS, backend_for, make_mesh, parse_mesh_spec, shard_batch, wrap_pad,
)
from pixelnerf_tpu_torch.parallel.launch import run_ranks
from pixelnerf_tpu_torch.render.renderer import RendererConfig
from pixelnerf_tpu_torch.train.step import make_optimizer, make_train_step
from pixelnerf_tpu_torch.utils.hocon import loads

LR, NEAR, FAR, R = 1e-3, 0.5, 2.0, 32
TIMEOUT = 120.0


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads a test: the suite runs six workers on the CPU's
    cores, and more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

MODEL = """
model {
    use_encoder = True
    use_xyz = True
    use_code = True
    code { num_freqs = 2
           freq_factor = 1.5
           include_input = True }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse { type = resnet
                 n_blocks = 2
                 d_hidden = 16
                 combine_layer = 1
                 combine_type = average }
    mlp_fine { type = resnet
               n_blocks = 2
               d_hidden = 16
               combine_layer = 1
               combine_type = average }
    encoder { %s }
}
"""
BN_CONF = MODEL % "backbone = resnet18\n              pretrained = False\n              num_layers = 2"
CONV_CONF = MODEL % "backbone = custom\n              pretrained = False"


def _rcfg(cls):
    return cls(n_coarse=6, n_fine=4, n_fine_depth=2, perturb=0.0)


def _batch(sb, h, nv=3, ns=2, seed=0):
    """tests/test_train_parallel.py's batch: distinct cameras per view."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (sb, nv, h, h, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (sb, nv, 1, 1))
    poses[..., 2, 3] = 1.3 + 0.2 * np.arange(nv)[None, :]
    poses[..., 0, 3] = 0.1 * np.arange(nv)[None, :]
    return {
        "images": images, "poses": poses,
        "focal": np.full((sb, 2), float(h), np.float32), "c": np.full((sb, 2), h / 2.0, np.float32),
        "src_images": images[:, :ns], "src_poses": poses[:, :ns],
    }


def _port_model(conf, batch, state):
    model = make_model(loads(conf)["model"], device="cpu", train=True)
    model.init_shapes(torch.from_numpy(batch["images"]))
    model.load_state_dict(state)
    return model


def _port_step(conf, batch, state, mesh=None):
    """(aux floats, state_dict) after one port step, on this rank's shard
    with a mesh."""
    model = _port_model(conf, batch, state)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mesh is not None:
        tb = shard_batch(tb, mesh)
    step = make_train_step(model, _rcfg(RendererConfig), make_optimizer(model, LR),
                           R // (mesh.rays if mesh else 1), NEAR, FAR, mesh=mesh)
    aux = step(tb, torch.Generator().manual_seed(7))
    grads = {n: p.grad for n, p in model.named_parameters()}
    return {k: v.item() for k, v in aux.items()}, model.state_dict(), grads


def _rank_step(rank, conf, batch, state, axes):
    return _port_step(conf, batch, state, make_mesh(axes))


def test_parse_mesh_spec_matches_jax():
    from pixelnerf_tpu.parallel.mesh import parse_mesh_spec as j_parse

    for spec, n in (("", 8), ("", 1), ("data:2,rays:4", 8), ("rays:2", 2), ("data:2", 2),
                    ("data:1,rays:2", 2), (" data:2 , rays:2", 4)):
        assert parse_mesh_spec(spec, n) == j_parse(spec, n), spec
    for spec, n in (("data:3,rays:4", 8), ("data:2", 1), ("model:2", 2)):
        with pytest.raises(ValueError):
            j_parse(spec, n)
        with pytest.raises(ValueError):
            parse_mesh_spec(spec, n)
    assert parse_mesh_spec("") == {DATA_AXIS: 1, RAYS_AXIS: 1}  # one process, no group


def test_mesh_indices_and_shards():
    ranks = [make_mesh({DATA_AXIS: 2, RAYS_AXIS: 3}, rank=r) for r in range(6)]
    assert [(m.data_index, m.rays_index) for m in ranks] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    b = {"images": np.arange(3)[:, None], "rays": np.arange(3 * 6).reshape(3, 6, 1), "k": np.ones(2)}
    shards = [shard_batch(b, m) for m in ranks]
    # three objects wrap-pad to four ([0, 1, 2, 0]), two a data index
    assert [s["images"][:, 0].tolist() for s in shards] == [[0, 1]] * 3 + [[2, 0]] * 3
    assert shards[4]["rays"][:, :, 0].tolist() == [[14, 15], [2, 3]]
    assert all(s["k"] is b["k"] for s in shards)
    assert wrap_pad(b, 3) is b
    folded = {m.fold(torch.Generator().manual_seed(5), "cpu").initial_seed() for m in ranks}
    assert len(folded) == 6  # a stream a rank


def test_backend_rule():
    assert backend_for("cuda", 1, 1) == "nccl"
    assert backend_for("cuda", 4, 4) == "nccl"
    assert backend_for("cuda", 2, 1) == "gloo"  # two ranks share the card
    assert backend_for("cuda", 4, 2) == "gloo"
    assert backend_for("cpu", 2, 0) == "gloo"


@pytest.mark.parametrize("conf,sb,h,axes", [
    (BN_CONF, 2, 16, {DATA_AXIS: 1, RAYS_AXIS: 2}),
    (CONV_CONF, 4, 32, {DATA_AXIS: 2, RAYS_AXIS: 2}),
], ids=["bn-data1-rays2", "conv-data2-rays2"])
def test_sharded_step_matches_jax_shmap(conf, sb, h, axes, tmp_path):
    import jax
    import optax

    from pixelnerf_tpu.models.pixelnerf import make_model as j_make_model
    from pixelnerf_tpu.parallel.mesh import make_mesh as j_make_mesh
    from pixelnerf_tpu.parallel.mesh import shard_train_step_shmap
    from pixelnerf_tpu.render.renderer import RendererConfig as JRendererConfig
    from pixelnerf_tpu.train.step import create_train_state
    from pixelnerf_tpu.train.step import make_train_step as j_make_train_step
    from pixelnerf_tpu.train.step import sample_rays as j_sample_rays
    from pixelnerf_tpu.utils.hocon import loads as j_loads
    from tests.test_torch_slice import _random_variables

    batch = _batch(sb, h)
    rays, rgb_gt = j_sample_rays(jax.random.PRNGKey(11), batch["images"], batch["poses"],
                                 batch["focal"], batch["c"], NEAR, FAR, num_rays=R)
    batch["rays"], batch["rgb_gt"] = np.array(rays), np.array(rgb_gt)
    jmodel = j_make_model(j_loads(conf)["model"])
    variables = jmodel.init(jax.random.PRNGKey(0), batch["src_images"], batch["src_poses"],
                            batch["focal"], np.zeros((sb, 4, 3), np.float32),
                            viewdirs=np.zeros((sb, 4, 3), np.float32))
    # every weight random (fc_1 is zero at init, which zeroes fc_0's
    # gradient), the heads' outputs of O(1) with sigma mostly on
    variables = _random_variables({"params": jax.device_get(variables["params"]),
                                   "batch_stats": jax.device_get(variables.get("batch_stats", {}))}, 1)
    for head in ("mlp_coarse", "mlp_fine"):
        lin = variables["params"][head]["lin_out"]
        lin["kernel"] = lin["kernel"] * 0.3
        lin["bias"][3] = 1.0
    n = axes[DATA_AXIS] * axes[RAYS_AXIS]
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jax.numpy.zeros_like, p),
                                        lambda g, _s, p=None: (g, g))
    tx = optax.chain(keep, optax.adam(LR))
    step = j_make_train_step(jmodel, _rcfg(JRendererConfig), tx, num_rays=R // axes[RAYS_AXIS],
                             z_near=NEAR, z_far=FAR, pmean_axes=(DATA_AXIS, RAYS_AXIS))
    run = shard_train_step_shmap(step, j_make_mesh(axes, devices=jax.devices()[:n]))
    jstate, jaux = jax.device_get(run(create_train_state(variables, tx), batch, jax.random.PRNGKey(7)))

    init = state_dict_from_jax(jax.device_get(variables))
    ranks = run_ranks(_rank_step, n, str(tmp_path / "world"), args=(conf, batch, init, axes),
                      timeout=TIMEOUT, threads=1)
    single = _port_step(conf, batch, init)

    aux0, sd0, g0 = ranks[0]
    for aux, sd, g in ranks[1:]:
        assert aux == aux0
        for k, v in sd.items():
            assert torch.equal(v, sd0[k]), k
        for k, v in g.items():
            assert torch.equal(v, g0[k]), k
    want = (jaux, state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats}),
            params_from_jax(jstate.opt_state[0]))
    unit = lambda g: g / (g.abs() + 1e-8)
    for aux_w, sd_w, g_w in (want, single):
        for k in ("rc", "rf", "t"):
            np.testing.assert_allclose(aux0[k], float(aux_w[k]), rtol=1e-5)
        for k, g in g0.items():
            assert (g - g_w[k]).norm() <= 1e-3 * g_w[k].norm(), k
        for k, v in sd0.items():
            close = torch.isclose(v, sd_w[k], rtol=2e-3, atol=1e-4)
            if k in g0:
                close |= (v - sd_w[k]).abs() <= LR * (unit(g0[k]) - unit(g_w[k])).abs() + 1e-6
            assert close.all(), (k, (v - sd_w[k]).abs().max().item())
    # the step moved every parameter
    for k, g in g0.items():
        assert g.norm() > 0 and not torch.equal(sd0[k], init[k]), k


def _rank_cli(rank, argv):
    from pixelnerf_tpu_torch.train.train_pixelnerf import main

    trainer = main(argv, device="cpu")
    return {"sd": trainer.model.state_dict(), "count": trainer.optimizer.count,
            "writes": trainer.is_main}


def test_train_cli_mesh_two_ranks(tmp_path):
    """`--mesh data:2` on two ranks: equal replicated weights, only rank 0
    writes, and `--resume` continues on both."""
    from tests.fixtures import make_srn_dataset
    from tests.test_cli_pipelines import TINY_CONF

    datadir = make_srn_dataset(str(tmp_path), name="balls", n_objs=2, nv=4, H=16)
    conf_path = tmp_path / "tiny.conf"
    conf_path.write_text(TINY_CONF)
    argv = ["-c", str(conf_path), "-D", datadir, "-n", "m2",
            "--logs_path", str(tmp_path / "logs"), "--checkpoints_path", str(tmp_path / "ckpt"),
            "--visual_path", str(tmp_path / "vis"), "-B", "2", "-R", "16", "--mesh", "data:2"]
    first = run_ranks(_rank_cli, 2, str(tmp_path / "w1"), args=(argv + ["--epochs", "2"],),
                      timeout=TIMEOUT, threads=1)
    ckpt_dir = tmp_path / "ckpt" / "m2"
    # 2 training objects over data:2: one a rank, one batch an epoch
    assert [r["count"] for r in first] == [2, 2]
    assert [r["writes"] for r in first] == [True, False]
    for k, v in first[0]["sd"].items():
        assert torch.equal(v, first[1]["sd"][k]), k
        assert torch.isfinite(v).all(), k
    saved = torch.load(ckpt_dir / "pixel_nerf_latest", weights_only=True)
    assert json.load(open(ckpt_dir / "_iter.json")) == {"iter": 2, "epoch": 1}
    assert os.listdir(tmp_path / "vis" / "m2")  # rank 0's visuals

    second = run_ranks(_rank_cli, 2, str(tmp_path / "w2"),
                       args=(argv + ["--epochs", "3", "--resume"],), timeout=TIMEOUT, threads=1)
    # the resume re-runs the epoch it saved in (as the one-process CLI)
    assert [r["count"] for r in second] == [4, 4]
    for k, v in second[0]["sd"].items():
        assert torch.equal(v, second[1]["sd"][k]), k
    assert any(not torch.equal(v, saved[k]) for k, v in second[0]["sd"].items())
    assert json.load(open(ckpt_dir / "_iter.json")) == {"iter": 4, "epoch": 2}
