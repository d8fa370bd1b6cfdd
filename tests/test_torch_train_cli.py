"""Port parity: the training CLI and what it adds to the train step.

- `parse_args` against the JAX one on the same argv;
- `RendererConfig.at_iteration` on a three-stage sample-count schedule;
- `MultiSteps` (the lr schedule and gradient accumulation) against
  `optax.MultiSteps(optax.adam(schedule), k)`, and a frozen-then-unfrozen
  parameter against `optax.adam` fed zeros and then gradients, to 1e-6;
- `make_train_step`'s accumulation and frozen-encoder gradients on a model;
- the torch checkpoints: bit-exact round trips, the backup, the init rule;
  a JAX checkpoint reads, and one that does not fit the model raises;
- `main(argv, device="cpu")` end to end on tests/test_cli_pipelines.py's
  tiny conf and fixture data: two epochs, then a resume to a third, with
  the resumed state equal bit for bit to the saved one;
- the two flags once unported (`--mesh`, `--remat`), and no GPU with no device.
"""

import json
import os

import numpy as np
import optax
import pytest
import torch
import jax.numpy as jnp

from pixelnerf_tpu.render.renderer import RendererConfig as JRendererConfig
from pixelnerf_tpu.train import train_pixelnerf as jcli
from pixelnerf_tpu.utils import config as jconfig
from pixelnerf_tpu_torch.render.renderer import RendererConfig
from pixelnerf_tpu_torch.train import train_pixelnerf as tcli
from pixelnerf_tpu_torch.train.step import MultiSteps, make_optimizer, make_train_step
from pixelnerf_tpu_torch.utils import checkpoint as ckpt
from pixelnerf_tpu_torch.utils import config as tconfig
from pixelnerf_tpu_torch.utils.hocon import loads
from tests.fixtures import make_srn_dataset
from tests.test_cli_pipelines import TINY_CONF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    datadir = make_srn_dataset(str(root), name="balls", n_objs=2, nv=4, H=16)
    conf_path = root / "tiny.conf"
    conf_path.write_text(TINY_CONF)
    return {"root": str(root), "datadir": datadir, "conf": str(conf_path)}


def _common_args(ws, name):
    return [
        "-c", ws["conf"], "-D", ws["datadir"], "-n", name,
        "--logs_path", os.path.join(ws["root"], "logs"),
        "--checkpoints_path", os.path.join(ws["root"], "ckpt"),
        "--visual_path", os.path.join(ws["root"], "vis"),
    ]


@pytest.mark.parametrize("extra", [
    [],
    ["-V", "1 2", "-B", "3", "-R", "64", "--epochs", "5", "--gamma", "0.9",
     "--gamma_delay", "2", "--resume", "--freeze_enc", "--warmup_epochs", "1",
     "--no_bbox_step", "7", "--vis_debug", "--cache_images", "--no_compact_transfer",
     "--image_size", "16", "16", "--fixed_test", "--spmd_mode", "gspmd", "-G", "grp"],
])
def test_parse_args_matches_jax(workspace, extra):
    argv = _common_args(workspace, "p1") + extra
    jargs, jconf = jconfig.parse_args(jcli.extra_args, training=True,
                                      default_ray_batch_size=128, argv=argv)
    targs, tconf = tconfig.parse_args(tcli.extra_args, training=True,
                                      default_ray_batch_size=128, argv=argv)
    assert vars(targs) == vars(jargs)
    assert tconf == jconf
    assert tconfig.PROJECT_ROOT == jconfig.PROJECT_ROOT == ROOT


def test_parse_args_expconf_and_default_conf(workspace, tmp_path):
    """No -c: the conf comes from expconf.conf by experiment name, found
    under the project root from any working directory."""
    argv = ["-n", "srn_car", "-D", workspace["datadir"], "--checkpoints_path",
            str(tmp_path / "c"), "--visual_path", str(tmp_path / "v")]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        jargs, jconf = jconfig.parse_args(jcli.extra_args, training=True, argv=argv)
        targs, tconf = tconfig.parse_args(tcli.extra_args, training=True, argv=argv)
    finally:
        os.chdir(cwd)
    assert vars(targs) == vars(jargs) and targs.conf == "conf/exp/srn.conf"
    assert tconf == jconf and tconf.get_string("model.dtype") == "bfloat16"


def test_debug_nans_turns_on_anomaly_detection(workspace):
    assert not torch.is_anomaly_enabled()
    try:
        tconfig.parse_args(tcli.extra_args, training=True,
                           argv=_common_args(workspace, "p2") + ["--debug_nans"])
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


SCHED_CONF = """
renderer {
    n_coarse = 64
    n_fine = 32
    sched = [[0, 5, 12], [16, 32, 64], [8, 16, 32]]
}
"""


def test_at_iteration_matches_jax():
    got = RendererConfig.from_conf(loads(SCHED_CONF)["renderer"])
    want = JRendererConfig.from_conf(loads(SCHED_CONF)["renderer"])
    assert got.sched == want.sched
    seen = set()
    for it in range(16):
        g, w = got.at_iteration(it), want.at_iteration(it)
        assert (g.n_coarse, g.n_fine) == (w.n_coarse, w.n_fine)
        seen.add(g.n_coarse)
    assert seen == {16, 32, 64}
    assert RendererConfig().at_iteration(7) == RendererConfig()


def _optax_schedule(lr, gamma, gamma_delay, steps_per_epoch):
    """train_pixelnerf.py's optax schedule (pixelnerf_tpu/train/
    train_pixelnerf.py:216-224)."""

    def schedule(step):
        epoch = step // steps_per_epoch
        if gamma == 1.0:
            return lr
        return lr * (gamma ** jnp.maximum(epoch - gamma_delay, 0))

    return schedule


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("gamma,gamma_delay", [(0.5, 1), (1.0, 0), (0.8, 0)])
def test_lr_and_accumulation_match_optax(k, gamma, gamma_delay):
    """One parameter, fixed gradients over N mini-steps: the CLI's schedule
    through MultiSteps against optax.MultiSteps(optax.adam(schedule), k)."""
    rng = np.random.default_rng(k)
    lr, spe, n = 1e-2, 2, 24
    grads = rng.normal(size=(n, 5)).astype(np.float32)
    p0 = rng.normal(size=5).astype(np.float32)

    tx = optax.adam(_optax_schedule(lr, gamma, gamma_delay, spe))
    if k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=k)
    jp = jnp.asarray(p0)
    jstate = tx.init(jp)

    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = MultiSteps(torch.optim.Adam([p], lr=lr, betas=(0.9, 0.999), eps=1e-8), k,
                     tcli.lr_schedule(lr, gamma, gamma_delay, spe))
    moved = []
    for i in range(n):
        updates, jstate = tx.update(jnp.asarray(grads[i]), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        before = p.detach().clone()
        p.grad = torch.from_numpy(grads[i].copy())
        stepped = opt.update()
        assert stepped == ((i + 1) % k == 0)
        moved.append(not torch.equal(before, p.detach()))
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    assert moved == [(i + 1) % k == 0 for i in range(n)]
    assert opt.count == n // k
    # the schedule decays where the optimizer's own count says
    if gamma != 1.0:
        assert opt.lr() == pytest.approx(lr * gamma ** max(opt.count // spe - gamma_delay, 0))


def test_frozen_then_unfrozen_adam_matches_optax():
    """A parameter without gradients (None) for its first steps gets zeros:
    its moments decay and its count advances with the others', as optax.adam
    fed zeros does. torch.optim.Adam on its own would skip it, and its
    first real update would differ by the bias correction."""
    rng = np.random.default_rng(5)
    n, frozen = 8, 4
    g_enc = rng.normal(size=(n, 3)).astype(np.float32)
    g_head = rng.normal(size=(n, 2)).astype(np.float32)
    g_enc[:frozen] = 0.0
    init = {"enc": rng.normal(size=3).astype(np.float32), "head": rng.normal(size=2).astype(np.float32)}

    tx = optax.adam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jp)
    enc, head = (torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in ("enc", "head"))
    opt = MultiSteps(torch.optim.Adam([enc, head], lr=1e-2, betas=(0.9, 0.999), eps=1e-8))
    plain_enc = torch.nn.Parameter(torch.from_numpy(init["enc"].copy()))
    plain = torch.optim.Adam([plain_enc], lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    for i in range(n):
        updates, jstate = tx.update({"enc": jnp.asarray(g_enc[i]), "head": jnp.asarray(g_head[i])},
                                    jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        enc.grad = None if i < frozen else torch.from_numpy(g_enc[i].copy())
        head.grad = torch.from_numpy(g_head[i].copy())
        opt.update()
        plain.zero_grad(set_to_none=True)
        plain_enc.grad = None if i < frozen else torch.from_numpy(g_enc[i].copy())
        plain.step()
        for name, t in (("enc", enc), ("head", head)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[name]), rtol=0, atol=1e-6)
    assert int(opt.optimizer.state[enc]["step"]) == int(opt.optimizer.state[head]["step"]) == n
    # trap 1: skipping the frozen steps gives another update
    assert np.abs(plain_enc.detach().numpy() - np.asarray(jp["enc"])).max() > 1e-4


def _tiny_step_inputs(stop_encoder_grad=False):
    from pixelnerf_tpu_torch.models.pixelnerf import make_model

    conf = loads(TINY_CONF)
    model = make_model(conf["model"], device="cpu", train=True, stop_encoder_grad=stop_encoder_grad)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 16, 16, 3)).astype(np.float32))
    poses = torch.eye(4).repeat(2, 3, 1, 1)
    poses[..., 2, 3] = 1.3
    batch = {
        "images": images, "poses": poses, "focal": torch.full((2, 2), 16.0),
        "c": torch.full((2, 2), 8.0), "src_images": images[:, :2], "src_poses": poses[:, :2],
    }
    return conf, model, batch


def test_train_step_accumulates_every_third_call():
    """A MultiSteps of every_k=3 (train.accu_grad = 3): the parameters move
    on every third call only, the BatchNorm statistics on every call."""
    conf, model, batch = _tiny_step_inputs()
    step = make_train_step(model, RendererConfig.from_conf(conf["renderer"]),
                           MultiSteps(make_optimizer(model, 1e-3), 3), 16, 0.8, 1.8)
    gen = torch.Generator().manual_seed(0)
    for call in range(6):
        params = [p.detach().clone() for p in model.parameters()]
        stats = [b.detach().clone() for b in model.buffers() if b.dtype.is_floating_point]
        aux = step(batch, gen)
        assert torch.isfinite(aux["t"])
        moved = any(not torch.equal(a, p) for a, p in zip(params, model.parameters()))
        assert moved == (call % 3 == 2), call
        floats = [b for b in model.buffers() if b.dtype.is_floating_point]
        assert any(not torch.equal(a, b) for a, b in zip(stats, floats)), call


def test_train_step_gives_the_frozen_encoder_zero_gradients():
    """stop_encoder_grad: the encoder's gradients are zeros, not None, and
    its Adam count advances with the heads'."""
    conf, model, batch = _tiny_step_inputs(stop_encoder_grad=True)
    optimizer = make_optimizer(model, 1e-3)
    step = make_train_step(model, RendererConfig.from_conf(conf["renderer"]), optimizer,
                           16, 0.8, 1.8)
    for _ in range(2):
        step(batch)
    enc = model.encoder.model.conv1.weight
    assert enc.grad is not None and not enc.grad.any()
    head = model.mlp_coarse.lin_in.weight
    assert head.grad.norm() > 0
    assert int(optimizer.state[enc]["step"]) == int(optimizer.state[head]["step"]) == 2


def _state_equal(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_checkpoint_round_trip(tmp_path):
    """Model and optimizer state round-trip bit for bit, an open
    accumulation window included; the backup appears on the second save
    and holds the first; init is read when not resuming."""
    from pixelnerf_tpu_torch.models.pixelnerf import make_model

    conf, model, batch = _tiny_step_inputs()
    opt = MultiSteps(make_optimizer(model, 1e-3), 2)
    step = make_train_step(model, RendererConfig.from_conf(conf["renderer"]), opt, 16, 0.8, 1.8)
    for _ in range(3):
        step(batch)
    assert opt.mini_step == 1
    cp = str(tmp_path)
    path = ckpt.save_model_weights(model, cp, "exp")
    assert not os.path.exists(os.path.join(cp, "exp", "pixel_nerf_backup"))
    first = {k: v.clone() for k, v in model.state_dict().items()}
    ckpt.save_state(os.path.join(cp, "exp", "_optim"), opt.state_dict())
    step(batch)
    ckpt.save_model_weights(model, cp, "exp")
    backup = ckpt.load_state(os.path.join(cp, "exp", "pixel_nerf_backup"))
    assert _state_equal(backup, first)
    assert not any(f.endswith(".tmp") for f in os.listdir(os.path.join(cp, "exp")))

    fresh = make_model(conf["model"], device="cpu", seed=1)
    assert ckpt.load_model_weights(fresh, cp, "exp", resume=True) == path
    assert _state_equal(fresh.state_dict(), model.state_dict())
    fresh_opt = MultiSteps(make_optimizer(fresh, 1e-3), 2)
    fresh_opt.load_state_dict(ckpt.load_state(os.path.join(cp, "exp", "_optim")))
    saved = ckpt.load_state(os.path.join(cp, "exp", "_optim"))
    assert _state_equal(fresh_opt.state_dict(), saved) and fresh_opt.mini_step == 1

    # not resuming: only pixel_nerf_init is read
    other = make_model(conf["model"], device="cpu", seed=2)
    assert ckpt.load_model_weights(other, cp, "exp", resume=False) is None
    ckpt.save_state(os.path.join(cp, "exp", "pixel_nerf_init"), first)
    assert ckpt.load_model_weights(other, cp, "exp", resume=False).endswith("pixel_nerf_init")
    assert _state_equal(other.state_dict(), first)
    with pytest.warns(UserWarning, match="re-initialized"):
        assert ckpt.load_model_weights(other, cp, "missing", resume=True) is None


def test_jax_checkpoint_gives_a_clear_error(tmp_path):
    """A flax msgpack file of the JAX package now reads (its tree, with
    the port's own reader); one whose tree does not fit the model raises
    a clear error naming what is missing, and a file that is neither
    format raises."""
    import flax.serialization

    path = tmp_path / "pixel_nerf_latest"
    path.write_bytes(flax.serialization.to_bytes(
        {"params": {"w": np.ones(3, np.float32)}, "batch_stats": {}}))
    tree = ckpt.load_state(str(path))
    assert set(tree) == {"params", "batch_stats"} and tree["params"]["w"].tolist() == [1, 1, 1]
    _, model, _ = _tiny_step_inputs()
    with pytest.raises(ValueError, match="unrecognized leaf|missing"):
        ckpt.load_model_weights(model, str(tmp_path.parent), tmp_path.name, resume=True)
    (tmp_path / "junk").write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="neither a torch nor a flax"):
        ckpt.load_state(str(tmp_path / "junk"))


def test_train_cli_end_to_end_and_resume(workspace):
    """Two epochs, then --resume to a third (mixed views): the files the
    JAX CLI writes, vis PNGs and sigma slices, and a resumed trainer whose
    model and optimizer equal what was saved, bit for bit."""
    args = _common_args(workspace, "t1") + ["-B", "2", "-R", "16", "--vis_chunk", "256"]
    tcli.main(args + ["-V", "2", "--epochs", "2", "--vis_debug"], device="cpu")
    ckpt_dir = os.path.join(workspace["root"], "ckpt", "t1")
    for f in ("pixel_nerf_latest", "_optim", "_iter.json", "_renderer.json"):
        assert os.path.exists(os.path.join(ckpt_dir, f)), f
    meta = json.load(open(os.path.join(ckpt_dir, "_iter.json")))
    assert meta == {"iter": 2, "epoch": 1}
    assert json.load(open(os.path.join(ckpt_dir, "_renderer.json"))) == {"n_coarse": 8, "n_fine": 4}
    vis_dir = os.path.join(workspace["root"], "vis", "t1")
    assert sorted(f for f in os.listdir(vis_dir) if f.endswith("_vis.png")) == [
        "0000_0000_vis.png", "0001_0000_vis.png"]
    assert any(f.endswith("_sigma_z0.png") for f in os.listdir(os.path.join(vis_dir, "vis_debug")))

    saved_model = ckpt.load_state(os.path.join(ckpt_dir, "pixel_nerf_latest"))
    saved_opt = ckpt.load_state(os.path.join(ckpt_dir, "_optim"))
    trainer = tcli.make_trainer(args + ["-V", "1 2", "--epochs", "3", "--resume"], device="cpu")
    assert (trainer.start_iter_id, trainer.start_epoch) == (2, 1)
    assert _state_equal(trainer.model.state_dict(), saved_model)
    assert _state_equal(trainer.optimizer.state_dict(), saved_opt)
    assert trainer.optimizer.count == 2
    trainer.start()
    assert json.load(open(os.path.join(ckpt_dir, "_iter.json"))) == {"iter": 4, "epoch": 2}
    # the resumed run saved twice: the backup holds the first of its saves
    assert os.path.exists(os.path.join(ckpt_dir, "pixel_nerf_backup"))
    assert "0002_0000_vis.png" in os.listdir(vis_dir)
    assert trainer.optimizer.count == 4


@pytest.mark.parametrize("flag,match", [
    pytest.param(["--mesh", "data:2"], "covers 2 devices but 1 are available",
                 id="flag0-queue 1 item 7"),
    pytest.param(["--remat"], None, id="flag1-queue 1 item 9"),
])
def test_unported_flags_raise(workspace, flag, match):
    """The two flags once unported: `--mesh` now raises only where the world
    (here one process, no group) does not match the mesh's product;
    `--remat` trains, the query rematerialized (tests/test_torch_remat.py
    holds the step)."""
    if match:
        with pytest.raises(ValueError, match=match):
            tcli.main(_common_args(workspace, "t2") + flag, device="cpu")
        return
    trainer = tcli.main(_common_args(workspace, "t2") + flag + ["--epochs", "1"], device="cpu")
    assert trainer.optimizer.count == 1
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


def test_spmd_mode_alone_is_accepted(workspace):
    trainer = tcli.make_trainer(_common_args(workspace, "t3") + ["--spmd_mode", "gspmd"],
                                device="cpu")
    assert trainer.model.device.type == "cpu"


def test_main_without_gpu_or_device_raises(workspace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(_common_args(workspace, "t4") + ["--epochs", "1"])
    assert not os.path.exists(os.path.join(workspace["root"], "ckpt", "t4"))
