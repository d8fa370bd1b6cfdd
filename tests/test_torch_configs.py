"""Port parity on every shipped config: `conf/default.conf` and each
`conf/exp/*.conf`, cut in depth and width, and the training CLI on the
three DVR formats.

Renders. Each config is read as it ships and cut: ResNet-18 in place of
ResNet-34 (depth), 32-wide ResnetFC heads in place of 512 (width), 8
coarse + 4 fine (2 of them depth-guided) samples; every other key (the
dtype, n_blocks, combine_layer, use_first_pool, the code, the view
directions) stays. The JAX `make_model` and the port's build the model
from the same conf, the JAX variables (made random, fc_1 and the
BatchNorm statistics included) are carried across by
`convert.state_dict_from_jax`, both encode the same two 32x32 views (one
for the single-view default.conf) and render the same 24 rays through
their own `render_full` with perturb 0. float32 configs: 1e-4 absolute,
the same math summed in other orders. bf16 configs (srn, srn_long,
srn600, dtu): 5e-2 absolute and 1e-2 on average, as
tests/test_torch_slice.py's bf16 query: each library rounds ~20 bf16
convolutions apart before the heads see the latent, and the port runs its
kernels' plain versions where the JAX package runs XLA on the CPU.

The training CLI. sn64.conf on `dvr`, sn64_unseen.conf on `dvr_gen` and
dtu.conf on `dvr_dtu` (tests/fixtures.make_dvr_dataset, 16x16 views), cut
as above and with the renderer's jitter off (perturb 0), with `-V 1`,
`-V 1` and `-V 3` as the experiments train. Both CLIs start from the same
weights (a JAX `pixel_nerf_init` checkpoint, which each loads by the init
rule) and run one epoch at learning rate 0, so every step evaluates the
same weights on the same batches (the host pipelines are equal bit for
bit, tests/test_torch_data.py). The JAX CLI's ray draws (the pixels, or
the views and box positions with bbox sampling) are recorded as its
`sample_rays` makes them and handed to the port's `sample_rays` in the
same order, so both steps see the same rays. Each logged loss of each
step then agrees as the renders do: 1e-4 for float32, 5e-2 for bf16 (the
bf16 trunk's rounding, as above; dtu.conf read 2.1e-2 on losses near 1).
dtu.conf also runs in float32, so that its DVR_DTU wiring (three source
views, no masks) is held at 1e-4 too, and sn64.conf with `backbone =
custom`, whose global-code convolution each CLI makes from its first
batch.
"""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.eval.common import encode_views as j_encode_views
from pixelnerf_tpu.eval.render_utils import render_full as j_render_full
from pixelnerf_tpu.models.pixelnerf import make_model as j_make_model
from pixelnerf_tpu.render.renderer import RendererConfig as JRendererConfig
from pixelnerf_tpu.train import step as jstep
from pixelnerf_tpu.train import train_pixelnerf as jcli
from pixelnerf_tpu.utils import checkpoint as jckpt
from pixelnerf_tpu.utils.hocon import loads as j_loads
from pixelnerf_tpu.utils.rays import gen_rays as j_gen_rays
from pixelnerf_tpu_torch.convert import state_dict_from_jax
from pixelnerf_tpu_torch.eval.common import encode_views
from pixelnerf_tpu_torch.eval.render_utils import render_full
from pixelnerf_tpu_torch.models.pixelnerf import make_model
from pixelnerf_tpu_torch.render.renderer import RendererConfig
from pixelnerf_tpu_torch.train import step as tstep
from pixelnerf_tpu_torch.train import train_pixelnerf as tcli
from pixelnerf_tpu_torch.utils.hocon import loads
from tests.fixtures import make_dvr_dataset
from tests.test_torch_model_options import _look_at, _randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = [os.path.join(ROOT, "conf", "default.conf")] + sorted(
    glob.glob(os.path.join(ROOT, "conf", "exp", "*.conf")))
H = W = 32
FOCAL = 35.0
NEAR, FAR = 0.8, 1.8

CUT = """
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
}
"""


def _cut_conf(path, extra=""):
    """The config at `path` as it ships, then the cut (and `extra`)."""
    text = f'include required("{path}")\n' + CUT + extra
    return j_loads(text, base_dir=os.path.dirname(path)), loads(text, base_dir=os.path.dirname(path))


def test_every_shipped_config_is_covered():
    names = {os.path.basename(c) for c in CONFS}
    assert {"default.conf", "dtu.conf", "sn64.conf", "sn64_unseen.conf", "srn.conf"} <= names


@pytest.mark.parametrize("path", CONFS, ids=[os.path.basename(c) for c in CONFS])
def test_config_renders_as_jax(path):
    conf_j, conf_t = _cut_conf(path)
    dtype = conf_t["model"].get_string("dtype", "float32")
    ns = 2 if conf_t["model"].get_config("mlp_coarse").get_int("combine_layer", 1000) < 1000 else 1
    jmodel = j_make_model(conf_j["model"], dtype=getattr(jnp, dtype), use_pallas=False)
    rng = np.random.default_rng(len(path))
    images = rng.uniform(-1, 1, size=(ns, H, W, 3)).astype(np.float32)
    poses = np.stack([_look_at([1.3, 0.2, 0.1]), _look_at([0.2, 0.3, 1.3])][:ns])
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(images[None]), jnp.asarray(poses[None]),
        jnp.asarray(FOCAL), jnp.zeros((1, 8, 3)), viewdirs=jnp.zeros((1, 8, 3)))
    variables = _randomize(variables, 1)
    model = make_model(conf_t["model"], device="cpu")
    assert model.dtype == getattr(torch, dtype)
    model.load_state_dict(state_dict_from_jax(variables, model))

    target = _look_at([0.9, 0.4, 0.9])[None]
    rays = np.asarray(j_gen_rays(jnp.asarray(target), 6, 4, FOCAL * 6 / W, NEAR, FAR)).reshape(-1, 8)
    jr = JRendererConfig.from_conf(conf_j["renderer"]).replace(perturb=0.0)
    want = j_render_full(jmodel, variables, j_encode_views(jmodel, variables, images, poses, FOCAL),
                         rays, jr, chunk=16)
    rcfg = RendererConfig.from_conf(conf_t["renderer"]).replace(perturb=0.0)
    with torch.no_grad():
        got = render_full(model, encode_views(model, images, poses, FOCAL), rays, rcfg, chunk=16)
    assert set(got) == set(want)
    for head in got:
        for k in ("rgb", "depth", "alpha"):
            g, w = got[head][k].float().numpy(), np.asarray(want[head][k], np.float32)
            assert g.shape == w.shape and np.isfinite(g).all()
            if dtype == "float32":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f"{head} {k}")
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=5e-2, err_msg=f"{head} {k}")
                assert np.abs(g - w).mean() < 1e-2, (head, k)


# (conf, format, list prefix, -V, (name, model keys put over the conf's))
CLI_CASES = [("sn64.conf", "dvr", "softras_", "1", None),
             ("sn64_unseen.conf", "dvr_gen", "gen_", "1", None),
             ("dtu.conf", "dvr_dtu", "new_", "3", None),
             ("dtu.conf", "dvr_dtu", "new_", "3", ("float32", "dtype = float32")),
             ("sn64.conf", "dvr", "softras_", "1", ("custom", "encoder {\n    backbone = custom\n}"))]
CLI_IDS = [c[1] + (f"-{c[4][0]}" if c[4] else "") for c in CLI_CASES]
CLI_EXTRA = """
train {
    print_interval = 1
    eval_interval = 1000
    vis_interval = 1000
    save_interval = 1000
    num_epoch_repeats = 1
}
renderer {
    perturb = 0.0
}
"""
LOSS = re.compile(r"^E 0 B \d+ loss (.*?)\s+lr", re.M)


def _losses(text):
    return [{k: float(v) for k, v in (kv.split(":") for kv in m.split())}
            for m in LOSS.findall(text)]


def _shared_draws(monkeypatch):
    """Record the JAX step's ray draws and feed them to the port's
    `sample_rays` in the same order; returns (recorded, consumed)."""
    recorded, consumed = [], []
    real_j, real_t = jstep.sample_rays, tstep.sample_rays

    def recording(rng, images, poses, focal, c, z_near, z_far, num_rays, bbox=None, **kw):
        # the draws as jstep.sample_rays makes them from its key
        sb, nv, h, w, _ = images.shape
        k_view, k_x, k_y = jax.random.split(rng, 3)
        shape = (sb, num_rays)
        if bbox is None:
            draws = {"pix": jax.random.randint(k_view, shape, 0, nv * h * w)}
        else:
            draws = {"vid": jax.random.randint(k_view, shape, 0, nv),
                     "ux": jax.random.uniform(k_x, shape), "uy": jax.random.uniform(k_y, shape)}
        jax.debug.callback(lambda d: recorded.append(jax.device_get(d)), draws, ordered=True)
        return real_j(rng, images, poses, focal, c, z_near, z_far, num_rays, bbox=bbox, **kw)

    def fed(*a, **kw):
        draws = recorded[len(consumed)]
        consumed.append(draws)
        kw["draws"] = {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}
        return real_t(*a, **kw)

    monkeypatch.setattr(jstep, "sample_rays", recording)
    monkeypatch.setattr(tstep, "sample_rays", fed)
    return recorded, consumed


@pytest.mark.parametrize("conf_name,fmt,prefix,views,over", CLI_CASES, ids=CLI_IDS)
def test_training_cli_one_epoch_matches_jax_loss(tmp_path, capsys, monkeypatch, conf_name, fmt,
                                                  prefix, views, over):
    path = os.path.join(ROOT, "conf", "exp", conf_name)
    conf_file = tmp_path / "cut.conf"
    over = f"model {{\n{over[1]}\n}}\n" if over else ""
    conf_file.write_text(f'include required("{path}")\n' + CUT + CLI_EXTRA + over)
    datadir = make_dvr_dataset(str(tmp_path / "data"), n_objs=4, nv=5, H=16, list_prefix=prefix,
                               with_masks=fmt != "dvr_dtu")
    argv = ["-c", str(conf_file), "-D", datadir, "-n", "cut", "--dataset_format", fmt,
            "--checkpoints_path", str(tmp_path / "ckpt"), "--logs_path", str(tmp_path / "logs"),
            "--visual_path", str(tmp_path / "vis"), "-B", "1", "-V", views, "-R", "256",
            "--epochs", "1", "--lr", "0"]

    # the shared initial weights: the JAX model's, made random, as pixel_nerf_init
    conf_j = j_loads(conf_file.read_text(), base_dir=str(tmp_path))
    dtype = conf_j["model"].get_string("dtype", "float32")
    jmodel = j_make_model(conf_j["model"], dtype=getattr(jnp, dtype))
    nv = int(views)
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, nv, 16, 16, 3)), jnp.tile(jnp.eye(4), (1, nv, 1, 1)),
        jnp.asarray(20.0), jnp.zeros((1, 8, 3)), viewdirs=jnp.zeros((1, 8, 3)))
    jckpt.save_model_weights(_randomize(variables, 3), str(tmp_path / "ckpt"), "cut", opt_init=True)

    recorded, consumed = _shared_draws(monkeypatch)
    capsys.readouterr()
    jcli.main(argv)
    jax.effects_barrier()
    want = _losses(capsys.readouterr().out)
    tcli.main(argv, device="cpu")
    out = capsys.readouterr().out
    got = _losses(out)
    assert "pixel_nerf_init" in out and len(got) == len(want) == 4
    assert len(consumed) == len(recorded) > 0
    tol = 1e-4 if dtype == "float32" else 5e-2
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), step
        for k in w:
            assert np.isfinite(g[k]) and w[k] > 0
            assert abs(g[k] - w[k]) <= tol, (step, k, g[k], w[k])
