"""The port's tools and the last helpers, against the JAX package's.

- `tools/export_checkpoint`: `import` of the bf16 artifact and `export` of
  the result write the JAX tool's files byte for byte (and `export`
  gives back the artifact), so each package's `import` reads the other's
  `export`; the port's own torch checkpoint exports too, to the model's
  parameters rounded to bf16 (to nearest even) and its batch statistics
  kept in float32, which the JAX tool imports.
- `utils/checkpoint.write_flax_msgpack` against
  `flax.serialization.msgpack_serialize` (and `to_bytes`, unsorted), byte
  for byte, on a tree of every kind of leaf it writes.
- `tools/port_encoder_weights` on a random state_dict of torchvision's
  ResNet key layout: its `.npz` equals the JAX tool's, array for array;
  into a flax checkpoint it writes the JAX tool's file byte for byte; into
  the port's torch checkpoint, the JAX tool's trunk through
  `convert.state_dict_from_jax`, exactly.
- `tools/profile_step --steps 1` (train, then forward only with --remat)
  on a cut srn.conf on the CPU: a Chrome trace with the step's range.
- `eval/preproc`: GrabCut and `normalize_image` on a synthetic photo, and
  `main`'s `*_normalize.png`, bit for bit against the JAX module's.
- `utils/rays`: `bbox_sample` on the JAX function's own draws,
  `masked_sample_np` on the same numpy generator, `homogeneous`: equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.utils import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "srn600_bf16.ckpt")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads a test: the suite runs six workers on the CPU's
    cores, and more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# -------------------------------------------------------- export_checkpoint


def test_export_checkpoint_matches_jax_both_ways(tmp_path):
    from pixelnerf_tpu.tools import export_checkpoint as jtool
    from pixelnerf_tpu_torch.tools import export_checkpoint as tool

    live, jlive = str(tmp_path / "t" / "pixel_nerf_latest"), str(tmp_path / "j" / "pixel_nerf_latest")
    tool.main(["import", "--artifact", ARTIFACT, "--ckpt", live])
    jtool.main(["import", "--artifact", ARTIFACT, "--ckpt", jlive])
    assert _bytes(live) == _bytes(jlive)
    tool.main(["export", "--ckpt", jlive, "--out", str(tmp_path / "t.ckpt")])
    jtool.main(["export", "--ckpt", live, "--out", str(tmp_path / "j.ckpt")])
    assert _bytes(tmp_path / "t.ckpt") == _bytes(tmp_path / "j.ckpt") == _bytes(ARTIFACT)
    with pytest.raises(SystemExit):
        tool.main(["export", "--ckpt", live])


def test_export_of_a_torch_checkpoint(tmp_path):
    import jax.numpy as jnp

    from pixelnerf_tpu.tools import export_checkpoint as jtool
    from pixelnerf_tpu_torch.convert import state_dict_from_jax
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.tools import export_checkpoint as tool
    from pixelnerf_tpu_torch.utils.hocon import loads
    from tests.test_cli_pipelines import TINY_CONF

    model = make_model(loads(TINY_CONF)["model"], device="cpu")
    with torch.no_grad():
        for t in model.state_dict().values():
            t.normal_(generator=torch.Generator().manual_seed(t.numel()))
    path = str(tmp_path / "pixel_nerf_latest")
    ckpt.save_state(path, model.state_dict())
    tool.main(["export", "--ckpt", path, "--out", str(tmp_path / "a.ckpt")])
    jtool.main(["import", "--artifact", str(tmp_path / "a.ckpt"), "--ckpt", str(tmp_path / "f32")])
    back = state_dict_from_jax(ckpt.read_flax_msgpack(str(tmp_path / "f32")), model)
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            want = v
        else:
            want = torch.from_numpy(np.asarray(np.asarray(v.numpy(), jnp.bfloat16), np.float32))
        assert torch.equal(back[k], want), k


def test_msgpack_writer_matches_flax(tmp_path):
    import flax.serialization
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 40)).astype(np.float32)
    a[0, :4] = [np.nan, np.inf, -np.inf, 3.3895314e38]  # bf16 rounding's edges
    tree = {
        "params": {"b": {"kernel": a, "bias": np.zeros(300, np.float32)},
                   "a": np.arange(7, dtype=np.int32)},
        "meta": {"x": 1, "y": -5, "z": 300, "w": -200, "v": 70000, "u": -70000, "t": 2**40,
                 "s": 1.5, "r": "hi", "q": "x" * 40, "n": None, "m": True, "e": b"\x00" * 3},
        "scalar": np.float32(2.5), "f64": np.ones((4, 70), np.float64),
        "many": {str(i): np.ones(i, np.uint8) for i in range(20)},
    }
    ckpt.write_flax_msgpack(str(tmp_path / "t"), {**tree, "bf": ckpt.Bfloat16.from_float32(a)})
    want = flax.serialization.msgpack_serialize({**tree, "bf": np.asarray(a, jnp.bfloat16)})
    assert _bytes(tmp_path / "t") == want
    ckpt.write_flax_msgpack(str(tmp_path / "u"), tree, sort_keys=False)
    assert _bytes(tmp_path / "u") == flax.serialization.to_bytes(tree)
    x = (rng.normal(size=4096) * 10.0 ** rng.integers(-40, 38, size=4096)).astype(np.float32)
    np.testing.assert_array_equal(ckpt.Bfloat16.from_float32(x).bits,
                                  np.asarray(x, jnp.bfloat16).view(np.uint16))


# ----------------------------------------------------- port_encoder_weights


def _torchvision_resnet18(seed=0):
    """A random state_dict of torchvision's resnet18 key layout."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[key] = torch.randn(cout, cin, k, k, generator=g) * 0.1

    def bn(pre, c):
        sd[pre + ".weight"] = 1 + 0.1 * torch.randn(c, generator=g)
        sd[pre + ".bias"] = 0.1 * torch.randn(c, generator=g)
        sd[pre + ".running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[pre + ".running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[pre + ".num_batches_tracked"] = torch.tensor(100)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for stage, cout in enumerate((64, 128, 256, 512)):
        for blk in range(2):
            pre = f"layer{stage + 1}.{blk}"
            conv(pre + ".conv1.weight", cout, cin if blk == 0 else cout, 3)
            bn(pre + ".bn1", cout)
            conv(pre + ".conv2.weight", cout, cout, 3)
            bn(pre + ".bn2", cout)
            if stage > 0 and blk == 0:
                conv(pre + ".downsample.0.weight", cout, cin, 1)
                bn(pre + ".downsample.1", cout)
        cin = cout
    sd["fc.weight"] = torch.randn(1000, 512, generator=g)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def test_port_encoder_weights_matches_jax(tmp_path):
    from pixelnerf_tpu.tools import port_encoder_weights as jtool
    from pixelnerf_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.tools import port_encoder_weights as tool
    from pixelnerf_tpu_torch.utils.hocon import loads
    from tests.test_cli_pipelines import TINY_CONF

    weights = str(tmp_path / "resnet18.pth")
    torch.save(_torchvision_resnet18(), weights)
    np.savez(tmp_path / "resnet18.npz", **{k: v.numpy() for k, v in _torchvision_resnet18().items()})
    args = ["--backbone", "resnet18", "--num_stages", "1"]  # TINY_CONF: num_layers 2
    for src in ("resnet18.pth", "resnet18.npz"):
        tool.main(["--weights", str(tmp_path / src), "--out", str(tmp_path / "t.npz")] + args)
        jtool.main(["--weights", str(tmp_path / src), "--out", str(tmp_path / "j.npz")] + args)
        got, want = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
        assert sorted(got.files) == sorted(want.files) and len(got.files) == 25
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])

    model = make_model(loads(TINY_CONF)["model"], device="cpu")
    # a flax checkpoint, updated by each tool
    for name in ("t_flax", "j_flax"):
        ckpt.write_flax_msgpack(str(tmp_path / name), jax_from_state_dict(model.state_dict()))
    tool.main(["--weights", weights, "--checkpoint", str(tmp_path / "t_flax")] + args)
    jtool.main(["--weights", weights, "--checkpoint", str(tmp_path / "j_flax")] + args)
    assert _bytes(tmp_path / "t_flax") == _bytes(tmp_path / "j_flax")
    # the port's torch checkpoint takes the JAX tool's trunk
    path = str(tmp_path / "pixel_nerf_latest")
    ckpt.save_state(path, model.state_dict())
    tool.main(["--weights", weights, "--checkpoint", path] + args)
    want = state_dict_from_jax(ckpt.read_flax_msgpack(str(tmp_path / "j_flax")), model)
    got = ckpt.load_state(path, "cpu")
    assert set(got) == set(want)
    changed = [k for k in got if not torch.equal(model.state_dict()[k], want[k])]
    assert len(changed) == 25 and all(k.startswith("encoder.model.") for k in changed)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    model.load_state_dict(got)  # loads as a checkpoint of the model


def test_jax_from_state_dict_inverts_the_bridge():
    import jax

    from pixelnerf_tpu.models.pixelnerf import make_model as j_make_model
    from pixelnerf_tpu.utils.hocon import loads as j_loads
    from pixelnerf_tpu_torch.convert import jax_from_state_dict, state_dict_from_jax
    from tests.test_cli_pipelines import TINY_CONF

    jmodel = j_make_model(j_loads(TINY_CONF)["model"])
    z = np.zeros((1, 2, 16, 16, 3), np.float32)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0), z[:, :1], np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1)),
                                           np.full((1, 2), 16.0, np.float32), np.zeros((1, 4, 3), np.float32),
                                           viewdirs=np.zeros((1, 4, 3), np.float32)))
    back = jax_from_state_dict(state_dict_from_jax(variables))

    def walk(a, b):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))

    walk(back, {"params": variables["params"], "batch_stats": variables["batch_stats"]})


# ------------------------------------------------------------- profile_step


def test_profile_step_on_the_cpu(tmp_path):
    from pixelnerf_tpu_torch.tools import profile_step

    conf = tmp_path / "cut.conf"
    conf.write_text(
        f'include required("{ROOT}/conf/exp/srn.conf")\n'
        "model.encoder.backbone = resnet18\nmodel.encoder.num_layers = 2\n"
        "model.mlp_coarse.d_hidden = 16\nmodel.mlp_fine.d_hidden = 16\n"
        "renderer.n_coarse = 4\nrenderer.n_fine = 2\nrenderer.n_fine_depth = 1\n"
    )
    small = ["-c", str(conf), "--steps", "1", "--sb", "1", "--size", "16", "--rays", "8"]
    for extra, label in (([], "pnt.step"), (["--forward-only", "--remat"], "render 0")):
        out = tmp_path / label.split()[0]
        prof = profile_step.main(small + ["--out", str(out)] + extra, device="cpu")
        trace = json.load(open(out / "trace.json"))
        assert any(e.get("name") == label for e in trace["traceEvents"])
        assert any(e.key == label for e in prof.key_averages())


# ------------------------------------------------------------------ preproc


def _photo(seed=0, h=96, w=120):
    """A lit ellipse on a textured background."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    inside = ((xx - 64) / 30.0) ** 2 + ((yy - 50) / 22.0) ** 2 <= 1.0
    bg = rng.integers(60, 120, (h, w, 3))
    fg = np.array([200, 60, 40]) + rng.integers(-15, 15, (h, w, 3)) + (xx[..., None] - 64) // 2
    return np.clip(np.where(inside[..., None], fg, bg), 0, 255).astype(np.uint8)


def test_preproc_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    import imageio.v2 as imageio

    from pixelnerf_tpu.eval import preproc as jpre
    from pixelnerf_tpu_torch.eval import preproc as pre

    im = _photo()
    mask = pre.grabcut_segment(im)
    np.testing.assert_array_equal(mask, jpre.grabcut_segment(im))
    assert 0.1 < mask.mean() < 0.5
    for size in (64, 128):
        np.testing.assert_array_equal(pre.normalize_image(im, mask, size=size),
                                      jpre.normalize_image(im, mask, size=size))
    tiny = np.zeros(im.shape[:2], np.float32)
    tiny[40:42, 60:62] = 1.0  # too few contour points for an ellipse
    np.testing.assert_array_equal(pre.normalize_image(im, tiny), jpre.normalize_image(im, tiny))
    with pytest.raises(ValueError):
        pre.normalize_image(im, np.zeros_like(tiny))

    for d in ("t", "j"):
        os.makedirs(tmp_path / d)
        imageio.imwrite(tmp_path / d / "car.png", im)
    written = pre.main(["-I", str(tmp_path / "t"), "--size", "64", "--segmenter", "grabcut"])
    jpre.main(["-I", str(tmp_path / "j"), "--size", "64", "--segmenter", "grabcut"])
    assert written == [str(tmp_path / "t" / "car_normalize.png")]
    np.testing.assert_array_equal(imageio.imread(written[0]),
                                  imageio.imread(tmp_path / "j" / "car_normalize.png"))


# --------------------------------------------------------------------- rays


def test_rays_helpers_match_jax():
    import jax

    from pixelnerf_tpu.utils import rays as jrays
    from pixelnerf_tpu_torch.utils import rays

    bboxes = np.array([[2, 3, 10, 12], [0, 0, 15, 15], [5, 1, 6, 9]], np.int32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jrays.bbox_sample(key, bboxes, 500))
    k_img, k_x, k_y = jax.random.split(key, 3)
    draws = {"vid": jax.random.randint(k_img, (500,), 0, 3),
             "ux": jax.random.uniform(k_x, (500,)), "uy": jax.random.uniform(k_y, (500,))}
    got = rays.bbox_sample(torch.from_numpy(bboxes), 500,
                           draws={k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = rays.bbox_sample(torch.from_numpy(bboxes), 300, torch.Generator().manual_seed(0))
    b = bboxes[drawn[:, 0].numpy()]
    assert ((drawn[:, 2].numpy() >= b[:, 0]) & (drawn[:, 2].numpy() <= b[:, 2])
            & (drawn[:, 1].numpy() >= b[:, 1]) & (drawn[:, 1].numpy() <= b[:, 3])).all()

    masks = np.random.default_rng(1).uniform(size=(2, 9, 11)).astype(np.float32)
    np.testing.assert_array_equal(
        rays.masked_sample_np(np.random.default_rng(5), masks, 77, 0.7),
        jrays.masked_sample_np(np.random.default_rng(5), masks, 77, 0.7))

    pts = np.random.default_rng(2).normal(size=(4, 5, 3)).astype(np.float32)
    got = rays.homogeneous(torch.from_numpy(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrays.homogeneous(pts)))
    assert got.shape == (4, 5, 4)
