"""Port parity: the serving CLIs on a checkpoint the JAX training CLI wrote.

The JAX training CLI trains tests/test_cli_pipelines.py's tiny model
(`TINY_CONF`, float32, with the renderer's `perturb = 0.0` so that no
draw differs between the two libraries) for two epochs on the SRN
fixture. Each JAX eval CLI and the port's (`main(argv, device="cpu")`)
then run on the same flax checkpoint, which the port reads with its own
reader (`utils/checkpoint.py`), on the same argv. Tolerances, stated
per comparison:

- `eval_approx`'s PSNR and SSIM: 1e-3 absolute;
- `gen_video`'s and `eval_real`'s frames and `eval_mesh`'s PNGs (uint8
  after rounding): at most 1 level apart (tests/test_torch_slice.py's
  float32 1e-4 on rgb, which can carry a value across a rounding edge);
- `eval_mesh`'s sigma volume: 1e-4 relative to its largest value plus
  1e-4, the float32 products of two libraries; the STL's triangle and
  vertex counts within 1% (a sigma within that tolerance of the
  threshold may fall on either side);
- `calc_metrics`' numbers: 1e-3 (the PNGs are compared above).

On the trained flagship (`artifacts/srn600_bf16.ckpt`, `conf/exp/
srn600.conf` in float32, at 32x32): `eval_approx` of the port reading the
bf16 artifact directly against the JAX CLI on the f32 checkpoint its
`export_checkpoint import` writes, PSNR and SSIM to 1e-3.
"""

import os
import struct

import numpy as np
import pytest

from tests.fixtures import make_srn_dataset
from tests.test_cli_pipelines import TINY_CONF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = TINY_CONF.replace("sched = []", "sched = []\n    perturb = 0.0")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from pixelnerf_tpu.train.train_pixelnerf import main as jtrain

    root = str(tmp_path_factory.mktemp("eval_cli"))
    datadir = make_srn_dataset(root, name="balls", n_objs=2, nv=4, H=16)
    conf_path = os.path.join(root, "tiny.conf")
    with open(conf_path, "w") as f:
        f.write(CONF)
    ws = {"root": root, "datadir": datadir, "conf": conf_path}
    jtrain(_args(ws, "t1") + ["-V", "2", "-B", "2", "-R", "16", "--epochs", "2",
                              "--vis_chunk", "256"])
    assert os.path.exists(os.path.join(root, "ckpt", "t1", "pixel_nerf_latest"))
    return ws


def _args(ws, name, out="out"):
    return [
        "-c", ws["conf"], "-D", ws["datadir"], "-n", name,
        "--logs_path", os.path.join(ws["root"], "logs"),
        "--checkpoints_path", os.path.join(ws["root"], "ckpt"),
        "--visual_path", os.path.join(ws["root"], out),
    ]


def _close_u8(got, want, what):
    got, want = np.asarray(got, np.int16), np.asarray(want, np.int16)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= 1, what


def test_eval_approx_matches_jax(trained):
    from pixelnerf_tpu.eval.eval_approx import main as jmain
    from pixelnerf_tpu_torch.eval.eval_approx import main

    argv = _args(trained, "t1") + ["--split", "test", "-P", "0", "--seed", "3", "-R", "512"]
    want = jmain(argv)
    got = main(argv, device="cpu")
    assert np.isfinite(got).all() and 0 <= got[1] <= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    coarse = main(argv + ["--coarse"], device="cpu")
    np.testing.assert_allclose(coarse, jmain(argv + ["--coarse"]), rtol=0, atol=1e-3)


def test_gen_video_matches_jax(trained, monkeypatch):
    import pixelnerf_tpu.utils.video as jvideo
    from pixelnerf_tpu.eval.gen_video import main as jmain
    from pixelnerf_tpu_torch.eval.gen_video import main

    captured = {}
    write = jvideo.write_video
    monkeypatch.setattr(jvideo, "write_video",
                        lambda p, f, **kw: captured.setdefault("frames", f) is None or write(p, f, **kw))
    argv = ["--split", "test", "-S", "0", "-P", "0 1", "--num_views", "4", "-R", "512", "--fps", "4"]
    jmain(_args(trained, "t1", "jvis") + argv)
    path, frames = main(_args(trained, "t1", "tvis") + argv, device="cpu")
    _close_u8(frames, captured["frames"], "frames")
    assert frames.shape == (4, 128, 128, 3) and frames.std() > 0  # the SRN loader upsamples to 128
    assert os.path.exists(path) and path.endswith((".mp4", ".gif"))
    assert os.path.exists(os.path.join(os.path.dirname(path), "video_test0000_view.jpg"))


def _stl_triangles(path):
    with open(path, "rb") as f:
        f.read(80)
        n = struct.unpack("<I", f.read(4))[0]
        rec = np.frombuffer(f.read(), dtype=np.dtype([("n", "<3f4"), ("v", "<9f4"), ("a", "<u2")]))
    assert len(rec) == n
    return rec["v"].reshape(n, 3, 3)


def _capture_sigma(monkeypatch, module):
    vols = []
    fn = module.eval_sigma_grid
    monkeypatch.setattr(module, "eval_sigma_grid",
                        lambda *a, **kw: (lambda v: vols.append(v) or v)(fn(*a, **kw)))
    return vols


def test_eval_mesh_and_calc_metrics_match_jax(trained, monkeypatch):
    """`eval_mesh --mode both` (sigma volume, STL, PNGs, finish.txt), then
    `calc_metrics` on each side's renders."""
    import pixelnerf_tpu.utils.recon as jrecon
    import pixelnerf_tpu_torch.utils.recon as trecon
    from pixelnerf_tpu.eval.calc_metrics import main as jmetrics
    from pixelnerf_tpu.eval.eval_mesh import main as jmain
    from pixelnerf_tpu_torch.eval.calc_metrics import main as metrics
    from pixelnerf_tpu_torch.eval.eval_mesh import main

    jvols, tvols = _capture_sigma(monkeypatch, jrecon), _capture_sigma(monkeypatch, trecon)
    argv = ["--split", "test", "-P", "0", "--mode", "both", "--mesh_reso", "24",
            "--mesh_thresh", "5.0", "--limit", "1", "-R", "512"]
    jout = os.path.join(trained["root"], "jeval")
    tout = os.path.join(trained["root"], "teval")
    jmain(_args(trained, "t1") + argv + ["--output", jout])
    res = main(_args(trained, "t1") + argv + ["--output", tout], device="cpu")
    (jv,), (tv,) = jvols, tvols
    assert tv.shape == jv.shape == (24, 24, 24) and tv.dtype == np.float32
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4 * np.abs(jv).max() + 1e-4)
    (obj, r), = res.items()
    jdir, tdir = os.path.join(jout, "t1"), os.path.join(tout, "t1")
    jt, tt = _stl_triangles(os.path.join(jdir, f"{obj}.stl")), _stl_triangles(os.path.join(tdir, f"{obj}.stl"))
    assert len(tt) == r["n_tris"] and abs(len(tt) - len(jt)) <= 0.01 * max(len(jt), 1)
    nverts = lambda t: len(np.unique(t.reshape(-1, 3), axis=0))
    assert r["n_verts"] >= nverts(tt) and abs(nverts(tt) - nverts(jt)) <= 0.01 * max(nverts(jt), 1)
    from pixelnerf_tpu_torch.utils.visualize import read_image

    pngs = sorted(os.listdir(os.path.join(jdir, obj)))
    assert pngs == sorted(os.listdir(os.path.join(tdir, obj))) and len(pngs) == 3
    for name in pngs:
        _close_u8(read_image(os.path.join(tdir, obj, name)),
                  read_image(os.path.join(jdir, obj, name)), name)
    jfin = open(os.path.join(jdir, "finish.txt")).read().split()
    tfin = open(os.path.join(tdir, "finish.txt")).read().split()
    assert tfin[0] == jfin[0] == obj and tfin[3] == jfin[3] == "1"
    np.testing.assert_allclose([float(x) for x in tfin[1:3]], [float(x) for x in jfin[1:3]],
                               atol=1.01e-2)
    assert abs(r["psnr"] - float(jfin[1])) <= 5e-3 + 1e-3

    gt = os.path.join(trained["datadir"], "balls_test")
    jmetrics(["-D", gt, "-O", jdir, "-F", "srn", "--overwrite"])
    got = metrics(["-D", gt, "-O", tdir, "-F", "srn", "--overwrite"], device="cpu")
    want = {}
    for line in open(os.path.join(jdir, "all_metrics.txt")):
        k, *kv = line.split()
        want[k] = dict(zip(kv[::2], map(float, kv[1::2])))
    text = open(os.path.join(tdir, "all_metrics.txt")).read()
    assert "total psnr" in text and set(got) == set(want) == {"all", "total"}
    for cat, vals in want.items():
        assert got[cat]["n"] == vals["n"] == 1
        np.testing.assert_allclose([got[cat]["psnr"], got[cat]["ssim"]],
                                   [vals["psnr"], vals["ssim"]], rtol=0, atol=1e-3)
        assert np.isnan(got[cat]["lpips"]) and np.isnan(vals["lpips"])


def test_eval_real_matches_jax(trained):
    from pixelnerf_tpu.eval.eval_real import main as jmain
    from pixelnerf_tpu_torch.eval.eval_real import main
    from pixelnerf_tpu_torch.utils.visualize import read_image, write_png

    inp = os.path.join(trained["root"], "real_in")
    os.makedirs(inp, exist_ok=True)
    rng = np.random.default_rng(0)
    img = np.full((16, 16, 3), 255, np.uint8)
    img[4:12, 4:12] = rng.integers(0, 180, (8, 8, 3), dtype=np.uint8)
    write_png(os.path.join(inp, "car_normalize.png"), img)
    argv = ["-I", inp, "--size", "16", "--out_size", "16", "--focal", "16", "--num_views", "3",
            "-R", "256", "--gif"]
    jout, tout = (os.path.join(trained["root"], d) for d in ("jreal", "treal"))
    jmain(_args(trained, "t1") + argv + ["-O", jout])
    frames, = main(_args(trained, "t1") + argv + ["-O", tout], device="cpu").values()
    assert frames.shape == (3, 16, 16, 3)
    for k in range(3):
        name = os.path.join("car_normalize_frames", f"{k:04d}.png")
        _close_u8(read_image(os.path.join(tout, name)), read_image(os.path.join(jout, name)), name)
        _close_u8(frames[k], read_image(os.path.join(jout, name)), name)
    assert os.path.exists(os.path.join(tout, "car_normalize_vid.gif"))


def test_eval_approx_on_the_artifact_matches_jax(tmp_path):
    """The trained flagship at 32x32 in float32: the port reads the bf16
    artifact itself; the JAX CLI reads the f32 checkpoint that its
    `export_checkpoint import` writes from it."""
    from pixelnerf_tpu.eval.eval_approx import main as jmain
    from pixelnerf_tpu.tools.export_checkpoint import import_
    from pixelnerf_tpu_torch.eval.eval_approx import main

    datadir = make_srn_dataset(str(tmp_path), name="shapes", n_objs=1, nv=3, H=32,
                               stages=("test",), near_far=True)
    conf = tmp_path / "srn600_f32.conf"
    conf.write_text(f'include required("{ROOT}/conf/exp/srn600.conf")\n'
                    "model { dtype = float32 }\nrenderer { perturb = 0.0 }\n")
    ck = tmp_path / "ckpt"
    import_(os.path.join(ROOT, "artifacts", "srn600_bf16.ckpt"), str(ck / "jax" / "pixel_nerf_latest"))
    (ck / "port").mkdir()
    os.symlink(os.path.join(ROOT, "artifacts", "srn600_bf16.ckpt"), ck / "port" / "pixel_nerf_latest")
    argv = ["-c", str(conf), "-D", datadir, "--split", "test", "-P", "0 1", "--seed", "1",
            "--image_size", "32", "32",
            "-R", "1024", "--checkpoints_path", str(ck), "--visual_path", str(tmp_path / "v")]
    want = jmain(argv + ["-n", "jax"])
    got = main(argv + ["-n", "port"], device="cpu")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_reader_reads_the_jax_cli_checkpoint(trained):
    """The live float32 `pixel_nerf_latest` the JAX training CLI wrote
    reads as flax restores it, bit for bit, and loads into the port's
    model; its `_optim` (an optax state) reads as a tree too."""
    import flax.serialization

    from pixelnerf_tpu_torch.convert import state_dict_from_jax
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.utils import checkpoint as ckpt
    from pixelnerf_tpu_torch.utils.hocon import loads

    cdir = os.path.join(trained["root"], "ckpt", "t1")
    path = os.path.join(cdir, "pixel_nerf_latest")
    got = ckpt.read_flax_msgpack(path)
    with open(path, "rb") as f:
        want = flax.serialization.msgpack_restore(f.read())

    def flat(t, p=()):
        for k, v in t.items():
            yield from (flat(v, p + (k,)) if isinstance(v, dict) else [(p + (k,), v)])

    got, want = dict(flat(got)), dict(flat(want))
    assert list(got) == list(want) and len(got) > 50
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].tobytes() == np.asarray(w).tobytes(), k
    model = make_model(loads(CONF)["model"], device="cpu")
    assert ckpt.load_model_weights(model, os.path.join(trained["root"], "ckpt"), "t1",
                                   resume=True) == path
    sd = state_dict_from_jax(ckpt.read_flax_msgpack(path), model)
    for k, v in model.state_dict().items():
        assert np.array_equal(v.numpy(), sd[k].numpy()), k
    assert ckpt.is_flax_checkpoint(os.path.join(cdir, "_optim"))
    assert isinstance(ckpt.load_state(os.path.join(cdir, "_optim")), dict)


def test_train_cli_resumes_from_a_jax_checkpoint(trained, capsys):
    """The port's training CLI `--resume`s from the JAX CLI's checkpoint
    directory: the model weights load, the iteration count continues from
    its `_iter.json`, the optax state is not read (and says so), and one
    more epoch trains and saves torch checkpoints."""
    import json
    import shutil

    from pixelnerf_tpu_torch.train.train_pixelnerf import make_trainer
    from pixelnerf_tpu_torch.utils import checkpoint as ckpt

    shutil.copytree(os.path.join(trained["root"], "ckpt", "t1"),
                    os.path.join(trained["root"], "ckpt", "t1_resume"))
    cdir = os.path.join(trained["root"], "ckpt", "t1_resume")
    with open(os.path.join(cdir, "_iter.json")) as f:
        start = json.load(f)["iter"]
    jax_tree = ckpt.read_flax_msgpack(os.path.join(cdir, "pixel_nerf_latest"))
    trainer = make_trainer(_args(trained, "t1_resume") + ["-V", "2", "-B", "2", "-R", "16",
                                                           "--epochs", "3", "--resume",
                                                           "--vis_chunk", "256"], device="cpu")
    assert "Not read:" in capsys.readouterr().out
    lin = jax_tree["params"]["mlp_coarse"]["lin_out"]["kernel"]
    assert np.array_equal(trainer.model.mlp_coarse.lin_out.weight.detach().numpy(), lin.T)
    assert trainer.start_iter_id == start
    trainer.start()
    with open(os.path.join(cdir, "_iter.json")) as f:
        assert json.load(f)["iter"] > start
    assert not ckpt.is_flax_checkpoint(os.path.join(cdir, "pixel_nerf_latest"))
    assert not ckpt.is_flax_checkpoint(os.path.join(cdir, "_optim"))


def test_helpers_match_jax(tmp_path):
    """The CLIs' host helpers against the JAX package's: SSIM and PSNR on
    random images (1e-12), the DTU spline path and the orbit poses (1e-6),
    and `utils/recon.py`: the sigma grid of a sphere's density queried in
    chunks, its iso-surface (the same C++ built by each package: equal
    vertices and triangles) and the OBJ and STL files, byte for byte."""
    import torch

    from pixelnerf_tpu.eval.gen_video import dtu_spline_poses as j_dtu
    from pixelnerf_tpu.utils import cameras as jcam
    from pixelnerf_tpu.utils import metrics as jmetrics
    from pixelnerf_tpu.utils import recon as jrecon
    from pixelnerf_tpu_torch.eval.gen_video import dtu_spline_poses
    from pixelnerf_tpu_torch.utils import cameras, metrics, recon

    rng = np.random.default_rng(5)
    a, b = rng.uniform(size=(2, 20, 24, 3))
    assert abs(metrics.ssim_np(a, b) - jmetrics.ssim_np(a, b)) <= 1e-12
    assert abs(metrics.ssim_np(a[..., 0], b[..., 0]) - jmetrics.ssim_np(a[..., 0], b[..., 0])) <= 1e-12
    assert metrics.psnr_np(a, b) == jmetrics.psnr_np(a, b)
    np.testing.assert_allclose(dtu_spline_poses(40), j_dtu(40), atol=1e-6)
    np.testing.assert_allclose(cameras.coord_from_blender() @ cameras.pose_spherical(30, -10, 1.3),
                               jcam.coord_from_blender() @ jcam.pose_spherical(30, -10, 1.3), atol=1e-6)

    def sphere(pts):
        return 20.0 * (0.6 - np.linalg.norm(np.asarray(pts), axis=-1))

    def sphere_t(pts):
        assert isinstance(pts, torch.Tensor) and pts.shape == (500, 3)
        return torch.from_numpy(sphere(pts.numpy()))

    kw = dict(c1=(-1, -1, -1), c2=(1, 1, 1), eval_batch_size=500)
    vol = recon.eval_sigma_grid(sphere_t, (12, 13, 14), device="cpu", **kw)
    np.testing.assert_array_equal(vol, jrecon.eval_sigma_grid(sphere, (12, 13, 14), **kw))
    verts, tris = recon.marching_cubes(sphere_t, reso=(12, 13, 14), isosurface=5.0, device="cpu", **kw)
    jverts, jtris = jrecon.marching_cubes(sphere, reso=(12, 13, 14), isosurface=5.0, **kw)
    assert len(tris) > 100 and verts.dtype == np.float32 and tris.dtype == np.int32
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(tris, jtris)
    rgb = rng.uniform(size=verts.shape).astype(np.float32)
    for name, fn, jfn, extra in (("m.obj", recon.save_obj, jrecon.save_obj, (rgb,)),
                                 ("m.stl", recon.save_stl, jrecon.save_stl, ())):
        fn(verts, tris, str(tmp_path / f"t_{name}"), *extra)
        jfn(verts, tris, str(tmp_path / f"j_{name}"), *extra)
        assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes()
