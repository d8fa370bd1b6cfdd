"""LPIPS (VGG16) of the port (`utils/lpips.py`) against the JAX module
(`pixelnerf_tpu/utils/lpips_jax.py`).

- `random_params` draws the JAX module's tree, bit for bit;
- `lpips_distance` on the same random weights and image pairs, float32:
  1e-5 relative (the same convolutions summed in other orders);
- the weights load from the `.npz` that `port_lpips_weights` writes and
  from the torch state dicts it reads (torchvision vgg16 and lin heads,
  or one full lpips.LPIPS dict), equal to the JAX module's loads;
- `calc_metrics` reports NaN without weights, and with the same weight
  file (`$PIXELNERF_LPIPS_WEIGHTS`) the JAX CLI's LPIPS, to 1e-5
  relative.
"""

import os

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.utils import lpips


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads a test: the suite runs six workers on the CPU's
    cores, and more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sd(params, full=False):
    """Torch state dicts of a parameter tree: torchvision vgg16's
    `features.<i>` (or lpips' `net.slice<k>.<i>`) and the lin heads."""
    idx = 0
    vgg = {}
    for (w, b), (_c, pool) in zip(params["convs"], lpips.VGG_CFG):
        idx += 1 if pool else 0
        pre = f"net.slice1.{idx}" if full else f"features.{idx}"
        vgg[f"{pre}.weight"] = torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy())
        vgg[f"{pre}.bias"] = torch.from_numpy(b)
        idx += 2  # conv, relu
    lins = {f"lin{i}.model.1.weight": torch.from_numpy(l.reshape(1, -1, 1, 1))
            for i, l in enumerate(params["lins"])}
    return vgg, lins


def _assert_tree_equal(a, b):
    assert len(a["convs"]) == len(b["convs"]) == 13
    for (w1, b1), (w2, b2) in zip(a["convs"], b["convs"]):
        np.testing.assert_array_equal(w1, w2)
        np.testing.assert_array_equal(b1, b2)
    for l1, l2 in zip(a["lins"], b["lins"]):
        np.testing.assert_array_equal(l1, l2)


def test_lpips_matches_jax():
    import jax.numpy as jnp

    from pixelnerf_tpu.utils import lpips_jax

    params = lpips.random_params(3)
    _assert_tree_equal(params, lpips_jax.random_params(3))
    rng = np.random.default_rng(0)
    im1, im2 = rng.uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(lpips_jax.lpips_distance(params, jnp.asarray(im1), jnp.asarray(im2)))
    got = lpips.lpips_distance(params, torch.from_numpy(im1), torch.from_numpy(im2)).numpy()
    assert got.shape == (3,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    same = lpips.lpips_distance(params, torch.from_numpy(im1), torch.from_numpy(im1)).numpy()
    np.testing.assert_array_equal(same, 0.0)
    fn, jfn = lpips.make_lpips(params, "cpu"), lpips_jax.make_lpips(params)
    nchw = lambda a: np.transpose(a, (0, 3, 1, 2))
    np.testing.assert_allclose(fn(nchw(im1), nchw(im2)), jfn(nchw(im1), nchw(im2)), rtol=1e-5)


def test_weights_load_as_jax_loads_them(tmp_path):
    from pixelnerf_tpu.tools.port_lpips_weights import save_params
    from pixelnerf_tpu.utils import lpips_jax

    params = lpips_jax.random_params(1)
    path = str(tmp_path / "lpips_vgg.npz")
    save_params(params, path)
    _assert_tree_equal(lpips.load_params(path), lpips_jax.load_params(path))
    assert lpips.load_params(str(tmp_path / "absent.npz")) is None
    for full in (False, True):
        vgg, lins = _sd(params, full)
        torch.save(vgg, tmp_path / "vgg.pth")
        torch.save(lins, tmp_path / "lins.pth")
        _assert_tree_equal(lpips.load_state_dicts(str(tmp_path / "vgg.pth"), str(tmp_path / "lins.pth")),
                           params)
        both = {**vgg, **lins}
        _assert_tree_equal(lpips.params_from_state_dicts(both), lpips_jax.params_from_state_dicts(
            {k: v.numpy() for k, v in both.items()}))
    with pytest.raises(ValueError):
        lpips.params_from_state_dicts(vgg)  # no lin heads


def _renders(root):
    """An SRN test split and a render of each view (the GT with noise)."""
    from pixelnerf_tpu_torch.utils.visualize import read_image, write_png
    from tests.fixtures import make_srn_dataset

    datadir = make_srn_dataset(str(root), name="balls", n_objs=2, nv=3, H=32, stages=("test",))
    gt = os.path.join(datadir, "balls_test")
    rng = np.random.default_rng(2)
    out = root / "renders"
    for obj in sorted(os.listdir(gt)):
        os.makedirs(out / obj)
        for v in range(3):
            img = read_image(os.path.join(gt, obj, "rgb", f"{v:06d}.png"))[..., :3].astype(np.int32)
            noisy = np.clip(img + rng.integers(-40, 40, img.shape), 0, 255).astype(np.uint8)
            write_png(str(out / obj / f"{v:06d}.png"), noisy)
    return gt, str(out)


def test_calc_metrics_lpips(tmp_path, monkeypatch):
    from pixelnerf_tpu.eval.calc_metrics import main as jmain
    from pixelnerf_tpu.tools.port_lpips_weights import save_params
    from pixelnerf_tpu.utils import lpips_jax
    from pixelnerf_tpu_torch.eval.calc_metrics import main

    gt, out = _renders(tmp_path)
    monkeypatch.setenv("PIXELNERF_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    got = main(["-D", gt, "-O", out, "-F", "srn", "-P", "0"], device="cpu")
    assert got["total"]["n"] == 2 and np.isnan(got["total"]["lpips"])
    assert np.isfinite(got["total"]["psnr"])

    weights = str(tmp_path / "lpips_vgg.npz")
    save_params(lpips_jax.random_params(0), weights)
    monkeypatch.setenv("PIXELNERF_LPIPS_WEIGHTS", weights)
    got = main(["-D", gt, "-O", out, "-F", "srn", "-P", "0", "--overwrite"], device="cpu")
    jout = str(tmp_path / "jrenders")
    import shutil

    shutil.copytree(out, jout)
    jmain(["-D", gt, "-O", jout, "-F", "srn", "-P", "0", "--overwrite"])
    for obj in sorted(os.listdir(gt)):
        read = lambda d: dict(l.split() for l in open(os.path.join(d, obj, "metrics.txt")))
        mine, theirs = read(out), read(jout)
        assert float(mine["lpips"]) > 0
        np.testing.assert_allclose(float(mine["lpips"]), float(theirs["lpips"]), rtol=1e-5)
    assert np.isfinite(got["total"]["lpips"])
