"""Port hygiene: the port never imports the JAX side, and its entry points
never fall back to the CPU on their own."""

import ast
from pathlib import Path

import pytest
import torch

from pixelnerf_tpu_torch.device import resolve_device
from pixelnerf_tpu_torch.models.pixelnerf import make_model
from pixelnerf_tpu_torch.utils.hocon import load

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pixelnerf_tpu"}
PORT_FILES = sorted((ROOT / "pixelnerf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {
        "field.py", "posenc.py", "pyramid.py", "resnetfc.py", "pixelnerf.py", "losses.py",
        "step.py", "convert.py", "chip_smoke.py", "checkpoint.py", "eval_approx.py",
        "gen_video.py", "eval_mesh.py", "calc_metrics.py", "eval_real.py", "recon.py",
        "isosurface.py", "cameras.py", "video.py", "mesh.py", "launch.py", "lpips.py",
        "preproc.py", "profile_step.py", "export_checkpoint.py", "port_encoder_weights.py",
        "layer_chain.py", "resnetfc_common.py", "camera_gen.py", "make_synthetic_dataset.py", "eval_view_list_gen.py",
        "dtu_resize.py", "flatten_alpha.py", "make_pollen_meshes.py", "stl_render_dataset.py",
        "pose_sanity_check.py", "port_lpips_weights.py", "trace_summary.py", "spans.py",
    } <= names


# a GPU host may lack these: the port reads flax checkpoints with its own
# decoder and writes videos with Pillow where imageio is missing
ABSENT_THERE = {"msgpack", "ml_dtypes", "imageio"}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_needs_no_package_the_card_lacks(path):
    """No module of the port imports msgpack or ml_dtypes; imageio only
    `utils/video.py`, optionally (inside a try, for mp4)."""
    allowed = {"imageio"} if path.name == "video.py" else set()
    bad = sorted(set(_imported_roots(path)) & ABSENT_THERE - allowed)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("cli", ["eval_approx", "gen_video", "eval_mesh", "calc_metrics", "eval_real"])
def test_eval_cli_without_device_raises_when_no_gpu(cli, monkeypatch, tmp_path):
    """Each eval CLI's `main(argv)` runs on CUDA unless given a device: with
    no card and no device it raises before touching data (calc_metrics runs
    on the host and reduces an empty output instead)."""
    import importlib

    mod = importlib.import_module(f"pixelnerf_tpu_torch.eval.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if cli == "calc_metrics":
        assert mod.main(["-D", str(tmp_path), "-O", str(tmp_path)])["total"]["n"] == 0
        return
    argv = ["-c", str(ROOT / "conf" / "exp" / "srn600.conf"), "-D", str(tmp_path / "none"),
            "--checkpoints_path", str(tmp_path / "c"), "--visual_path", str(tmp_path / "v")]
    if cli == "eval_real":
        argv += ["-I", str(tmp_path / "in"), "-O", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)


def test_entry_point_without_device_raises_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = load(str(ROOT / "conf" / "exp" / "srn.conf"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_model(conf["model"])
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    from pixelnerf_tpu_torch.ops.field import FieldWeights, pyramid_field_fused
    from pixelnerf_tpu_torch.ops.posenc import posenc_concat
    from pixelnerf_tpu_torch.ops.resnetfc import resnetfc_bwd, resnetfc_fwd, resnetfc_fwd_stash

    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError):
        posenc_concat(meta, meta, 6, 1.5)

    def t(*shape):
        return torch.empty(shape, device="meta")

    w = FieldWeights(
        w_in=t(42, 16), b_in=t(16), wz=t(1, 32, 16), bz=t(1, 16), w0=t(2, 16, 16),
        b0=t(2, 16), w1=t(2, 16, 16), b1=t(2, 16), w_out=t(16, 4), b_out=t(4),
    )
    before = pyramid_field_fused.launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pyramid_field_fused([t(2, 8, 8, 32)], t(1, 2, 5, 2), t(1, 2, 5, 42), w, 2, 1, 2)
    assert pyramid_field_fused.launches == before
    mlp = (resnetfc_fwd, resnetfc_fwd_stash, resnetfc_bwd)
    before = [f.launches for f in mlp]
    z, xin = t(1, 2, 5, 32), t(1, 2, 5, 42)
    for fn in mlp[:2]:
        with pytest.raises(ValueError, match="CUDA or CPU"):
            fn(z, xin, w, 2, 1, 2)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        resnetfc_bwd(z, xin, t(1, 5, 4), t(2, 1, 2, 5, 16), t(3, 1, 5, 16), w, 2, 1, 2)
    assert [f.launches for f in mlp] == before
