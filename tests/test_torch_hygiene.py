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
    assert {"field.py", "posenc.py", "pixelnerf.py", "chip_smoke.py"} <= names


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
