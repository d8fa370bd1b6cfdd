"""Nothing under benchmark/ imports JAX or the JAX package, the reference
imports nothing of the program, and a run loads neither."""

import subprocess
import sys
import textwrap

from bench_tiny import BENCH_DIR
from harness import guard


def test_sources_import_nothing_forbidden():
    assert guard.source_violations() == []


def test_top_level_names_compared_whole():
    assert guard.top_level("pixelnerf_tpu_torch.models") == "pixelnerf_tpu_torch"
    assert guard.loaded_jax_side(["pixelnerf_tpu_torch", "pixelnerf_tpu_torch.ops"]) == []
    assert guard.loaded_jax_side(["pixelnerf_tpu.models", "jaxlib", "jaxtyping"]) == [
        "jaxlib", "pixelnerf_tpu.models"]


def test_scan_sees_a_planted_import(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "bad.py").write_text("import pixelnerf_tpu_torch.ops\n")
    (tmp_path / "ok.py").write_text("import pixelnerf_tpu_torch.ops\nimport jax.numpy\n")
    assert guard.source_violations(tmp_path) == [
        "ok.py imports ['jax']", "reference/bad.py imports ['pixelnerf_tpu_torch']"]


def test_a_run_loads_no_jax_side():
    code = textwrap.dedent("""
        import sys, torch
        torch.set_num_threads(2)
        sys.path.insert(0, %r)
        from bench_tiny import tiny_cell
        import run
        from harness import guard
        res = run.run_cell(tiny_cell("view"), 11, 0.1, False, "cpu")
        assert res["attempted"] >= 1
        print("LOADED", guard.loaded_jax_side())
    """ % str(BENCH_DIR / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
