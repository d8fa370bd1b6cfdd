"""What the benchmark may import.

Nothing under `benchmark/` imports JAX or the JAX package, and the
reference imports nothing of the program either. Module names are
compared by their top-level name, whole: `pixelnerf_tpu_torch` is the
program, `pixelnerf_tpu` the JAX package.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List, Set

JAX_SIDE = frozenset({"jax", "jaxlib", "flax", "optax", "pixelnerf_tpu"})
PROGRAM = frozenset({"pixelnerf_tpu_torch"})
BENCH_DIR = Path(__file__).resolve().parents[1]


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def imported_roots(path: Path) -> Set[str]:
    """Top-level names of every module a source file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(top_level(node.module))
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(top_level(str(node.args[0].value)))
    return roots


def source_violations(bench_dir: Path = BENCH_DIR) -> List[str]:
    """Files under `bench_dir` that import the JAX side, and files of the
    reference that import the program."""
    bad = []
    for path in sorted(bench_dir.rglob("*.py")):
        roots = imported_roots(path)
        forbidden = JAX_SIDE | (PROGRAM if "reference" in path.relative_to(bench_dir).parts else set())
        hit = sorted(roots & forbidden)
        if hit:
            bad.append(f"{path.relative_to(bench_dir)} imports {hit}")
    return bad


def loaded_jax_side(modules: Iterable[str] = None) -> List[str]:
    """Modules of the JAX side loaded in this process."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in JAX_SIDE)
