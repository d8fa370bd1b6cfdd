"""The benchmark's manifest (`BENCHMARK.json`) and the files it names.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by its name:

- `benchmark/configs/<config>.json`: the model and renderer settings as
  run, the data's sizes and rig, `source`, `reduced`, `assumed`, and the
  model's `family` (`pixelnerf` where the key is left out);
- `benchmark/families/<family>.py`: what the harness needs of one model
  family by name: its seeded weights, its plain reference, its work
  counts and the leaf groups of its gradient check (`harness/family.py`);
- `benchmark/rigs/<kind>.py`: a camera rig other than the built-in
  `sphere` and `grid` (`harness/scene.py:make_rig`);
- `benchmark/traffic/<traffic>.json`: the parameters of one mix, read by
  the general generators of `harness/train_cell.py` (`"kind": "train"`) or
  `harness/view_cell.py` (`"kind": "view"`);
- `benchmark/metrics/<metric>.py`: the reader of one per-layer metric;
- `benchmark/limits/<workload>.json`: the limits of the cell's comparison
  with the reference, with the readings they were set from.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FAMILIES_DIR = BENCH_DIR / "families"
RIGS_DIR = BENCH_DIR / "rigs"
DEFAULT_FAMILY = "pixelnerf"
BUILT_IN_RIGS = ("sphere", "grid")  # drawn by harness/scene.py:make_rig itself


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config_path(name: str) -> Path:
    return BENCH_DIR / "configs" / f"{name}.json"


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"


def limits_path(workload: str) -> Path:
    return BENCH_DIR / "limits" / f"{workload}.json"


def family_path(name: str) -> Path:
    return FAMILIES_DIR / f"{name}.py"


def rig_path(kind: str) -> Path:
    return RIGS_DIR / f"{kind}.py"


def config_files(config: dict) -> dict:
    """{what: path} of the files a configuration names besides itself: its
    family's and, for a rig kind that is not built in, its rig's."""
    files = {f"family {family_of(config)!r}": family_path(family_of(config))}
    kind = config["data"]["rig"]["kind"]
    if kind not in BUILT_IN_RIGS:
        files[f"rig kind {kind!r}"] = rig_path(kind)
    return files


def family_of(config: dict) -> str:
    return config.get("family", DEFAULT_FAMILY)


class Cell:
    """One workload of the manifest, with its configuration, traffic mix,
    limits and the metrics it reports."""

    def __init__(self, manifest: dict, workload: str):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        self.config = _read_json(config_path(self.entry["config"]))
        for what, path in config_files(self.config).items():
            if not path.is_file():
                raise FileNotFoundError(f"configuration {self.entry['config']!r} names {what}, "
                                        f"but there is no file {path}")
        self.traffic = _read_json(traffic_path(self.entry["traffic"]))
        self.limits = _read_json(limits_path(workload))
        self.end_to_end = [m for m in manifest["end_to_end"] if _covers(m, workload)]
        self.per_layer = [m for m in manifest["per_layer"] if _covers(m, workload)]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def family(self) -> str:
        return family_of(self.config)


def _covers(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_file(path: Path, module_name: str):
    """The Python file at `path`, run as a module of its own."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str):
    """The `read(run)` function of `benchmark/metrics/<metric>.py`."""
    return load_file(metric_path(metric), f"bench_metric_{metric.replace('.', '_')}").read
