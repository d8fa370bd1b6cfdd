"""A cell at a size the CPU runs in seconds: the srn configuration's
model (every width as published), or another configuration's, on 32x32
images, 8 + 4 samples a ray, a few rays. For the CPU tests only."""

import copy
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import manifest  # noqa: E402


def tiny_cell(kind: str, limits=None, config=None) -> manifest.Cell:
    """srn's cell of `kind`, or with `config` the configuration of that
    name from `benchmark/configs/` under srn's traffic, cut to this size."""
    m = manifest.load_manifest()
    cell = manifest.Cell(m, {"train": "srn.train", "view": "srn.view"}[kind])
    if config is not None:
        with open(manifest.config_path(config)) as f:
            cell.config = json.load(f)
    cfg = copy.deepcopy(cell.config)
    cfg["data"].update(image_hw=[32, 32], views_per_object=4, focal=[32.8, 32.8], c=[16.0, 16.0])
    cfg["conf"]["renderer"].update(n_coarse=8, n_fine=4, n_fine_depth=2)
    cell.config = cfg
    traffic = copy.deepcopy(cell.traffic)
    if kind == "train":
        traffic.update(objects_per_step=2, rays_per_object=16, pool_objects=3, trace_steps=2)
    else:
        traffic.update(chunk_rays=384, pool_objects=2, warm_requests=1, trace_rays=2048,
                       check_rays=2048)
    cell.traffic = traffic
    if limits is not None:
        cell.limits = limits
    return cell
