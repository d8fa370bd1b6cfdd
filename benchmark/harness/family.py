"""A configuration's model family and its rig kinds, found by name.

`load(name)` is `benchmark/families/<name>.py`, run once a process. A
family file binds what the harness needs of one model by name:

- `make_weights(model_conf, seed, device)`: every parameter, drawn on the
  device from the seed, named as the program names them;
- `param_specs(model_conf)`: (name, shape, kind) of each of them;
- `run_steps(...)` and `draw_render(gen, n_rays, rend, device)`: the plain
  reference's first training steps and the renderer's draws, in the
  program's order (`harness/train_cell.py:reference_truth`,
  `calibrate.py:step_states`);
- `render_view(P, model_conf, rend, src_u8, src_c2w, focal, c, rays, seed,
  chunk, prec)`: the plain reference's view;
- `cell_work(config, traffic)`: operations and bytes of a step or a view
  (`harness/runrec.py:Run.work`);
- `LEAF_GROUPS`: {group: parameter-name prefix}, each group's median leaf
  compared as `<group>_grad_err_median` (`harness/check.py`);
- `train_parts(config, traffic)`, where `span_readings.py` reads a
  training cell's MLP spans.

`rig(kind)` is `benchmark/rigs/<kind>.py`, whose `poses(data, objects,
rng)` gives (objects, views, 4, 4) camera-to-world poses.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

from harness import manifest


@functools.lru_cache(maxsize=None)
def _load(path: Path, module_name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return manifest.load_file(path, module_name)


def load(name: str):
    """The family file of `name`, once a process."""
    return _load(manifest.family_path(name), "bench_family_" + re.sub(r"\W", "_", name))


def rig(kind: str):
    """The rig file of `kind`, once a process."""
    return _load(manifest.rig_path(kind), "bench_rig_" + re.sub(r"\W", "_", kind))
