"""pixelNeRF (Yu et al., CVPR 2021, arXiv:2012.02190): every configuration
without a `family` key.

It binds what exists and moves nothing: the weights' draw stays
`harness/scene.py:make_weights`, the plain reference `reference/pixelnerf.py`
and `reference/train.py`, the work counts `harness/counts.py` and
`harness/mlp_parts.py`, which take the reference's sizes from here. Beside
this file, only `harness/scene.py` uses the pixelNeRF reference:
`make_weights`, bound below, and `view_rays`, whose camera convention
(`reference.pixelnerf.pixel_rays`) gives the program's rays for every
family.
"""

from harness import counts, mlp_parts, scene
from reference import pixelnerf as ref
from reference import train as ref_train

make_weights = scene.make_weights
param_specs = ref.param_specs
run_steps = ref_train.run_steps
draw_render = ref.draw_render
render_view = ref_train.render_view

# the two heads' leaves, and the ResNet trunk's
LEAF_GROUPS = {"mlp": "mlp_", "trunk": "encoder."}


def cell_work(config: dict, traffic: dict) -> dict:
    return counts.cell_work(config, traffic, ref)


def train_parts(config: dict, traffic: dict) -> dict:
    return mlp_parts.train_parts(config, traffic, ref)
