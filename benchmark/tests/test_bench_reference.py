"""The reference against the program's plain CPU path at a tiny size.

In float32 the program runs the exact per-layer chain here, so the two
differ by float32 rounding alone: a view to 1e-6, a first step's loss to
1e-5 and its gradients to 5e-3 of the leaf (BatchNorm's batch statistics
in another order of sums). In bfloat16 (the kernels' plain versions) the
gaps are the configuration's rounding, well under the cells' limits."""

import pytest
import torch

from bench_tiny import tiny_cell
from harness import scene
from reference import pixelnerf as ref
import run


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TRAIN_NUMBERS = ("loss_gap", "grad_gap", "grad_gap_median", "mlp_grad_err_median", "update_gap",
                 "update_gap_median")
VIEW_NUMBERS = ("rgb_mae", "depth_mae", "alpha_mae")


def _cell(kind, dtype, steps=1, first_pool=None):
    names = TRAIN_NUMBERS if kind == "train" else VIEW_NUMBERS
    # every number printed; the limits are not what these tests judge
    cell = tiny_cell(kind, {"numbers": {n: {"limit": 1.0} for n in names}})
    cell.config["conf"]["model"]["dtype"] = dtype
    if first_pool is not None:
        cell.config["conf"]["model"]["encoder"]["use_first_pool"] = first_pool
    cell.traffic["truth_steps"] = steps
    return cell


# use_first_pool false: the stem's max-pool skipped, as sn64.conf has it
@pytest.mark.parametrize("first_pool", [True, False])
def test_float32_view_agrees(first_pool):
    got = run.run_cell(_cell("view", "float32", first_pool=first_pool), 5, 0.1, False,
                       "cpu")["check"]
    assert max(v["value"] for v in got.values()) < 1e-6


@pytest.mark.parametrize("first_pool", [True, False])
def test_float32_first_step_agrees(first_pool):
    got = run.run_cell(_cell("train", "float32", first_pool=first_pool), 5, 0.1, False,
                       "cpu")["check"]
    assert got["loss_gap"]["value"] < 1e-5
    assert got["grad_gap"]["value"] < 5e-3
    assert got["update_gap"]["value"] < 5e-3


def test_bfloat16_gaps_are_rounding():
    view = run.run_cell(_cell("view", "bfloat16"), 5, 0.1, False, "cpu")["check"]
    assert view["rgb_mae"]["value"] < 5e-3
    step = run.run_cell(_cell("train", "bfloat16", 3), 5, 0.1, False, "cpu")["check"]
    assert step["loss_gap"]["value"] < 0.05


def test_param_names_are_the_programs():
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.utils.hocon import ConfigTree

    conf = tiny_cell("train").config["conf"]
    model = make_model(ConfigTree(conf)["model"], device="cpu")
    want = {n: tuple(s) for n, s, _ in ref.param_specs(conf["model"])}
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == want


def test_weights_and_scenes_repeat_from_the_seed():
    conf = tiny_cell("train").config
    a = scene.make_weights(conf["conf"]["model"], 2 ** 40 + 3, "cpu")
    b = scene.make_weights(conf["conf"]["model"], 2 ** 40 + 3, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    p, q = scene.Pool(conf["data"], 2, 9, "cpu"), scene.Pool(conf["data"], 2, 9, "cpu")
    assert torch.equal(p.images_u8, q.images_u8) and torch.equal(p.c2w, q.c2w)
    r = scene.Pool(conf["data"], 2, 10, "cpu")
    assert not torch.equal(p.images_u8, r.images_u8)
    assert r.images_u8.shape == p.images_u8.shape


def test_fp8_control_moves_a_view_more_than_bfloat16():
    cell = tiny_cell("view")
    conf, data = cell.config["conf"], cell.config["data"]
    p0 = scene.make_weights(conf["model"], 3, "cpu")
    pool = scene.Pool(data, 1, 3, "cpu")
    rays = scene.view_rays(pool, pool.c2w[0, 3])
    from reference import train as rt
    args = (p0, conf["model"], conf["renderer"], pool.images_u8[0, :2], pool.c2w[0, :2],
            torch.from_numpy(pool.focal), torch.from_numpy(pool.c), rays, 1, 384)
    f32, fp8 = rt.render_view(*args, "float32"), rt.render_view(*args, "fp8")
    gap = (f32["fine"]["rgb"] - fp8["fine"]["rgb"]).abs().mean()
    assert gap > 1e-3


def test_tf32_follows_the_configuration_and_the_reference_gives_it_back():
    from harness import precision

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    before = flags()
    try:
        precision.as_stated({"dtype": "float32"})
        assert flags() == (False, False)
        precision.as_stated({"dtype": "bfloat16"})
        assert flags() == precision._DEFAULTS
        torch.backends.cudnn.allow_tf32 = True
        with ref.exact_float32():
            assert flags() == (False, False)
        assert flags() == (before[0], True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_bfloat16_program_is_the_float32_configurations_control():
    import calibrate

    cell = tiny_cell("train", config="sn64")
    cell.traffic["truth_steps"] = 1
    sound = calibrate.sound(cell, 7, "cpu")
    got = calibrate.train_readings(cell, 7, "cpu")
    assert set(got) == {"control", "half_batch", "control_bf16"}
    # here the float32 program rounds as the reference does, to 1e-3 of a
    # trunk leaf; at bfloat16 its trunk reads tens of percent off
    assert got["control_bf16"]["trunk_grad_err_median"] > 30 * sound["trunk_grad_err_median"]
    srn = tiny_cell("train")
    srn.traffic["truth_steps"] = 1
    assert set(calibrate.train_readings(srn, 7, "cpu")) == {"control", "half_batch"}
