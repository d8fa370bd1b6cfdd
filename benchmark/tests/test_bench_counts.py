"""The operation and byte counts against counts made by hand."""

import json

import pytest

import bench_tiny  # noqa: F401  (puts the benchmark on sys.path)
from harness import counts, family, manifest
from reference import pixelnerf as ref

MLP = {"d_hidden": 4, "n_blocks": 3, "combine_layer": 2}


def test_mlp_forward_by_hand():
    # 6 rows of 2 views; d_in 3, d_latent 5, hidden 4, out 4
    pre = 6 * (3 * 4 + 2 * 5 * 4 + 2 * 2 * 4 * 4)
    post = 3 * (1 * 2 * 4 * 4 + 4 * 4)
    assert counts.mlp_forward_flops(MLP, 3, 5, 6, 2) == 2 * (pre + post)


def test_backward_twice_forward_and_bytes():
    f, b = counts.mlp_stash_forward(MLP, 3, 5, 6, 2)
    g, c = counts.mlp_backward(MLP, 3, 5, 6, 2)
    assert g == 2 * f
    params = (3 + 1) * 4 + 2 * (5 + 1) * 4 + 3 * 2 * (4 + 1) * 4 + (4 + 1) * 4
    assert counts.mlp_params(MLP, 3, 5) == params
    assert b == 6 * 8 * 2 + params * 4 + 3 * 4 * 4
    assert c == 6 * 8 * 2 + 3 * 4 * 4 + params * 4 + 6 * 5 * 2 + params * 4


def test_field_and_lookup_bytes():
    levels = [(4, 4, 8), (2, 2, 8)]
    f, b = counts.field_primal(MLP, 3, 5, 6, 2, levels, 2)
    assert f == counts.mlp_forward_flops(MLP, 3, 5, 6, 2)
    lv = 2 * (16 * 8 + 4 * 8) * 2
    assert b == lv + 6 * (8 + 6) + counts.mlp_params(MLP, 3, 5) * 4 + 3 * 4 * 4
    assert counts.pyramid_gather(6, levels, 2, 16) == (0.0, lv + 48 + 6 * 16 * 2)
    assert counts.pyramid_scatter(6, levels, 2, 16) == (0.0, 6 * 16 * 2 + 48 + lv * 2)


def test_trunk_convolutions_by_hand():
    enc = {"backbone": "resnet18", "num_layers": 2}
    convs = counts.trunk_convs(enc, 32, 32, ref)
    # stem 7x7/2 -> 16x16, pool -> 8x8, layer1: two blocks of two 3x3 convs
    assert convs[0] == (3, 64, 7, 2, 16, 16)
    assert convs[1:] == [(64, 64, 3, 1, 8, 8)] * 4
    fwd = 2 * (16 * 16 * 64 * 3 * 49 + 4 * 8 * 8 * 64 * 64 * 9)
    assert counts.encoder_flops(enc, 1, 32, 32, train=False, arch=ref) == fwd
    train = 2 * 2 * 16 * 16 * 64 * 3 * 49 + 3 * 2 * 4 * 8 * 8 * 64 * 64 * 9
    assert counts.encoder_flops(enc, 1, 32, 32, train=True, arch=ref) == train


def test_trunk_without_first_pool_by_hand():
    # sn64.conf: no max-pool after the 7x7/2 stem, so layer1 runs at the
    # stem's 32x32 and each later stage halves it
    enc = {"backbone": "resnet34", "num_layers": 4, "use_first_pool": False}
    convs = counts.trunk_convs(enc, 64, 64, ref)
    assert convs[0] == (3, 64, 7, 2, 32, 32)
    assert convs[1:7] == [(64, 64, 3, 1, 32, 32)] * 6
    assert convs[7:10] == [(64, 128, 3, 2, 16, 16), (128, 128, 3, 1, 16, 16),
                           (64, 128, 1, 2, 16, 16)]
    assert convs[10:16] == [(128, 128, 3, 1, 16, 16)] * 6
    assert convs[16:19] == [(128, 256, 3, 2, 8, 8), (256, 256, 3, 1, 8, 8),
                            (128, 256, 1, 2, 8, 8)]
    assert convs[19:] == [(256, 256, 3, 1, 8, 8)] * 10
    fwd = 32 * 32 * 64 * 3 * 49 + 6 * 32 * 32 * 64 * 64 * 9
    fwd += 16 * 16 * (128 * 64 * 9 + 7 * 128 * 128 * 9 + 128 * 64)
    fwd += 8 * 8 * (256 * 128 * 9 + 11 * 256 * 256 * 9 + 256 * 128)
    assert counts.encoder_flops(enc, 1, 64, 64, train=False, arch=ref) == 2 * fwd
    # the levels: stem and layer1 at 32x32, layer2 at 16x16, layer3 at 8x8
    assert counts.latent_levels(64, 64, use_first_pool=False) == [
        (32, 32, 128), (16, 16, 128), (8, 8, 256)]
    assert counts.latent_levels(64, 64) == [(32, 32, 128), (8, 8, 128), (4, 4, 256)]
    assert counts.trunk_convs({**enc, "use_first_pool": True}, 64, 64, ref)[1][4:] == (16, 16)


def test_resnet34_levels_and_downsamples():
    enc = {"backbone": "resnet34", "num_layers": 4}
    convs = counts.trunk_convs(enc, 128, 128, ref)
    assert len(convs) == 1 + 2 * (3 + 4 + 6) + 2
    assert convs[-1][4:] == (8, 8)
    assert counts.latent_levels(128, 128) == [(64, 64, 128), (16, 16, 128), (8, 8, 256)]
    assert counts.latent_levels(300, 400) == [(150, 200, 128), (38, 50, 128), (19, 25, 256)]


@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load_manifest()["workloads"]])
def test_cell_work_is_positive_and_below_peak_share(workload):
    cell = manifest.Cell(manifest.load_manifest(), workload)
    work = family.load(cell.family).cell_work(cell.config, cell.traffic)
    assert work["model_flops"] > work["mlp_flops"] > 0
    if cell.kind == "train":
        # srn's step of 4,096 rays: 22.85 TFLOP of MLP (PERF.md), forward +
        # 2x backward, ~5.6 GFLOP a ray
        rays = cell.traffic["objects_per_step"] * cell.traffic["rays_per_object"]
        assert 3.5e9 < work["mlp_flops"] / rays < 15e9
    else:
        assert work["field_least_s"] > 0


def test_sn64_step_by_hand():
    # sn64.conf's step under train_steps: 4 objects x 1,024 rays, one view,
    # so the rows before the pooling are the rows after it
    with open(manifest.config_path("sn64")) as f:
        config = json.load(f)
    with open(manifest.traffic_path("train_steps")) as f:
        traffic = json.load(f)
    work = family.load("pixelnerf").cell_work(config, traffic)
    rows = 4096 * (64 + 96)
    d_in, d_lat, h = 3 + 6 * 2 * 3 + 3, 512, 512
    fwd = 2 * rows * (d_in * h + 3 * d_lat * h + 5 * 2 * h * h + h * 4)
    assert work["mlp_flops"] == 3 * fwd == pytest.approx(13.4929e12, rel=1e-5)
    trunk = counts.encoder_flops(config["conf"]["model"]["encoder"], 4, 64, 64, train=True,
                                 arch=ref)
    assert work["encoder_flops"] == trunk
