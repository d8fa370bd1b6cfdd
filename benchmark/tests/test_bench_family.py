"""The model-family seam: each configuration's family file and rig kinds
are found by name, and the pixelnerf family gives what the harness gave
before there were families.

The literal values were taken from the harness as it stood before the
seam, on the CPU: the weights' bytes (sha256 over every leaf's name,
shape and float32 bytes, in order), `cell_work` of each cell, the sums of
a reference view on `bench_tiny`'s configuration, and the rigs' poses."""

import hashlib
import json
import shutil
import textwrap

import pytest
import torch

from bench_tiny import tiny_cell
from harness import check, family, manifest, scene, train_cell, view_cell

SEED = 2 ** 33 + 17
PIXELNERF_WEIGHTS = ("8b3ad4484bb4cd203e409228d065dbd2620327456a95790b9b8962bc84f6be3b", 205,
                     15057352)
WORK = {
    "srn.train": {"mlp_flops": 22854594723840.0, "mlp_least_s": 0.023108791429565217,
                  "encoder_flops": 46732935168.0, "model_flops": 22901327659008.0,
                  "rays": 4096.0},
    "srn.view": {"field_least_s": 0.030811721906086956, "mlp_flops": 30472792965120.0,
                 "encoder_flops": 3945791488.0, "model_flops": 30476738756608.0,
                 "rays": 16384.0},
    "dtu.view": {"field_least_s": 0.34746241997265925, "mlp_flops": 314612121600000.0,
                 "encoder_flops": 43772467200.0, "model_flops": 314655894067200.0,
                 "rays": 120000.0},
    "dtu.train": {"mlp_flops": 32216281251840.0, "mlp_least_s": 0.032574601872436805,
                  "encoder_flops": 518495846400.0, "model_flops": 32734777098240.0,
                  "rays": 4096.0},
    "sn64.train": {"mlp_flops": 13492908195840.0, "mlp_least_s": 0.01364298098669363,
                   "encoder_flops": 22904045568.0, "model_flops": 13515812241408.0,
                   "rays": 4096.0},
}
# {head: {output: [sum, sum of value x (1-based flat index)]}} of 96 rays
# of the tiny view's request 3, in 64-ray chunks
VIEW = {
    "coarse": {"rgb": [165.64964562654495, 23942.813998639584],
               "depth": [91.38310515880585, 4422.290605068207],
               "alpha": [81.01343375444412, 3923.150927066803]},
    "fine": {"rgb": [168.87181654572487, 24403.972194314003],
             "depth": [93.22088730335236, 4511.98117184639],
             "alpha": [83.16095525026321, 4026.9640820622444]},
}
RIGS = {
    "srn": "24b1702fc626988b448b15fde4fef548b4276a51a314fed761f56b66a9ba7eb6",
    "dtu": "d5354675da187fc99591aab9c299062023f2aa24951ec2b8af2b7f423c05a693",
    "sn64": "2ec921945043b17ea7913f83336ba1932db66ce5edd74697b1f152bbdce7464e",
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(name):
    with open(manifest.config_path(name)) as f:
        return json.load(f)


def _digest(weights):
    h = hashlib.sha256()
    for name, t in weights.items():
        h.update(f"{name}:{tuple(t.shape)}:".encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest(), len(weights), sum(t.numel() for t in weights.values())


@pytest.mark.parametrize("name", ["srn", "dtu", "sn64"])
def test_pixelnerf_weights_as_before(name):
    config = _config(name)
    assert manifest.family_of(config) == "pixelnerf"
    fam = family.load("pixelnerf")
    weights = fam.make_weights(config["conf"]["model"], SEED, "cpu")
    assert _digest(weights) == PIXELNERF_WEIGHTS
    assert [n for n, _, _ in fam.param_specs(config["conf"]["model"])] == list(weights)


@pytest.mark.parametrize("name", ["srn", "dtu", "sn64"])
def test_built_in_rigs_as_before(name):
    poses = scene.make_rig(_config(name)["data"], 3, SEED)
    assert hashlib.sha256(poses.tobytes()).hexdigest() == RIGS[name]


@pytest.mark.parametrize("workload", sorted(WORK))
def test_cell_work_as_before(workload):
    m = manifest.load_manifest()
    if workload in {w["name"] for w in m["workloads"]}:
        cell = manifest.Cell(m, workload)
        config, traffic, fam = cell.config, cell.traffic, family.load(cell.family)
    else:
        # sn64.train: prepared and left out of BENCHMARK.json
        config = _config("sn64")
        with open(manifest.traffic_path("train_steps")) as f:
            traffic = json.load(f)
        fam = family.load(manifest.family_of(config))
    assert fam.cell_work(config, traffic) == WORK[workload]


def test_render_view_as_before():
    cell = tiny_cell("view")
    data, conf = cell.config["data"], cell.config["conf"]
    fam = family.load(cell.family)
    p0 = fam.make_weights(conf["model"], SEED, "cpu")
    pool = scene.Pool(data, int(cell.traffic["pool_objects"]), SEED, "cpu")
    reqs = view_cell.Requests(pool, int(data["source_views"]), SEED, "cpu")
    src_u8, src_c2w = reqs.sources(3)
    rays = scene.view_rays(pool, reqs.target(3))[:96]
    view = fam.render_view(p0, conf["model"], conf["renderer"], src_u8, src_c2w,
                           torch.from_numpy(pool.focal), torch.from_numpy(pool.c), rays,
                           reqs.seed(3), 64)
    assert set(view) == set(VIEW)
    for head, outputs in VIEW.items():
        assert set(view[head]) == set(outputs)
        for key, (total, weighted) in outputs.items():
            v = view[head][key].double().flatten()
            # float32 sums in another thread split move the last digits
            assert float(v.sum()) == pytest.approx(total, rel=1e-6)
            index = torch.arange(1, v.numel() + 1, dtype=torch.float64)
            assert float((v * index).sum()) == pytest.approx(weighted, rel=1e-6)


TOY_FAMILY = textwrap.dedent('''
    """A toy family: one leaf per group, a reference that renders grey."""
    import torch

    LEAF_GROUPS = {"head": "head.", "body": "body."}
    SPECS = [("body.w", (3, 2), "linear"), ("head.w", (2,), "linear")]


    def param_specs(model_conf):
        return SPECS


    def make_weights(model_conf, seed, device):
        g = torch.Generator(device=device)
        g.manual_seed(seed % 2 ** 63)
        return {n: torch.randn(s, generator=g, device=device) for n, s, _ in SPECS}


    def draw_render(gen, n_rays, rend, device):
        return {"jitter": torch.rand((n_rays, 1), generator=gen, device=device)}


    def run_steps(P0, specs, model_conf, rend, loss_conf, batches, gen_states, num_rays, lr,
                  prec="float32", fault=None):
        assert [n for n, _, _ in specs] == list(P0)
        grad = {n: torch.ones_like(t) for n, t in P0.items()}
        params = {n: t - lr * len(batches) for n, t in P0.items()}
        return {"losses": [1.0] * len(batches), "grad1": grad, "params": params}


    def render_view(P, model_conf, rend, src_u8, src_c2w, focal, c, rays, seed, chunk,
                    prec="float32"):
        n = rays.shape[0]
        grey = torch.full((n,), 0.5, device=rays.device)
        return {"coarse": {"rgb": grey[:, None].expand(n, 3), "depth": grey, "alpha": grey}}


    def cell_work(config, traffic):
        return {"model_flops": 1.0, "rays": 1.0}
''')

TOY_RIG = textwrap.dedent('''
    """A toy rig: cameras on a line in front of the origin."""
    import numpy as np


    def poses(data, objects, rng):
        views = int(data["views_per_object"])
        out = np.tile(np.eye(4), (objects, views, 1, 1))
        out[..., 0, 3] = rng.uniform(-1, 1, (objects, views))
        out[..., 2, 3] = 2.0
        return out
''')


@pytest.fixture
def toy_dirs(tmp_path, monkeypatch):
    """The toy family and rig as new files in directories of their own,
    beside a copy of the pixelnerf family."""
    (tmp_path / "families").mkdir()
    (tmp_path / "rigs").mkdir()
    shutil.copy(manifest.family_path("pixelnerf"), tmp_path / "families")
    (tmp_path / "families" / "toy.py").write_text(TOY_FAMILY)
    (tmp_path / "rigs" / "line.py").write_text(TOY_RIG)
    monkeypatch.setattr(manifest, "FAMILIES_DIR", tmp_path / "families")
    monkeypatch.setattr(manifest, "RIGS_DIR", tmp_path / "rigs")
    return tmp_path


def _toy(kind, config_dir, monkeypatch, family_name="toy", rig_kind="line"):
    """The srn cell of `kind` at bench_tiny's size, its configuration
    written to `config_dir` naming the family and the rig kind."""
    cell = tiny_cell(kind)
    config = dict(cell.config, family=family_name)
    config["data"] = dict(config["data"], rig={"kind": rig_kind})
    (config_dir / "toy.json").write_text(json.dumps(config))
    shipped = manifest.config_path
    monkeypatch.setattr(manifest, "config_path",
                        lambda name: config_dir / "toy.json" if name == "toy" else shipped(name))
    m = {"workloads": [{"name": "toy.x", "config": "toy", "traffic": cell.entry["traffic"],
                        "chips": 1, "why": "toy"}], "end_to_end": [], "per_layer": []}
    monkeypatch.setattr(manifest, "limits_path",
                        lambda w: manifest.BENCH_DIR / "limits" / f"{cell.name}.json")
    toy = manifest.Cell(m, "toy.x")
    toy.traffic = cell.traffic
    return toy


def test_toy_family_and_rig_run_through_the_reference_side(toy_dirs, monkeypatch):
    cell = _toy("train", toy_dirs, monkeypatch)
    assert cell.family == "toy"
    fam = family.load("toy")
    assert family.load("toy") is fam
    poses = scene.make_rig(cell.config["data"], 3, SEED)
    assert poses.shape == (3, 4, 4, 4) and poses.dtype == "float32"
    assert (poses == scene.make_rig(cell.config["data"], 3, SEED)).all()

    states = [scene.generator(SEED, "step", "cpu").get_state()] * 2
    truth, p0 = train_cell.reference_truth(cell, SEED, states, "cpu")
    assert set(p0) == {"body.w", "head.w"} and truth["losses"] == [1.0, 1.0]
    numbers = check.train_numbers(truth, truth, p0, fam.LEAF_GROUPS)
    assert numbers["head_grad_err_median"] == numbers["body_grad_err_median"] == 0.0
    assert "mlp_grad_err_median" not in numbers

    view = _toy("view", toy_dirs, monkeypatch)
    grey = {"coarse": {k: torch.full(s, 0.5) for k, s in
                       (("rgb", (1024, 3)), ("depth", (1024,)), ("alpha", (1024,)))}}
    first = int(view.traffic["warm_requests"])
    got = view_cell.reference_numbers(view, SEED, {first: grey, first + 1: grey}, "cpu")
    assert got["rgb_mae"] == got["rgb_mae_median"] == 0.0
    assert family.load(view.family).cell_work(view.config, view.traffic)["rays"] == 1.0


@pytest.mark.parametrize("what", ["family", "rig"])
def test_unknown_family_or_rig_fails_naming_the_path(what, toy_dirs, monkeypatch):
    names = {"family_name": "nosuch"} if what == "family" else {"rig_kind": "nosuch"}
    want = toy_dirs / ("families" if what == "family" else "rigs") / "nosuch.py"
    with pytest.raises(FileNotFoundError, match=str(want)):
        _toy("view", toy_dirs, monkeypatch, **names)
    loader = family.load if what == "family" else family.rig
    with pytest.raises(FileNotFoundError, match=str(want)):
        loader("nosuch")
