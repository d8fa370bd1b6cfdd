"""Readings that the limits of `limits/<workload>.json` are set from.

    python3 benchmark/calibrate.py --workload srn.train --seeds 12 --controls 3 --out r.json

in one process, on the card: the program's sound runs on `--seeds` seeds
(the cell's own path and sizes, a short window), then on `--controls`
seeds the control and the cell's faults, each put in the program's place
and compared with the float32 reference as a run compares the program:

- control: the reference computed in float8 as float8 training does (e4m3
  operands, e5m2 cotangents into the backward's products), one precision
  below a bfloat16 configuration;
- train cells of a float32 configuration, `control_bf16`: the program
  itself at `dtype = bfloat16`, its own path one precision below, on the
  same seed and weights;
- train cells, `half_batch`: the reference's step with the second half of
  the batch's objects left out of the loss, the mean taken over the rest (a
  state left unchanged reads 1 by the gap of the parameters' change and
  needs no run);
- view cells, `half_rays`: every chunk's second half of rays left
  unrendered (zero), and `altered`: the fine head's rgb moved by 0.05.

A limit goes above the largest sound reading and below the least reading
of the control and of the faults that read ten times the sound one.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import check, family, manifest, scene, train_cell, view_cell  # noqa: E402

def sound(cell, seed: int, device="cuda") -> dict:
    """The numbers of one run of the program (`--trace 0`): a training
    cell's first steps and one more, or as many views as a run checks."""
    if cell.kind == "train":
        return train_cell.run(cell, seed, 0.0, False, device, time.perf_counter())["numbers"]
    per_view = 2.5 if max(cell.config["data"]["image_hw"]) > 200 else 0.2
    seconds = per_view * -(-int(cell.traffic["check_rays"]) // _rays_per_view(cell))
    return view_cell.run(cell, seed, seconds, False, device, time.perf_counter())["numbers"]


def _rays_per_view(cell) -> int:
    h, w = cell.config["data"]["image_hw"]
    return h * w


def step_states(cell, seed: int, device):
    """The step generator's states before each of the first steps, as
    the program's steps leave it: what each step draws, drawn."""
    data, traffic, rend = cell.config["data"], cell.traffic, cell.config["conf"]["renderer"]
    gen = scene.generator(seed, "step", device)
    rays, sb = int(traffic["rays_per_object"]), int(traffic["objects_per_step"])
    pixels = int(data["views_per_object"]) * data["image_hw"][0] * data["image_hw"][1]
    states = []
    for _ in range(int(traffic["truth_steps"])):
        states.append(gen.get_state())
        torch.randint(0, pixels, (sb, rays), generator=gen, device=device)
        family.load(cell.family).draw_render(gen, sb * rays, rend, device)
    return states


def train_readings(cell, seed: int, device="cuda") -> dict:
    """The control and the half-batch fault, each in the program's place;
    for a float32 configuration also the program at bfloat16."""
    states = step_states(cell, seed, device)
    truth, p0 = train_cell.reference_truth(cell, seed, states, device)
    out = {}
    groups = family.load(cell.family).LEAF_GROUPS
    for name, precision, fault in (("control", "fp8", None), ("half_batch", "float32", "half_batch")):
        stand_in, _ = train_cell.reference_truth(cell, seed, states, device, precision, fault)
        out[name] = check.train_numbers(stand_in, truth, p0, groups)
    if cell.config["conf"]["model"].get("dtype", "float32") == "float32":
        out["control_bf16"] = sound(at_dtype(cell, "bfloat16"), seed, device)
    return out


def at_dtype(cell, dtype: str):
    """The cell with the program's compute dtype set to `dtype`; the
    reference, which reads no dtype, stays float32."""
    other = copy.copy(cell)
    other.config = copy.deepcopy(cell.config)
    other.config["conf"]["model"]["dtype"] = dtype
    return other


def view_readings(cell, seed: int, device="cuda") -> dict:
    """The control and the faults on the requests a run would check."""
    data, traffic = cell.config["data"], cell.traffic
    conf = cell.config["conf"]
    fam = family.load(cell.family)
    p0 = fam.make_weights(conf["model"], seed, device)
    pool = scene.Pool(data, int(traffic["pool_objects"]), seed, device)
    reqs = view_cell.Requests(pool, int(data["source_views"]), seed, device)
    k = -(-int(traffic["check_rays"]) // _rays_per_view(cell))
    first = int(traffic["warm_requests"])
    chunk = int(traffic["chunk_rays"])
    depth_range = float(data["z_far"]) - float(data["z_near"])
    readings = {"control": [], "half_rays": [], "altered": []}
    for i in view_cell.check_sample(cell, seed, list(range(first, first + k))):
        src_u8, src_c2w = reqs.sources(i)
        args = (p0, conf["model"], conf["renderer"], src_u8, src_c2w,
                torch.from_numpy(pool.focal).to(device), torch.from_numpy(pool.c).to(device),
                scene.view_rays(pool, reqs.target(i)), reqs.seed(i), chunk)
        good = fam.render_view(*args, "float32")
        stand_ins = {"control": fam.render_view(*args, "fp8"),
                     "half_rays": half_rays(good, chunk), "altered": altered(good)}
        for name, view in stand_ins.items():
            readings[name].append(check.view_numbers(view, good, depth_range))
    return {name: check.over_views(r) for name, r in readings.items()}


def half_rays(view, chunk: int):
    """Each chunk's second half of rays left unrendered."""
    out = {}
    for head, vals in view.items():
        out[head] = {}
        for k, v in vals.items():
            v = v.clone()
            for c0 in range(0, v.shape[0], chunk):
                v[c0 + chunk // 2:c0 + chunk] = 0
            out[head][k] = v
    return out


def altered(view):
    """The fine head's rgb moved by 0.05 where it is produced."""
    out = {h: dict(vals) for h, vals in view.items()}
    head = "fine" if "fine" in out else "coarse"
    out[head]["rgb"] = out[head]["rgb"] + 0.05
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cell = manifest.Cell(manifest.load_manifest(BENCH_DIR.parent), args.workload)
    readings = {"workload": args.workload, "sound": {}, "faults": {}}
    for s in range(args.seeds):
        seed = args.first_seed + 7919 * s
        readings["sound"][seed] = sound(cell, seed)
        print("sound", seed, readings["sound"][seed], flush=True)
    for s in range(args.controls):
        seed = args.first_seed + 104729 * (s + 1)
        fn = train_readings if cell.kind == "train" else view_readings
        readings["faults"][seed] = fn(cell, seed)
        print("faults", seed, readings["faults"][seed], flush=True)
        for name, numbers in readings["faults"][seed].items():
            ok, table = check.judge(numbers, cell.limits)
            print("judged", seed, name, "correct" if ok else "not correct", json.dumps(table),
                  flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(readings, indent=1))
    for name, row in readings_table(readings, cell.kind).items():
        print(name, json.dumps(row))


def readings_table(readings: dict, kind: str) -> dict:
    """For each number: the lower reading (the largest sound one), the
    least reading of each control and of each fault, and the upper reading
    by the rules: a control where it reads three times the lower or
    more; in a training cell also each fault that reads ten times the
    lower or more. A state left unchanged reads 1 on every gap of norms and
    on the median leaf's difference (the optimizer holds no gradient and
    the parameters do not move) and counts where that is three times the
    lower."""
    sound = list(readings["sound"].values())
    faults = list(readings["faults"].values())
    table = {}
    control = lambda f: f.startswith("control")
    for name in sound[0]:
        lower = max(r[name] for r in sound)
        least = {f: min(r[f][name] for r in faults) for f in faults[0]}
        candidates = [v for f, v in least.items()
                      if v >= (3 if control(f) else 10) * lower
                      and (control(f) or kind == "train")]
        if kind == "train" and not name.startswith("loss") and 1 >= 3 * lower:
            candidates.append(1.0)
        table[name] = {"lower": lower, **least, "upper": min(candidates) if candidates else None}
    return table

if __name__ == "__main__":
    main()
