"""The training cells: one process stepping the program's train step back
to back, as the training CLI builds it.

Traffic (`"kind": "train"`): each step draws `objects_per_step` objects
from a pool of `pool_objects` made from the seed at set-up, and the
configuration's `source_views` of each object's views as sources; the
batch goes in the compact form the CLI's loader makes (`images_u8`,
`image_ord`), and the step samples `rays_per_object` rays an object over
all of its views. Set-up builds the step (Adam at `lr`, `remat`, the
configuration's losses) and drives it through its first `truth_steps`
steps, which the reference follows; the same step then runs the window.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from harness import check, family, precision, scene
from harness.trace import read_profile

MAX_STEPS = 4096  # the order of batches repeats after this many steps


class Program:
    """The program's training step on the cell's configuration, with the
    seeded weights."""

    def __init__(self, cell, seed: int, device):
        from pixelnerf_tpu_torch.models.losses import rgb_loss_from_conf
        from pixelnerf_tpu_torch.models.pixelnerf import make_model
        from pixelnerf_tpu_torch.render.renderer import RendererConfig
        from pixelnerf_tpu_torch.train.step import MultiSteps, make_optimizer, make_train_step
        from pixelnerf_tpu_torch.utils.hocon import ConfigTree

        conf = ConfigTree(cell.config["conf"])
        data, traffic = cell.config["data"], cell.traffic
        self.model = make_model(conf["model"], device=device, train=True)
        load_weights(self.model,
                     family.load(cell.family).make_weights(cell.config["conf"]["model"], seed, device))
        rcfg = RendererConfig.from_conf(conf["renderer"], lindisp=bool(data.get("lindisp", False)))
        loss = conf.get_config("loss")
        self.optimizer = MultiSteps(make_optimizer(self.model, float(traffic["lr"])))
        self.step = make_train_step(
            self.model, rcfg, self.optimizer, num_rays=int(traffic["rays_per_object"]),
            z_near=float(data["z_near"]), z_far=float(data["z_far"]),
            lambda_coarse=loss.get_float("lambda_coarse", 1.0),
            lambda_fine=loss.get_float("lambda_fine", 1.0),
            rgb_loss_fn=rgb_loss_from_conf(loss.get_config("rgb"), coarse=True),
            rgb_fine_loss_fn=rgb_loss_from_conf(loss.get_config("rgb_fine", loss.get_config("rgb")),
                                                coarse=False),
            use_bbox=False, alpha_loss_fn=None, remat=traffic["remat"],
            nviews=int(data["source_views"]),
        )

    def first_gradient(self):
        """The first step's gradient as Adam holds it: its first moment
        after one step, over 1 - b1 (nought where it holds none)."""
        opt = self.optimizer.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        moment = lambda p: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
        return {n: (moment(p) / (1.0 - b1)).cpu() for n, p in self.model.named_parameters()}


def load_weights(model, weights) -> None:
    """The benchmark's weights into the program, every name and shape
    matched."""
    have = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    want = {n: tuple(t.shape) for n, t in weights.items()}
    if have != want:
        missing, extra = sorted(set(want) - set(have)), sorted(set(have) - set(want))
        raise RuntimeError(f"the program's parameters are not the configuration's: missing "
                           f"{missing[:5]}, unexpected {extra[:5]}, shapes "
                           f"{[n for n in have if n in want and have[n] != want[n]][:5]}")
    model.load_state_dict(weights, strict=True)


class Batches:
    """The step's batches, in the seed's order, from the pool on the device."""

    def __init__(self, pool: scene.Pool, traffic: dict, sources: int, seed: int, device):
        objs, srcs = scene.train_order(pool, traffic, sources, MAX_STEPS, seed)
        self.pool = pool
        self.objs_d = torch.from_numpy(objs).to(device)
        self.srcs_d = torch.from_numpy(srcs).to(device=device, dtype=torch.int32)
        sb = objs.shape[1]
        self.focal = torch.from_numpy(np.tile(pool.focal, (sb, 1))).to(device)
        self.c = torch.from_numpy(np.tile(pool.c, (sb, 1))).to(device)

    def __call__(self, i: int) -> dict:
        i %= MAX_STEPS
        o = self.objs_d[i]
        return {"images_u8": self.pool.images_u8[o], "image_ord": self.srcs_d[i],
                "poses": self.pool.c2w[o], "focal": self.focal, "c": self.c}

    def for_reference(self, i: int) -> dict:
        b = self(i)
        b = {k: v.clone() for k, v in b.items()}
        b.update(near=self.pool.near, far=self.pool.far)
        return b


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    data, traffic = cell.config["data"], cell.traffic
    sources, truth = int(data["source_views"]), int(traffic["truth_steps"])
    rays_per_step = int(traffic["objects_per_step"]) * int(traffic["rays_per_object"])
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    phases = {"start": time.perf_counter() - t0}
    precision.as_stated(cell.config["conf"]["model"])
    prog = Program(cell, seed, device)
    phases["program"] = time.perf_counter() - t0
    pool = scene.Pool(data, int(traffic["pool_objects"]), seed, device)
    batches = Batches(pool, traffic, sources, seed, device)
    gen = scene.generator(seed, "step", device)
    sync()
    phases["pool"] = time.perf_counter() - t0

    # set-up: the first steps, which compile and warm every shape; the
    # reference follows them
    states, losses = [], []
    for k in range(truth):
        states.append(gen.get_state())
        losses.append(prog.step(batches(k), gen)["t"])
        if k == 0:
            grad1 = prog.first_gradient()
    params = {n: p.detach().to("cpu", copy=True) for n, p in prog.model.named_parameters()}
    truth_losses = [float(t) for t in losses]
    sync()
    setup_s = time.perf_counter() - t0
    phases["first steps"] = setup_s

    out = {"setup_s": setup_s, "phases": phases}
    window_losses, i = [], truth
    # the window: steps back to back for `seconds`, ended by a sync; a
    # traced run times it for the shares of the peak, then traces
    sync()
    start = time.perf_counter()
    while True:
        window_losses.append(prog.step(batches(i), gen)["t"])
        i += 1
        if time.perf_counter() - start >= seconds:
            break
    sync()
    out["timed_s"] = time.perf_counter() - start
    out["timed_units"] = i - truth
    if traced:
        n = int(traffic["trace_steps"])
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities) as prof:
            with record_function("bench.window"):
                for _ in range(n):
                    with record_function("bench.batch"):
                        batch = batches(i)
                    with record_function("bench.step"):
                        window_losses.append(prog.step(batch, gen)["t"])
                    i += 1
                sync()
        out["trace"] = read_profile(prof)
    out["train_rays_per_s"] = out["timed_units"] * rays_per_step / out["timed_s"]
    out["attempted"] = i - truth
    out["units"] = int(traffic["trace_steps"]) if traced else i - truth
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    out["failed"] = int((~torch.isfinite(torch.stack(window_losses))).sum())

    del prog, batches, pool, window_losses, losses
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    prog_truth = {"losses": truth_losses, "grad1": grad1, "params": params}
    out["numbers"] = reference_numbers(cell, seed, prog_truth, states, device)
    return out


def reference_truth(cell, seed, states, device, precision: str = "float32", fault=None):
    """The reference's first steps from the seed, with the generator
    states the program's steps started from: (losses, grad1 and params on
    the host; the weights both started from, on the host)."""
    data, traffic = cell.config["data"], cell.traffic
    model_conf = cell.config["conf"]["model"]
    fam = family.load(cell.family)
    p0 = fam.make_weights(model_conf, seed, device)
    pool = scene.Pool(data, int(traffic["pool_objects"]), seed, device)
    batches = Batches(pool, traffic, int(data["source_views"]), seed, device)
    got = fam.run_steps(
        p0, fam.param_specs(model_conf), model_conf, cell.config["conf"]["renderer"],
        cell.config["conf"]["loss"], [batches.for_reference(k) for k in range(len(states))],
        states, int(traffic["rays_per_object"]), float(traffic["lr"]), precision, fault=fault)
    cpu = lambda d: {n: t.detach().cpu() for n, t in d.items()}
    truth = {"losses": got["losses"], "grad1": cpu(got["grad1"]), "params": cpu(got["params"])}
    return truth, cpu(p0)


def reference_numbers(cell, seed, prog_truth, states, device):
    """The program's first steps (`prog_truth`: losses, grad1 and params
    on the host) against the reference's."""
    truth, p0 = reference_truth(cell, seed, states, device)
    return check.train_numbers(prog_truth, truth, p0, family.load(cell.family).LEAF_GROUPS)
