"""The serving cells: one client in a closed loop, as an eval CLI.

Traffic (`"kind": "view"`): each request is one object of a pool of
`pool_objects` made from the seed, with the configuration's
`source_views` of its views as sources and another of its views as the
target: `encode_views` of the sources, `render_full` of every pixel of the
target in `chunk_rays`-ray chunks through a renderer built once at set-up
(`make_chunk_renderer`), then rgb, depth and alpha of both heads copied to
the host. The next request starts when that one has ended. Set-up warms
with `warm_requests` requests. The window serves requests for the run's
seconds; a traced run then traces `trace_rays` rays' worth more. After the window a sample of the
completed views, drawn from the seed, `check_rays` rays or more, is
rendered again by the reference and compared.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from harness import check, family, precision, scene
from harness.trace import read_profile
from harness.train_cell import load_weights

MAX_REQUESTS = 8192


class Program:
    """The program's serving path on the cell's configuration."""

    def __init__(self, cell, seed: int, device):
        from pixelnerf_tpu_torch.eval.common import encode_views
        from pixelnerf_tpu_torch.eval.render_utils import make_chunk_renderer, render_full
        from pixelnerf_tpu_torch.models.pixelnerf import make_model
        from pixelnerf_tpu_torch.render.renderer import RendererConfig
        from pixelnerf_tpu_torch.utils.hocon import ConfigTree

        conf = ConfigTree(cell.config["conf"])
        self.model = make_model(conf["model"], device=device)
        load_weights(self.model,
                     family.load(cell.family).make_weights(cell.config["conf"]["model"], seed, device))
        self.rcfg = RendererConfig.from_conf(
            conf["renderer"], lindisp=bool(cell.config["data"].get("lindisp", False)))
        self.renderer = make_chunk_renderer(self.model, self.rcfg)
        self.encode_views, self.render_full = encode_views, render_full


class Requests:
    """The requests in the seed's order."""

    def __init__(self, pool: scene.Pool, sources: int, seed: int, device):
        self.pool = pool
        self.objs, self.srcs, self.tgts, self.seeds = scene.view_order(
            pool, sources, MAX_REQUESTS, seed)
        self.srcs_d = torch.from_numpy(self.srcs).to(device)

    def sources(self, i: int):
        i %= MAX_REQUESTS
        o = int(self.objs[i])
        return self.pool.images_u8[o][self.srcs_d[i]], self.pool.c2w[o][self.srcs_d[i]]

    def target(self, i: int) -> torch.Tensor:
        i %= MAX_REQUESTS
        return self.pool.c2w[int(self.objs[i]), int(self.tgts[i])]

    def seed(self, i: int) -> int:
        return int(self.seeds[i % MAX_REQUESTS])


def serve(prog: Program, reqs: Requests, chunk: int, i: int, events=None) -> dict:
    """One request; returns the view on the host."""
    pool = reqs.pool
    src_u8, src_c2w = reqs.sources(i)
    with record_function("bench.encode"):
        if events is not None:
            events[0].record()
        enc = prog.encode_views(prog.model, scene.images_float(src_u8), src_c2w, pool.focal,
                                c=pool.c)
        if events is not None:
            events[1].record()
    with record_function("bench.render"):
        rays = scene.view_rays(pool, reqs.target(i))
        out = prog.render_full(prog.model, enc, rays, prog.rcfg, chunk=chunk, seed=reqs.seed(i),
                               renderer=prog.renderer)
    with record_function("bench.fetch"):
        return {head: {k: v.cpu() for k, v in vals.items()} for head, vals in out.items()}


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    data, traffic = cell.config["data"], cell.traffic
    chunk = int(traffic["chunk_rays"])
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rays_per_view = int(np.prod(data["image_hw"]))

    phases = {"start": time.perf_counter() - t0}
    precision.as_stated(cell.config["conf"]["model"])
    prog = Program(cell, seed, device)
    phases["program"] = time.perf_counter() - t0
    pool = scene.Pool(data, int(traffic["pool_objects"]), seed, device)
    reqs = Requests(pool, int(data["source_views"]), seed, device)
    sync()
    phases["pool"] = time.perf_counter() - t0
    warm = int(traffic["warm_requests"])
    for i in range(warm):
        serve(prog, reqs, chunk, i)
    sync()
    phases["warm requests"] = time.perf_counter() - t0
    out = {"setup_s": phases["warm requests"], "phases": phases}

    views, spans, encode_ms = {}, [], []
    i = warm
    # the window: requests back to back for `seconds`; a traced run times
    # it for the shares of the peak, then traces
    start = time.perf_counter()
    while time.perf_counter() - start < seconds or not spans:
        t = time.perf_counter()
        views[i] = serve(prog, reqs, chunk, i)
        spans.append((t, time.perf_counter()))
        i += 1
    lat = np.array([(e - s) * 1e3 for s, e in spans])
    out["timed_s"] = spans[-1][1] - spans[0][0]
    out["timed_units"] = len(spans)
    out["view_rays_per_s"] = len(spans) * rays_per_view / out["timed_s"]
    out["view_ms_p95"] = float(np.percentile(lat, 95))
    if traced:
        n = -(-int(traffic["trace_rays"]) // rays_per_view)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        marks = []
        with profile(activities=activities) as prof:
            with record_function("bench.window"):
                for _ in range(n):
                    ev = ((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                          if on_card else None)
                    views[i] = serve(prog, reqs, chunk, i, ev)
                    marks.append(ev)
                    i += 1
                sync()
        encode_ms = [ev[0].elapsed_time(ev[1]) for ev in marks if ev is not None]
        out["trace"] = read_profile(prof)
    out["attempted"] = i - warm
    out["units"] = n if traced else i - warm
    out["encode_ms"] = encode_ms
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    out["failed"] = sum(
        any(not bool(torch.isfinite(t).all()) for vals in v.values() for t in vals.values())
        for v in views.values())

    del prog, pool, reqs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    out["numbers"] = reference_numbers(cell, seed, views, device)
    return out


def check_sample(cell, seed: int, done: list) -> list:
    """The completed requests that the reference renders again."""
    rays_per_view = int(np.prod(cell.config["data"]["image_hw"]))
    k = min(len(done), -(-int(cell.traffic["check_rays"]) // rays_per_view))
    pick = scene.rng(seed, "check").choice(len(done), k, replace=False)
    return [done[j] for j in sorted(pick)]


def reference_numbers(cell, seed, views: dict, device):
    """The reference's render of a sample of `views` ({request: the
    program's view on the host}), over the sample (`check.over_views`)."""
    data, traffic = cell.config["data"], cell.traffic
    conf = cell.config["conf"]
    fam = family.load(cell.family)
    p0 = fam.make_weights(conf["model"], seed, device)
    pool = scene.Pool(data, int(traffic["pool_objects"]), seed, device)
    reqs = Requests(pool, int(data["source_views"]), seed, device)
    depth_range = float(data["z_far"]) - float(data["z_near"])
    readings = []
    for i in check_sample(cell, seed, sorted(views)):
        src_u8, src_c2w = reqs.sources(i)
        want = fam.render_view(
            p0, conf["model"], conf["renderer"], src_u8, src_c2w,
            torch.from_numpy(pool.focal).to(device), torch.from_numpy(pool.c).to(device),
            scene.view_rays(pool, reqs.target(i)), reqs.seed(i), int(traffic["chunk_rays"]))
        readings.append(check.view_numbers(views[i], want, depth_range))
    if not readings:
        return {"rgb_mae": math.inf, "rgb_mae_median": math.inf}
    return check.over_views(readings)
