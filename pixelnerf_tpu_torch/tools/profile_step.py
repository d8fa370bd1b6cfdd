"""Profile the training step (or a forward render) under torch.profiler.

Counterpart of `pixelnerf_tpu/tools/profile_step.py`, with its flags: a
batch of random images and identity cameras at z = 1.3 (`--sb` objects,
`--nv` views of `--size`^2, `--ns` of them as sources, `--rays` rays an
object), the model of `-c` with its seeded random weights, warm-up steps
and then `--steps` profiled ones of the real train step (`make_train_step`,
`--remat` forcing rematerialization, else the JAX rule `auto`), or of a
forward render of the coarse and fine passes (`--forward-only`), through
the port's kernels on the card. A train step is the program's own
`pnt.step` range (`utils/spans.py`), a render a `record_function` range
("render {i}"). It writes a Chrome trace to `<out>/trace.json`
(chrome://tracing or Perfetto) and prints the operations that took the
most device time (the CPU's on the CPU), and returns the profiler.

Usage:
    python -m pixelnerf_tpu_torch.tools.profile_step -c conf/exp/srn.conf \\
        --out /tmp/prof --steps 3 [--sb 4] [--rays 1024] [--forward-only] [--remat]

or, from Python, `main(argv, device="cpu")` on the CPU.
"""

from __future__ import annotations

import argparse
import os

TOP = 15


def _parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-c", "--conf", default="conf/exp/srn.conf")
    parser.add_argument("--out", required=True, help="trace output directory")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--sb", type=int, default=4, help="object batch")
    parser.add_argument("--nv", type=int, default=3)
    parser.add_argument("--ns", type=int, default=2, help="source views")
    parser.add_argument("--size", type=int, default=128, help="image H=W")
    parser.add_argument("--rays", type=int, default=1024, help="rays/object")
    parser.add_argument("--forward-only", action="store_true")
    parser.add_argument("--remat", action="store_true")
    return parser


def main(argv=None, device=None):
    args = _parser().parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from pixelnerf_tpu_torch.device import resolve_device
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import RendererConfig, render_rays
    from pixelnerf_tpu_torch.train.step import make_optimizer, make_train_step
    from pixelnerf_tpu_torch.utils import hocon

    dev = resolve_device(device)
    conf = hocon.load(args.conf)
    rcfg = RendererConfig.from_conf(conf["renderer"])
    sb, nv, ns, size, nrays = args.sb, args.nv, args.ns, args.size, args.rays
    host = np.random.default_rng(0)
    images = torch.from_numpy(host.uniform(-1, 1, (sb, nv, size, size, 3)).astype(np.float32)).to(dev)
    poses = torch.eye(4, device=dev).repeat(sb, nv, 1, 1)
    poses[..., 2, 3] = 1.3
    batch = {
        "images": images, "poses": poses,
        "focal": torch.full((sb, 2), float(size), device=dev),
        "c": torch.full((sb, 2), size / 2.0, device=dev),
        "src_images": images[:, :ns], "src_poses": poses[:, :ns],
    }
    model = make_model(conf["model"], device=dev, train=not args.forward_only)
    model.init_shapes(images)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    if args.forward_only:
        rays = torch.cat([
            torch.zeros((sb, nrays, 3), device=dev),
            torch.tensor([0.0, 0.0, -1.0], device=dev).expand(sb, nrays, 3),
            torch.full((sb, nrays, 1), 0.8, device=dev),
            torch.full((sb, nrays, 1), 1.8, device=dev),
        ], dim=-1)

        @torch.no_grad()
        def run():
            enc = model.encode(batch["src_images"], batch["src_poses"], batch["focal"], batch["c"])

            def qf(xyz, vd, coarse):
                return model.query(enc, xyz, vd, coarse)

            out = render_rays(qf, rays, rcfg, generator=gen, use_viewdirs=model.use_viewdirs)
            return out["fine" if rcfg.using_fine else "coarse"]["rgb"]

        warmup = 1
    else:
        step = make_train_step(model, rcfg, make_optimizer(model, 1e-4), nrays, 0.8, 1.8,
                               remat=True if args.remat else "auto", nviews=ns)

        def run():
            return step(batch, gen)["t"]

        warmup = 2

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(warmup):  # builds the kernels and warms the allocator
        run()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for i in range(args.steps):
            if args.forward_only:
                with record_function(f"render {i}"):
                    out = run()
            else:
                out = run()  # the step's own pnt.step range
        float(out.float().sum())
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "trace.json")
    prof.export_chrome_trace(path)
    key = "self_device_time_total" if cuda else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=key, row_limit=TOP))
    print(f"trace written to {path}")
    return prof


if __name__ == "__main__":
    main()
