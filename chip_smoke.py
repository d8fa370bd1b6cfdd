#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root)

Phases, each failing loudly (an exception and a non-zero exit):

1. require CUDA, print the card's name and power limit, turn TF32 off;
2. build the package's CUDA source (`csrc/field_fwd.cu`) with nvcc;
3. hold each hand-written kernel against its plain PyTorch version on the
   card at the render's two chunk shapes (coarse and fine), and time both
   with CUDA events;
4. the slice: the flagship srn.conf model in bf16 with seeded random
   weights (non-zero fc_1) encodes two synthetic 128x128 views and renders
   one full 128x128 target view through `render_full`; launch counters
   are zeroed just before and read just after, and the first 256 rays are
   rendered again on the CPU with the plain versions and compared;
   one more view runs under torch.profiler for device time by kernel;
5. a `kernels` JSON line, the card line, and the result line. A kernel's
   ms, plain_ms and bound_ms there are sums over the two chunk shapes:
   the kernel's work in one view.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# published H100 SXM peaks (dense): bf16 tensor-core rate, float32 rate
# outside the tensor cores, and device-memory bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

POSENC_TOL = 2.0 ** -6  # one bf16 ulp at the largest |value| (< 4)
FIELD_ATOL, FIELD_RTOL = 3e-2, 3e-2  # bf16 operands, f32 sums in other orders
RENDER_ATOL, RENDER_MEAN = 5e-3, 5e-4  # rgb of the CPU plain render vs the card
RGB_SLACK = 1e-5  # float32 rounding of the white-background composite
# the compared rays must be neither all background nor all opaque, and
# their colour must vary from ray to ray (mean over channels of the std)
ALPHA_RANGE, RGB_STD_MIN = (0.2, 0.995), 0.02

# shapes: the render's own (render_full's 16384-ray chunk, two views, 64
# samples a ray in the coarse pass and 64 + 16 importance + 16 depth in
# the fine one; one 128x128 target view; 256 rays re-rendered on the CPU)
CHUNK_RAYS, NS = 16384, 2
CHUNK_SAMPLES = {"coarse": 64, "fine": 96}
VIEW_SIZE = 128
CPU_RAYS = 256


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, flop_rate: float, nbytes: float):
    t_ops = flops / flop_rate * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _look_at(np, eye):
    eye = np.asarray(eye, np.float64)
    back = eye / np.linalg.norm(eye)
    x = np.cross([0.0, 1.0, 0.0], back)
    x /= np.linalg.norm(x)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, np.cross(back, x), back, eye
    return pose.astype(np.float32)


def check_posenc(torch, dev):
    from pixelnerf_tpu_torch.ops.posenc import posenc_concat, posenc_concat_plain

    g = torch.Generator(device=dev).manual_seed(1)
    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for chunk, k in CHUNK_SAMPLES.items():
        m = NS * CHUNK_RAYS * k
        base = torch.randn((m, 3), generator=g, device=dev) * 0.5
        vd = torch.nn.functional.normalize(torch.randn((m, 3), generator=g, device=dev), dim=-1)
        got = posenc_concat(base, vd, 6, 1.5)
        torch.cuda.synchronize()
        want = posenc_concat_plain(base, vd, 6, 1.5)
        err = (got.float() - want.float()).abs().max().item()
        print(f"posenc {chunk}: M={m} max_abs_err={err:.3e} (tolerance {POSENC_TOL:.3e})")
        if not err <= POSENC_TOL:
            raise AssertionError(f"posenc kernel disagrees with its plain version: {err}")
        ms = _time_ms(torch, lambda: posenc_concat(base, vd, 6, 1.5), 5, 100)
        plain_ms = _time_ms(torch, lambda: posenc_concat_plain(base, vd, 6, 1.5), 3, 20)
        nbytes = m * (3 * 4 + 3 * 4) + m * 42 * 2
        bound_ms, bound_by = _bound(m * 36 * 2.0, PEAK_F32_FLOPS, nbytes)
        print(
            f"posenc {chunk}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})"
        )
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["bound_ms"] += bound_ms
    return dict(
        name="posenc_concat", route="triton", source="pixelnerf_tpu_torch/ops/posenc.py",
        replaces="pixelnerf_tpu/ops/posenc_pallas.py:62", **res, bound_by=bound_by,
        library_ms=None,
    )


def check_field(torch, np, dev):
    from pixelnerf_tpu_torch.ops.field import (
        FieldWeights, field_flops, field_plain, pack_field_weights, pyramid_field_fused,
    )

    ns, sb = NS, 1
    d_in, hidden, d_out, n_blocks, combine = 42, 512, 4, 5, 3
    shapes = [(64, 64, 128), (16, 16, 128), (8, 8, 256)]
    d_latent = sum(c for _, _, c in shapes)
    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    feats = [rnd(sb * ns, h, w, c).to(torch.bfloat16) for h, w, c in shapes]
    # packed once, as ResnetFC.field_weights packs a head's weights
    w = pack_field_weights(FieldWeights(
        w_in=rnd(d_in, hidden, scale=d_in ** -0.5), b_in=rnd(hidden, scale=0.1),
        wz=rnd(3, d_latent, hidden, scale=d_latent ** -0.5), bz=rnd(3, hidden, scale=0.1),
        w0=rnd(n_blocks, hidden, hidden, scale=hidden ** -0.5), b0=rnd(n_blocks, hidden, scale=0.1),
        # non-zero fc_1: a zero-initialized fc_1 would hide the block chain
        w1=rnd(n_blocks, hidden, hidden, scale=0.5 * hidden ** -0.5), b1=rnd(n_blocks, hidden, scale=0.1),
        w_out=rnd(hidden, d_out, scale=hidden ** -0.5), b_out=rnd(d_out, scale=0.1),
    ))
    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for chunk, k in CHUNK_SAMPLES.items():
        b = CHUNK_RAYS * k
        grid = torch.rand((sb, ns, b, 2), generator=g, device=dev) * 2.2 - 1.1
        xin = rnd(sb, ns, b, d_in).to(torch.bfloat16)
        run = lambda: pyramid_field_fused(feats, grid, xin, w, n_blocks, combine, ns)
        plain = lambda: field_plain(feats, grid, xin, w, n_blocks, combine, ns)
        got = run()
        torch.cuda.synchronize()
        want = plain()
        diff = (got - want).abs()
        err = diff.max().item()
        excess = (diff - (FIELD_ATOL + FIELD_RTOL * want.abs())).max().item()
        print(
            f"field {chunk}: NS={ns} B={b} hidden={hidden} max_abs_err={err:.3e} "
            f"mean_abs_err={diff.mean().item():.3e} |out| mean={want.abs().mean().item():.3f} "
            f"(tolerance {FIELD_ATOL} + {FIELD_RTOL}*|plain|)"
        )
        if not (torch.isfinite(got).all() and excess <= 0):
            raise AssertionError(f"field kernel disagrees with its plain version: {err}")
        del got, want, diff
        ms = _time_ms(torch, run, 1, 5)
        plain_ms = _time_ms(torch, plain, 1, 2)
        flops = field_flops(ns, d_in, d_latent, hidden, d_out, n_blocks, combine) * b * sb
        nbytes = (
            sum(f.numel() * 2 for f in feats) + grid.numel() * 4 + xin.numel() * 2
            + sum(t.numel() * t.element_size() for t in w) + sb * b * d_out * 4
        )
        bound_ms, bound_by = _bound(flops, PEAK_BF16_FLOPS, nbytes)
        print(
            f"field {chunk}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, {flops / 1e12:.3f} TFLOP)"
        )
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["bound_ms"] += bound_ms
    return dict(
        name="pyramid_field_fused", route="cuda", source="pixelnerf_tpu_torch/csrc/field_fwd.cu",
        replaces="pixelnerf_tpu/ops/field_pallas.py:332", **res, bound_by=bound_by,
        library_ms=None,
    )


def shape_heads(torch, model):
    """Give the randomly initialized heads weights that render a visible
    scene. fc_1 becomes non-zero: its zero init would hide the block chain.
    The random trunk's latents are O(10), so the raw outputs would be too:
    rgb would sit on the sigmoid's flat ends and sigma, offset by the
    common part of relu(x) @ W_out, would be huge everywhere or zero
    everywhere, and the comparison with the CPU render would see nothing.
    So the output layer is scaled down, each of its rows loses its mean
    (the common part), and sigma gets a positive offset."""
    g = torch.Generator(device="cpu").manual_seed(3)
    with torch.no_grad():
        for mlp in (model.mlp_coarse, model.mlp_fine):
            for i in range(mlp.n_blocks):
                fc1 = getattr(mlp, f"block_{i}").fc_1.weight
                fc1.copy_(torch.randn(fc1.shape, generator=g) * 0.5 * fc1.shape[1] ** -0.5)
            w_out = mlp.lin_out.weight
            w_out.mul_(0.1)
            w_out.sub_(w_out.mean(dim=1, keepdim=True))
            mlp.lin_out.bias[3] = 2.0


def profile_view(torch, view):
    """One warm view under torch.profiler: device time by kernel, and the
    share of the view's wall time in which the card ran a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        view()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(
        f"profile: one view {wall_ms:.1f} ms wall under the profiler, kernels "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%} busy)"
    )
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"profile: {e.self_device_time_total / 1e3:10.3f} ms x{e.count:<4d} {e.key[:100]}")


def run_slice(torch, np, dev, root, card):
    from pixelnerf_tpu_torch.eval.common import encode_views
    from pixelnerf_tpu_torch.eval.render_utils import render_full
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.ops.field import pyramid_field_fused
    from pixelnerf_tpu_torch.ops.posenc import posenc_concat
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.utils import hocon
    from pixelnerf_tpu_torch.utils.rays import gen_rays

    conf = hocon.load(str(root / "conf" / "exp" / "srn.conf"))
    model = make_model(conf["model"], device=dev, seed=0)
    if model.dtype != torch.bfloat16:
        raise AssertionError("srn.conf should build a bf16 model")
    shape_heads(torch, model)

    rng = np.random.default_rng(4)
    size, focal, near, far = VIEW_SIZE, 131.25 * VIEW_SIZE / 128, 0.8, 1.8
    images = rng.uniform(-1, 1, size=(2, size, size, 3)).astype(np.float32)
    poses = np.stack([_look_at(np, [1.3, 0.2, 0.1]), _look_at(np, [0.2, 0.3, 1.3])])
    target = torch.from_numpy(_look_at(np, [0.9, 0.4, 0.9])[None]).to(dev)
    rays = gen_rays(target, size, size, focal, near, far).reshape(-1, 8)
    rcfg = RendererConfig.from_conf(conf["renderer"]).replace(perturb=0.0)
    print(
        f"slice: srn.conf bf16, {sum(p.numel() for p in model.parameters())} params, "
        f"{rays.shape[0]} rays, {rcfg.n_coarse} coarse + {rcfg.n_fine - rcfg.n_fine_depth} "
        f"importance + {rcfg.n_fine_depth} depth samples, 2 source views"
    )

    def view():
        enc = encode_views(model, images, poses, focal)
        return enc, render_full(model, enc, rays, rcfg)

    torch.cuda.synchronize()
    posenc_concat.launches = 0
    pyramid_field_fused.launches = 0
    t0 = time.perf_counter()
    enc, out = view()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {
        "posenc_concat": posenc_concat.launches,
        "pyramid_field_fused": pyramid_field_fused.launches,
    }
    print(f"slice: launches on the main path {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")

    for head in ("coarse", "fine"):
        for k, v in out[head].items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{head} {k} has non-finite values")
        rgb = out[head]["rgb"]
        lo, hi = rgb.min().item(), rgb.max().item()
        # sum(w * rgb) + 1 - sum(w) rounds a few float32 ulps past [0, 1]
        if rgb.shape != (size * size, 3) or lo < -RGB_SLACK or hi > 1 + RGB_SLACK:
            raise AssertionError(
                f"{head} rgb out of [0, 1] ({lo}, {hi}) or misshapen: {tuple(rgb.shape)}"
            )
    alpha = out["fine"]["alpha"]
    print(
        f"slice: fine alpha mean {alpha.mean().item():.4f}, rgb range "
        f"[{out['fine']['rgb'].min().item():.6f}, {out['fine']['rgb'].max().item():.6f}], rgb mean "
        f"{out['fine']['rgb'].mean().item():.4f}, depth mean {out['fine']['depth'].mean().item():.4f}"
    )

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    view()
    torch.cuda.synchronize()
    view_s = time.perf_counter() - t0
    print(
        f"slice: {size}x{size} view (encode + render_full) {view_s:.3f} s warm = "
        f"{rays.shape[0] / view_s:.1f} rays/s (first call {first_s:.3f} s), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {card}"
    )
    profile_view(torch, view)

    n = CPU_RAYS
    model_cpu = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    ref = render_full(model_cpu, enc.to("cpu"), rays[:n].cpu(), rcfg)
    print(f"slice: CPU plain render of {n} rays {time.perf_counter() - t0:.1f} s")
    for head in ("coarse", "fine"):
        d = (out[head]["rgb"][:n].cpu() - ref[head]["rgb"]).abs()
        dd = (out[head]["depth"][:n].cpu() - ref[head]["depth"]).abs()
        alpha = ref[head]["alpha"].mean().item()
        rgb_std = ref[head]["rgb"].std(dim=0).mean().item()
        print(
            f"slice: {head} rgb vs CPU plain max {d.max().item():.3e} mean {d.mean().item():.3e} "
            f"(tolerance {RENDER_ATOL} max, {RENDER_MEAN} mean); depth max {dd.max().item():.3e}; "
            f"compared rays' alpha mean {alpha:.4f}, rgb std {rgb_std:.4f}"
        )
        if not (d.max().item() <= RENDER_ATOL and d.mean().item() <= RENDER_MEAN):
            raise AssertionError(f"{head} render disagrees with the CPU plain render")
        # an empty or saturated render would agree whatever the field did
        if not (ALPHA_RANGE[0] <= alpha <= ALPHA_RANGE[1] and rgb_std >= RGB_STD_MIN):
            raise AssertionError(f"{head}: the compared rays show too little of the field")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from pixelnerf_tpu_torch.ops.cuda_build import build_library

    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    log = build_library("field_fwd")
    print(f"build: field_fwd in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"build: field_fwd: {line.strip()}")

    kernels = [check_posenc(torch, dev), check_field(torch, np, dev)]
    launches = run_slice(torch, np, dev, root, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            raise AssertionError(f"non-finite measurement for {k['name']}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
