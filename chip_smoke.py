#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root)

Phases, each failing loudly (an exception and a non-zero exit):

1. require CUDA, print the card's name and power limit, turn TF32 off;
2. build the package's CUDA sources (`csrc/*.cu`), one nvcc each, at once;
3. hold each hand-written kernel against its plain PyTorch version on the
   card at the shapes its path gives it, and time both with CUDA events:
   posenc and the field at the render's two chunk shapes (coarse, fine);
   the pyramid gather and scatter and the ResnetFC forward, forward with
   stash and backward at the train step's shapes (bench.py's: 4 objects x
   1024 rays, 2 source views, 64 coarse + 32 fine samples), every
   gradient of the backward and of the scatter included;
4. the serving slice: the flagship srn.conf model in bf16 with seeded
   random weights (non-zero fc_1) encodes two synthetic 128x128 views and
   renders one full 128x128 target view through `render_full`; launch
   counters are zeroed just before and read just after, and the first 256
   rays are rendered again on the CPU with the plain versions and
   compared; one more view runs under torch.profiler;
5. the training path at bench.py's shapes: one train step and one eval
   step, each with the launch counters zeroed just before and read just
   after (every kernel of the path must launch as often as the step
   needs it), then warm-up and 10 timed steps (train rays/s, peak memory),
   one step under torch.profiler, and one step of the card held against
   the CPU plain step on the same parameters and injected rays;
6. a `kernels` JSON line, the card line, and the result line. A kernel's
   ms, plain_ms, bound_ms and library_ms there are sums over the shapes of
   one view (posenc, field) or of one train step (the others).
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

# the train step (bench.py:30-38): SB objects x RAYS rays, NV views of
# which NS are sources, 64 coarse + 16 importance + 16 depth samples; the
# fine pass queries the 64 cached coarse samples and the 32 new ones
SB, NV, TRAIN_NS, TRAIN_SIZE, TRAIN_RAYS = 4, 3, 2, 128, 1024
WARMUP_STEPS, TIMED_STEPS = 2, 10
N_COARSE, N_NEW = 64, 32
MLP_CALLS = {"coarse": N_COARSE, "fine cached": N_COARSE, "fine new": N_NEW}
LOOKUPS = {"coarse": N_COARSE, "fine new": N_NEW}
LEVELS = [(64, 64, 128), (16, 16, 128), (8, 8, 256)]  # srn.conf at 128x128
D_IN, HIDDEN, D_OUT, N_BLOCKS, COMBINE = 42, 512, 4, 5, 3
# launches a train step and an eval step make (the table in PERF.md)
TRAIN_LAUNCHES = {
    "posenc_concat": 2, "pyramid_field_fused": 0, "pyramid_gather": 2,
    "pyramid_scatter_add": 2, "resnetfc_fwd": 0, "resnetfc_fwd_stash": 3, "resnetfc_bwd": 3,
}
EVAL_LAUNCHES = {
    "posenc_concat": 2, "pyramid_field_fused": 0, "pyramid_gather": 2,
    "pyramid_scatter_add": 0, "resnetfc_fwd": 3, "resnetfc_fwd_stash": 0, "resnetfc_bwd": 0,
}
# kernels against plain versions: the gather, one bf16 ulp (the same exact
# products summed in another order); the scatter, float32 atomics in any
# order; the ResnetFC forward as the field; its gradients, bf16 operands
# and float32 sums in other orders through 5 blocks: max error <= 5e-2 of
# the largest magnitude, Frobenius error <= 2e-2 relative
SCATTER_RTOL, SCATTER_ATOL = 1e-4, 1e-4
GRAD_MAX, GRAD_FRO = 5e-2, 2e-2
# card step vs CPU plain step (perturb=0, injected rays, full width): the
# relative error of the loss, of the gradient at the encoder's output (what
# the pyramid scatter hands the trunk) and of each parameter gradient
# (Frobenius). bf16, the flagship, with every kernel on the card: cuDNN and
# the CPU round the trunk's bf16 activations and gradients at other
# places, and train-mode BatchNorm subtracts nearly equal terms in the
# trunk's parameter gradients, which then differ by up to ~0.5 relative
# while the rest agree to a few percent; so the bf16 step holds the loss,
# the encoder-output gradient and the heads, and the float32 step (the
# same path without the bf16 kernels) holds every parameter.
CMP_SB, CMP_RAYS = 2, 64
CMP_TOL = {
    "bfloat16": {"loss": 1e-2, "latent": 1e-1, "head": 5e-2, "encoder": None},
    "float32": {"loss": 1e-4, "latent": 1e-2, "head": 1e-2, "encoder": 3e-2},
}


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


def _record(name, route, source, replaces, res, bound_by, library_ms):
    return dict(
        name=name, route=route, source=source, replaces=replaces, **res,
        bound_by=bound_by, library_ms=library_ms,
    )


def check_pyramid(torch, np, dev):
    """The gather and the scatter at the train step's two lookups (the
    coarse one dual, the fine pass's new samples single), against their
    plain versions and against grid_sample (and its backward) on the
    pre-composed 64x64 map, which the port never calls."""
    import torch.nn.functional as F

    from pixelnerf_tpu_torch.models.encoder import compose_pyramid
    from pixelnerf_tpu_torch.ops.pyramid import (
        _level_taps, pyramid_gather, pyramid_gather_plain, pyramid_scatter_add,
        pyramid_scatter_add_plain,
    )

    g = torch.Generator(device=dev).manual_seed(5)
    maps = SB * TRAIN_NS
    feats = [torch.randn((maps, h, w, c), generator=g, device=dev).to(torch.bfloat16) for h, w, c in LEVELS]
    csizes = [c for _, _, c in LEVELS]
    hws = [(h, w) for h, w, _ in LEVELS]
    csum = sum(csizes)
    composed = compose_pyramid(feats).permute(0, 3, 1, 2).contiguous()  # (maps, 512, 64, 64)
    feat_bytes = sum(f.numel() * 2 for f in feats)
    gat = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    sca = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for pass_, k in LOOKUPS.items():
        n = TRAIN_RAYS * k
        uv = torch.rand((maps, n, 2), generator=g, device=dev) * 2.2 - 1.1
        taps = sum(
            int((_level_taps(uv, h, w, *hws[0], torch.bfloat16)[1] != 0).sum()) * c
            for (h, w), c in zip(hws, csizes)
        )
        got = pyramid_gather(feats, uv)
        torch.cuda.synchronize()
        want = pyramid_gather_plain(feats, uv)
        diff = (got.float() - want.float()).abs()
        excess = (diff - 2.0 ** -7 * want.float().abs() - 1e-6).max().item()
        print(f"pyramid_gather {pass_}: maps={maps} N={n} max_abs_err={diff.max().item():.3e} (tolerance one bf16 ulp)")
        if not (torch.isfinite(got.float()).all() and excess <= 0):
            bad = diff - 2.0 ** -7 * want.float().abs() - 1e-6
            i = int(bad.argmax())
            raise AssertionError(
                f"pyramid_gather disagrees with its plain version: {int((bad > 0).sum())} elements, "
                f"worst at flat index {i}: kernel {got.flatten()[i].item()} plain "
                f"{want.flatten()[i].item()}; finite {bool(torch.isfinite(got.float()).all())}"
            )
        gat["max_abs_err"] = max(gat["max_abs_err"], diff.max().item())
        del got, want, diff
        grid = uv[:, None]  # (maps, 1, N, 2)
        gat["ms"] += _time_ms(torch, lambda: pyramid_gather(feats, uv), 3, 20)
        gat["plain_ms"] += _time_ms(torch, lambda: pyramid_gather_plain(feats, uv), 1, 3)
        # grid_sample takes its grid in the map's dtype
        grid = grid.to(torch.bfloat16)
        gat["library_ms"] += _time_ms(torch, lambda: F.grid_sample(
            composed, grid, mode="bilinear", padding_mode="border", align_corners=True), 3, 20)
        out_bytes = maps * n * csum * 2
        gat["bound_ms"] += _bound(2.0 * taps, PEAK_F32_FLOPS, feat_bytes + uv.numel() * 4 + out_bytes)[0]

        dual = pass_ == "coarse"
        dz = (torch.randn((maps, n, csum), generator=g, device=dev) * 1e-3).to(torch.bfloat16)
        dz2 = (torch.randn((maps, n, csum), generator=g, device=dev) * 1e-3).to(torch.bfloat16) if dual else None
        run = lambda: pyramid_scatter_add(uv, dz, csizes, hws, hws[0], dz2=dz2)
        got = run()
        torch.cuda.synchronize()
        want = pyramid_scatter_add_plain(uv, dz, csizes, hws, hws[0], dz2=dz2)
        err, ok = 0.0, True
        for a, b in zip(got, want):
            d = (a - b).abs()
            err = max(err, d.max().item())
            ok = ok and bool((d <= SCATTER_ATOL * b.abs().max() + SCATTER_RTOL * b.abs()).all())
        print(
            f"pyramid_scatter_add {pass_}{' (dual)' if dual else ''}: max_abs_err={err:.3e} "
            f"(tolerance {SCATTER_RTOL}*|plain| + {SCATTER_ATOL}*max|plain|)"
        )
        if not ok:
            raise AssertionError("pyramid_scatter_add disagrees with its plain version")
        sca["max_abs_err"] = max(sca["max_abs_err"], err)
        del got, want
        sca["ms"] += _time_ms(torch, run, 3, 20)
        sca["plain_ms"] += _time_ms(torch, lambda: pyramid_scatter_add_plain(uv, dz, csizes, hws, hws[0], dz2=dz2), 1, 3)
        gout = (dz.float() + (dz2.float() if dual else 0.0)).to(torch.bfloat16).permute(0, 2, 1)[:, :, None]
        gout = gout.contiguous()  # (maps, 512, 1, N)
        sca["library_ms"] += _time_ms(torch, lambda: torch.ops.aten.grid_sampler_2d_backward(
            gout, composed, grid, 0, 1, True, [True, False]), 3, 20)
        grad_bytes = sum(m * h * w * c * 4 for m, (h, w), c in zip([maps] * 3, hws, csizes))
        sca["bound_ms"] += _bound(
            2.0 * taps, PEAK_F32_FLOPS, (2 if dual else 1) * out_bytes + uv.numel() * 4 + grad_bytes
        )[0]
        del dz, dz2, gout
    for name, r in (("pyramid_gather", gat), ("pyramid_scatter_add", sca)):
        print(
            f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, grid_sample "
            f"{'backward ' if name.endswith('add') else ''}{r['library_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms (bytes), per train step"
        )
    src, rep = "pixelnerf_tpu_torch/csrc/pyramid.cu", "pixelnerf_tpu/ops/pyramid_pallas.py"
    return [
        _record("pyramid_gather", "cuda", src, f"{rep}:227", gat, "bytes", gat.pop("library_ms")),
        _record("pyramid_scatter_add", "cuda", src, f"{rep}:282", sca, "bytes", sca.pop("library_ms")),
    ]


def _grad_err(got, want):
    """(max abs error, max abs error / max |want|, relative Frobenius error)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    scale = want.abs().max().item() + 1e-30
    return d.max().item(), d.max().item() / scale, ((got - want).norm() / (want.norm() + 1e-30)).item()


def check_resnetfc(torch, np, dev):
    """The ResnetFC forward (no stash), forward with stash and backward at
    the train step's three MLP calls, against the plain versions: outputs,
    and dz, dxin and every weight gradient from the same stash."""
    from pixelnerf_tpu_torch.ops.field import FieldWeights, field_flops
    from pixelnerf_tpu_torch.ops.resnetfc import (
        resnetfc_bwd, resnetfc_bwd_plain, resnetfc_fwd, resnetfc_fwd_plain, resnetfc_fwd_stash,
    )

    g = torch.Generator(device=dev).manual_seed(6)
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
    ns, dl = TRAIN_NS, sum(c for _, _, c in LEVELS)
    w = FieldWeights(
        w_in=rnd(D_IN, HIDDEN, scale=D_IN ** -0.5), b_in=rnd(HIDDEN, scale=0.1),
        wz=rnd(3, dl, HIDDEN, scale=dl ** -0.5), bz=rnd(3, HIDDEN, scale=0.1),
        w0=rnd(N_BLOCKS, HIDDEN, HIDDEN, scale=HIDDEN ** -0.5), b0=rnd(N_BLOCKS, HIDDEN, scale=0.1),
        w1=rnd(N_BLOCKS, HIDDEN, HIDDEN, scale=0.5 * HIDDEN ** -0.5), b1=rnd(N_BLOCKS, HIDDEN, scale=0.1),
        w_out=rnd(HIDDEN, D_OUT, scale=HIDDEN ** -0.5), b_out=rnd(D_OUT, scale=0.1),
    )
    wbytes = sum(t.numel() * 2 for t in w)  # bf16 operands
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms")
    fwd, stash, bwd = ({k: 0.0 for k in keys} for _ in range(3))
    args = (N_BLOCKS, COMBINE, ns)
    for call, k in MLP_CALLS.items():
        b = TRAIN_RAYS * k
        z = rnd(SB, ns, b, dl).to(torch.bfloat16)
        xin = rnd(SB, ns, b, D_IN).to(torch.bfloat16)
        gout = rnd(SB, b, D_OUT, scale=1e-3)
        flops = field_flops(ns, D_IN, dl, HIDDEN, D_OUT, N_BLOCKS, COMBINE) * SB * b
        in_bytes = z.numel() * 2 + xin.numel() * 2 + wbytes
        out_bytes = SB * b * D_OUT * 4

        out = resnetfc_fwd(z, xin, w, *args)
        out_s, spre, spost = resnetfc_fwd_stash(z, xin, w, *args)
        torch.cuda.synchronize()
        want, wpre, wpost = resnetfc_fwd_plain(z, xin, w, *args, stash=True)
        diff = (out - want).abs()
        excess = (diff - (FIELD_ATOL + FIELD_RTOL * want.abs())).max().item()
        print(
            f"resnetfc_fwd {call}: SB={SB} NS={ns} B={b} max_abs_err={diff.max().item():.3e} "
            f"|out| mean={want.abs().mean().item():.3f} (tolerance {FIELD_ATOL} + {FIELD_RTOL}*|plain|); "
            f"stash forward equal: {torch.equal(out, out_s)}"
        )
        if not (torch.isfinite(out).all() and excess <= 0 and torch.equal(out, out_s)):
            raise AssertionError("resnetfc forward disagrees with its plain version")
        stash_bytes = sum(t.numel() * 2 for t in (spre, spost) if t is not None)
        for r in (fwd, stash):
            r["max_abs_err"] = max(r["max_abs_err"], diff.max().item())
        del out, out_s, diff

        dz, dxin, dw = resnetfc_bwd(z, xin, gout, spre, spost, w, *args)
        torch.cuda.synchronize()
        # the plain backward from the kernel's own stash: the two backwards
        # then differ only in their own rounding, not in the forward's
        wdz, wdxin, wdw = resnetfc_bwd_plain(z, xin, gout, spre, spost, w, *args)
        worst = 0.0
        for name, a, bb in [("dz", dz, wdz), ("dxin", dxin, wdxin)] + [
            (f"d{n}", getattr(dw, n), getattr(wdw, n)) for n in FieldWeights._fields
        ]:
            mx, mrel, fro = _grad_err(a, bb)
            worst = max(worst, mx)
            if not (torch.isfinite(a.float()).all() and mrel <= GRAD_MAX and fro <= GRAD_FRO):
                raise AssertionError(f"resnetfc_bwd {call} {name}: max/scale {mrel:.3e}, frobenius {fro:.3e}")
            if call == "coarse":
                print(f"resnetfc_bwd {call} {name}: max_abs_err={mx:.3e} max/scale={mrel:.3e} frobenius={fro:.3e}")
        print(f"resnetfc_bwd {call}: every gradient within {GRAD_MAX} of its scale and {GRAD_FRO} Frobenius")
        bwd["max_abs_err"] = max(bwd["max_abs_err"], worst)
        del dz, dxin, dw, wdz, wdxin, wdw, wpre, wpost, want

        fwd["ms"] += _time_ms(torch, lambda: resnetfc_fwd(z, xin, w, *args), 1, 3)
        fwd["plain_ms"] += _time_ms(torch, lambda: resnetfc_fwd_plain(z, xin, w, *args), 1, 2)
        fwd["bound_ms"] += _bound(flops, PEAK_BF16_FLOPS, in_bytes + out_bytes)[0]
        stash["ms"] += _time_ms(torch, lambda: resnetfc_fwd_stash(z, xin, w, *args), 1, 3)
        stash["plain_ms"] += _time_ms(torch, lambda: resnetfc_fwd_plain(z, xin, w, *args, stash=True), 1, 2)
        stash["bound_ms"] += _bound(flops, PEAK_BF16_FLOPS, in_bytes + out_bytes + stash_bytes)[0]
        bwd["ms"] += _time_ms(torch, lambda: resnetfc_bwd(z, xin, gout, spre, spost, w, *args), 1, 3)
        bwd["plain_ms"] += _time_ms(torch, lambda: resnetfc_bwd_plain(z, xin, gout, spre, spost, w, *args), 1, 2)
        grad_bytes = in_bytes - wbytes + sum(t.numel() * 4 for t in w)  # dz, dxin, f32 dW
        bwd["bound_ms"] += _bound(
            2 * flops, PEAK_BF16_FLOPS, in_bytes + out_bytes + stash_bytes + grad_bytes
        )[0]
        del z, xin, gout, spre, spost
        torch.cuda.empty_cache()
    for name, r in (("resnetfc_fwd", fwd), ("resnetfc_fwd_stash", stash), ("resnetfc_bwd", bwd)):
        print(
            f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms (operations), per train step"
        )
    rep = "pixelnerf_tpu/ops/resnetfc_pallas.py"
    return [
        _record("resnetfc_fwd", "cuda", "pixelnerf_tpu_torch/csrc/resnetfc_fwd.cu", f"{rep}:529", fwd, "operations", None),
        _record("resnetfc_fwd_stash", "cuda", "pixelnerf_tpu_torch/csrc/resnetfc_fwd.cu", f"{rep}:551", stash, "operations", None),
        _record("resnetfc_bwd", "cuda", "pixelnerf_tpu_torch/csrc/resnetfc_bwd.cu", f"{rep}:607", bwd, "operations", None),
    ]


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


def profile_view(torch, view, label="one view"):
    """One warm run under torch.profiler: device time by kernel, and the
    share of the run's wall time in which the card ran a kernel."""
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
        f"profile: {label} {wall_ms:.1f} ms wall under the profiler, kernels "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%} busy)"
    )
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"profile: {e.self_device_time_total / 1e3:10.3f} ms x{e.count:<4d} {e.key[:100]}")


def _counters():
    from pixelnerf_tpu_torch.ops.field import pyramid_field_fused
    from pixelnerf_tpu_torch.ops.posenc import posenc_concat
    from pixelnerf_tpu_torch.ops.pyramid import pyramid_gather, pyramid_scatter_add
    from pixelnerf_tpu_torch.ops.resnetfc import resnetfc_bwd, resnetfc_fwd, resnetfc_fwd_stash

    return {
        "posenc_concat": posenc_concat, "pyramid_field_fused": pyramid_field_fused,
        "pyramid_gather": pyramid_gather, "pyramid_scatter_add": pyramid_scatter_add,
        "resnetfc_fwd": resnetfc_fwd, "resnetfc_fwd_stash": resnetfc_fwd_stash,
        "resnetfc_bwd": resnetfc_bwd,
    }


def _counted(torch, fn, expected, label):
    """Run fn with every launch count set to 0 just before and read just
    after; fail unless each kernel launched as often as `expected` says."""
    counters = _counters()
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    res = fn()
    torch.cuda.synchronize()
    got = {name: w.launches for name, w in counters.items()}
    print(f"{label}: launches {got}")
    if got != expected:
        raise AssertionError(f"{label}: launches {got}, expected {expected}")
    return res, got


def _train_batch(torch, np, dev, sb):
    """bench.py's batch: random images, identity cameras at z = 1.3."""
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.uniform(-1, 1, (sb, NV, TRAIN_SIZE, TRAIN_SIZE, 3)).astype(np.float32)
    ).to(dev)
    poses = torch.eye(4, device=dev).repeat(sb, NV, 1, 1)
    poses[..., 2, 3] = 1.3
    return {
        "images": images, "poses": poses,
        "focal": torch.full((sb, 2), float(TRAIN_SIZE), device=dev),
        "c": torch.full((sb, 2), TRAIN_SIZE / 2.0, device=dev),
        "src_images": images[:, :TRAIN_NS], "src_poses": poses[:, :TRAIN_NS],
    }


def _train_model(torch, conf, dev):
    from pixelnerf_tpu_torch.models.pixelnerf import make_model

    model = make_model(conf["model"], device=dev, seed=0, train=True)
    shape_heads(torch, model)
    return model


def compare_step(torch, np, conf, rcfg, dev, dtype_name):
    """One train step on the card against the CPU plain step: the same
    parameters (seeded), injected rays, perturb=0, a small batch."""
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.train.step import make_optimizer, make_train_step, sample_rays

    tol = CMP_TOL[dtype_name]
    batch = {k: v.cpu() for k, v in _train_batch(torch, np, dev, CMP_SB).items()}
    rng = np.random.default_rng(8)
    pix = 2 * TRAIN_SIZE * TRAIN_SIZE + rng.integers(0, TRAIN_SIZE * TRAIN_SIZE, size=(CMP_SB, CMP_RAYS))
    batch["rays"], batch["rgb_gt"] = sample_rays(
        batch["images"], batch["poses"], batch["focal"], batch["c"], 0.8, 1.8, CMP_RAYS,
        draws={"pix": torch.from_numpy(pix)},
    )
    results = []
    for d in (dev, torch.device("cpu")):
        m = make_model(conf["model"], device=d, seed=0, train=True, dtype=getattr(torch, dtype_name))
        shape_heads(torch, m)
        latent = []

        def keep(mod, inp, out):
            for level in out[0]:
                level.retain_grad()
                latent.append(level)

        m.encoder.register_forward_hook(keep)
        t0 = time.perf_counter()
        aux = make_train_step(m, rcfg, make_optimizer(m, 1e-4), CMP_RAYS, 0.8, 1.8)(
            {k: v.to(d) for k, v in batch.items()}
        )
        grads = {n: p.grad.float().cpu() for n, p in m.named_parameters()}
        grads.update({f"encoder output {i}": l.grad.float().cpu() for i, l in enumerate(latent)})
        results.append((aux["t"].item(), grads, time.perf_counter() - t0))
    (loss_d, grads_d, _), (loss_c, grads_c, cpu_s) = results
    rel = abs(loss_d - loss_c) / abs(loss_c)
    worst = {}
    for n, gc in grads_c.items():
        err = ((grads_d[n] - gc).norm() / (gc.norm() + 1e-30)).item()
        part = "latent" if n.startswith("encoder output") else "encoder" if n.startswith("encoder") else "head"
        if err >= worst.get(part, (-1.0, ""))[0]:
            worst[part] = (err, n)
        if not math.isfinite(err) or (tol[part] is not None and err > tol[part]):
            raise AssertionError(f"card vs CPU {dtype_name} step: gradient {n} relative error {err:.3e}")
    print(
        f"train: card vs CPU plain {dtype_name} step ({CMP_SB}x{CMP_RAYS} rays, CPU {cpu_s:.1f} s): "
        f"loss {loss_d:.6f} vs {loss_c:.6f} (rel {rel:.2e}, tolerance {tol['loss']}); worst "
        "relative gradient errors: " + ", ".join(
            f"{part} {e:.2e} ({n}, tolerance {tol[part]})" for part, (e, n) in sorted(worst.items())
        )
    )
    if not rel <= tol["loss"]:
        raise AssertionError(f"card vs CPU {dtype_name} step: losses disagree")


def run_train(torch, np, dev, root, card):
    """The training path at bench.py's shapes."""
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.train.step import make_eval_step, make_optimizer, make_train_step
    from pixelnerf_tpu_torch.utils import hocon

    conf = hocon.load(str(root / "conf" / "exp" / "srn.conf"))
    rcfg = RendererConfig.from_conf(conf["renderer"])
    near, far = 0.8, 1.8
    model = _train_model(torch, conf, dev)
    optimizer = make_optimizer(model, 1e-4)
    step = make_train_step(model, rcfg, optimizer, TRAIN_RAYS, near, far)
    eval_step = make_eval_step(model, rcfg, TRAIN_RAYS, near, far)
    batch = _train_batch(torch, np, dev, SB)
    gen = torch.Generator(device=dev).manual_seed(7)
    print(
        f"train: srn.conf bf16, {sum(p.numel() for p in model.parameters())} params, SB={SB} "
        f"NV={NV} NS={TRAIN_NS} {TRAIN_SIZE}x{TRAIN_SIZE}, {TRAIN_RAYS} rays/object, "
        f"{rcfg.n_coarse} coarse + {rcfg.n_fine} fine samples, Adam"
    )

    aux, train_launches = _counted(torch, lambda: step(batch, gen), TRAIN_LAUNCHES, "train step")
    if not all(torch.isfinite(v).all() for v in aux.values()):
        raise AssertionError(f"non-finite train loss {aux}")
    eaux, eval_launches = _counted(torch, lambda: eval_step(batch, gen), EVAL_LAUNCHES, "eval step")
    if not all(torch.isfinite(v).all() for v in eaux.values()):
        raise AssertionError(f"non-finite eval loss {eaux}")

    for _ in range(WARMUP_STEPS):
        step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        aux = step(batch, gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    losses = {k: round(v.item(), 6) for k, v in aux.items()}
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite train loss {losses}")
    print(
        f"train: {TIMED_STEPS} steps, {step_s * 1e3:.1f} ms/step = "
        f"{SB * TRAIN_RAYS / step_s:.1f} train rays/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, last loss {losses}, on {card}"
    )
    profile_view(torch, lambda: step(batch, gen), "one train step")

    for dtype in CMP_TOL:
        compare_step(torch, np, conf, rcfg.replace(perturb=0.0, noise_std=0.0), dev, dtype)
    launches = dict(train_launches)
    launches["resnetfc_fwd"] = eval_launches["resnetfc_fwd"]
    return launches


def run_slice(torch, np, dev, root, card):
    from pixelnerf_tpu_torch.eval.common import encode_views
    from pixelnerf_tpu_torch.eval.render_utils import render_full
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
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

    t0 = time.perf_counter()
    slice_expected = {name: 0 for name in TRAIN_LAUNCHES}
    slice_expected.update(posenc_concat=2, pyramid_field_fused=2)
    (enc, out), launches = _counted(torch, view, slice_expected, "slice")
    first_s = time.perf_counter() - t0
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
    from pixelnerf_tpu_torch.ops.cuda_build import SOURCES, build_libraries

    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build_libraries(SOURCES)
    print(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"build: {name}: {line.strip()}")

    kernels = [check_posenc(torch, dev), check_field(torch, np, dev)]
    kernels += check_pyramid(torch, np, dev) + check_resnetfc(torch, np, dev)
    torch.cuda.empty_cache()
    launches = run_slice(torch, np, dev, root, card)
    launches.update({k: v for k, v in run_train(torch, np, dev, root, card).items() if k not in ("posenc_concat", "pyramid_field_fused")})
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"the main path never launched {k['name']}")
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
