#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root)

Phases, each failing loudly (an exception and a non-zero exit):

1. require CUDA, print the card's name and power limit, turn TF32 off;
2. build the package's CUDA sources (`csrc/*.cu`), one nvcc each, at once;
3. hold each of the eleven hand-written kernels against its plain PyTorch
   version on the card at the shapes its path gives it, and time both with
   CUDA events: posenc and the field at the render's two chunk shapes
   (coarse, fine); the pyramid gather and scatter and the ResnetFC
   forward, forward with stash and backward at the train step's shapes
   (bench.py's: 4 objects x 1024 rays, 2 source views, 64 coarse + 32
   fine samples); the field's stash forward and backward at the fused
   train step's (64 coarse and all 96 fine samples a ray through the
   field); the bilerp gather and scatter at the nearest-upsampling step's
   (8 composed 64x64x512 maps, 65,536 and 32,768 points a map); every
   gradient of the backwards and of the scatters included;
4. the serving slice: the flagship srn.conf model in bf16 with seeded
   random weights (non-zero fc_1) encodes two synthetic 128x128 views and
   renders one full 128x128 target view through `render_full`; launch
   counters are zeroed just before and read just after, and the first 256
   rays are rendered again on the CPU with the plain versions and
   compared; one more view runs under torch.profiler;
5. the training path at bench.py's shapes: one train step and one eval
   step, each with the launch counters zeroed just before and read just
   after (every kernel of the path must launch as often as the step
   needs it), then warm-up and timed steps (train rays/s, peak memory),
   one step under torch.profiler, and one step of the card held against
   the CPU plain step on the same parameters and injected rays (bf16 and
   float32), and each side's bf16 trunk gradients against its own float32
   step's, layer by layer;
6. path A, training through the fused field: phase 5 for
   `model.with_field_fusion()` (the field's stash forward and backward in
   the train step, its primal in the eval step, no pyramid or ResnetFC
   kernel), its card step held against the CPU plain step in bf16;
7. path B, srn.conf with `encoder.upsample_interp = nearest` (set in
   code): phase 4's view (the bilerp gather and the ResnetFC forward) and
   phase 5's train step (the bilerp gather and scatter and the ResnetFC
   stash forward and backward), its card step held against the CPU plain
   step in bf16;
8. a `kernels` JSON line, the card line, and the result line. A kernel's
   ms, plain_ms, bound_ms and library_ms there are sums over the shapes of
   one view (posenc, field) or of one train step (the others); its
   launches are the most that one counted run of phases 4-7 made.

For the two backwards (the ResnetFC's and the field's) phase 3 also holds
the bf16 cotangents the chain hands the weight-gradient products against
their plain version, the weight gradients of the products (csrc/wgrad.cuh)
against their plain version on the kernel's own stash and cotangents, and
two runs of each backward to bit-identical weight gradients; it prints the
chain (csrc/bwd_chain.cuh) and the weight-gradient products on their own:
launches as the wrapper counted them, ms by kernel name under
torch.profiler, TFLOP/s, bytes moved, bound, and each one's products alone
as bf16 torch.matmul (`chain_*` and `wgrad_*` in their `kernels` records;
for `wgrad`, whose 15 products are each one torch.matmul, that time is also
its `wgrad_library_ms`), and the products' workspace bytes, units and
splits.

For the four forward-chain kernels (the field and ResnetFC primal and
stash forwards, csrc/fwd_chain.cuh) phase 3 also prints TFLOP/s, the L2
weight bytes a point, and `products_ms`: the chain's matrix products alone
as bf16 torch.matmul at the same shapes, a yardstick timed only (it is in
their `kernels` records; `library_ms` stays null, since no single call
computes the chain). It also times the field primal once at NS=3 on the
fine chunk's shape, and a wave of ResnetFC tiles (primal and stash) with
a quarter of the SMs busy, all of them, and ten waves.
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
# fine pass queries the 64 cached coarse samples and the 32 new ones, or,
# through the fused field (no query cache), all 96
SB, NV, TRAIN_NS, TRAIN_SIZE, TRAIN_RAYS = 4, 3, 2, 128, 1024
WARMUP_STEPS, TIMED_STEPS = 2, 10
N_COARSE, N_NEW = 64, 32
MLP_CALLS = {"coarse": N_COARSE, "fine cached": N_COARSE, "fine new": N_NEW}
LOOKUPS = {"coarse": N_COARSE, "fine new": N_NEW}
FIELD_CALLS = {"coarse": N_COARSE, "fine": N_COARSE + N_NEW}
LEVELS = [(64, 64, 128), (16, 16, 128), (8, 8, 256)]  # srn.conf at 128x128
COMPOSED = (64, 64, 512)  # the nearest-upsampled pyramid, one map a view
D_IN, HIDDEN, D_OUT, N_BLOCKS, COMBINE = 42, 512, 4, 5, 3
D_IN_PAD = -(-D_IN // 16) * 16
KERNELS = (
    "posenc_concat", "pyramid_field_fused", "pyramid_field_fused_fwd_stash",
    "pyramid_field_fused_bwd", "pyramid_gather", "pyramid_scatter_add", "resnetfc_fwd",
    "resnetfc_fwd_stash", "resnetfc_bwd", "bilerp_gather", "bilerp_scatter_add",
)


def _launch_table(**counts):
    table = dict.fromkeys(KERNELS, 0)
    table.update(counts)
    return table


# launches each counted run makes (the table in PERF.md)
VIEW_LAUNCHES = _launch_table(posenc_concat=2, pyramid_field_fused=2)
TRAIN_LAUNCHES = _launch_table(
    posenc_concat=2, pyramid_gather=2, pyramid_scatter_add=2, resnetfc_fwd_stash=3, resnetfc_bwd=3,
)
EVAL_LAUNCHES = _launch_table(posenc_concat=2, pyramid_gather=2, resnetfc_fwd=3)
FUSED_TRAIN_LAUNCHES = _launch_table(
    posenc_concat=2, pyramid_field_fused_fwd_stash=2, pyramid_field_fused_bwd=2,
)
FUSED_EVAL_LAUNCHES = _launch_table(posenc_concat=2, pyramid_field_fused=2)
NEAREST_VIEW_LAUNCHES = _launch_table(posenc_concat=2, bilerp_gather=2, resnetfc_fwd=2)
NEAREST_TRAIN_LAUNCHES = _launch_table(
    posenc_concat=2, bilerp_gather=2, bilerp_scatter_add=2, resnetfc_fwd_stash=3, resnetfc_bwd=3,
)
NEAREST_EVAL_LAUNCHES = _launch_table(posenc_concat=2, bilerp_gather=2, resnetfc_fwd=3)
# kernels against plain versions: the gathers, one bf16 ulp (the same exact
# products summed in another order); the scatters, float32 atomics in any
# order; the ResnetFC and field forwards as the field; their gradients,
# bf16 operands and float32 sums in other orders through 5 blocks: max
# error <= 5e-2 of the largest magnitude, Frobenius error <= 2e-2 relative
SCATTER_RTOL, SCATTER_ATOL = 1e-4, 1e-4
GRAD_MAX, GRAD_FRO = 5e-2, 2e-2
# the weight-gradient products against their plain version on the same bf16
# stash and cotangents: both multiply the same bf16 operands exactly, and
# differ only in the order of their float32 sums over the point axis. At
# the flagship shapes a split sums up to ~48k points in the tensor cores'
# accumulators, ~3,000 k16 accumulations: up to ~3,000 x 2^-24 = 1.8e-4
# relative on a partial (the card tests' few hundred points hold 1e-5)
WGRAD_MAX, WGRAD_FRO = 2e-3, 2e-4
WGRAD_WEIGHTS = ("w_in", "wz", "w0", "w1", "w_out")
WGRAD_LAUNCHES = 2  # a backward call: the grouped products, the reduction
# card step vs CPU plain step (perturb=0, injected rays, full width): the
# relative error of the loss, of the gradient at the encoder's output (what
# the pyramid scatter hands the trunk) and of each parameter gradient
# (Frobenius). bf16, the flagship, with every kernel on the card: cuDNN and
# the CPU round the trunk's bf16 activations and gradients at other
# places, and train-mode BatchNorm subtracts nearly equal terms in the
# trunk's parameter gradients. Each side's bf16 trunk gradients differ from
# its own float32 step's by up to ~0.63 relative, the card's within 1.26x
# of the CPU's layer by layer (trunk_precision; NVIDIA H100 80GB HBM3,
# 700 W): rounding, not a fault. So the bf16 trunk is held to 0.75 against
# the CPU (measured 0.53-0.54 on the three paths) and each layer's card
# error to TRUNK_RATIO times the CPU's; the float32 step (the same path
# without the bf16 kernels) holds every parameter to 3e-2.
CMP_SB, CMP_RAYS = 2, 64
CMP_TOL = {
    "bfloat16": {"loss": 1e-2, "latent": 1e-1, "head": 5e-2, "encoder": 0.75},
    "float32": {"loss": 1e-4, "latent": 1e-2, "head": 1e-2, "encoder": 3e-2},
}
TRUNK_RATIO = 1.5


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


def _device_ms(torch, fn, iters: int) -> float:
    """The device time of `fn` for a launch shorter than its host-side
    cost: the card sleeps while the host queues the launches, so the
    timed launches run back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # cycles: ~50 ms, longer than queueing `iters` launches
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


def _products_ms(torch, dev, g, sb, ns, b, d_in_pad, d_latent):
    """A yardstick, timed only and never on the port's path: the forward
    chain's matrix products alone, as bf16 torch.matmul at the kernel's
    shapes (the pre-pool products over SB*NS*B rows, the others over SB*B;
    no bias, relu, pooling, stash or gather)."""
    n_inj = min(COMBINE, N_BLOCKS)
    k = n_inj if ns > 1 else 0
    pre, post = sb * ns * b, sb * b
    r = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    w_in, wz, w, w_out = r(d_in_pad, HIDDEN), r(d_latent, HIDDEN), r(HIDDEN, HIDDEN), r(HIDDEN, D_OUT)
    xin, z, act = r(pre, d_in_pad), r(pre, d_latent), r(pre, HIDDEN)

    def run():
        xin @ w_in
        for _ in range(n_inj):
            z @ wz
        for i in range(N_BLOCKS):
            a = act if i < k else act[:post]
            a @ w
            a @ w
        act[:post] @ w_out

    return _time_ms(torch, run, 1, 3)


def _chain_line(name, flops, ms, products_ms, ns, wbytes, per):
    """TFLOP/s, the L2 weight bytes a point (every CTA reads a head's
    weights once for its max(1, 64 // NS) points) and the products'
    yardstick of one forward-chain kernel."""
    print(
        f"{name}: {ms:.3f} ms {per}, {flops / ms / 1e9:.1f} TFLOP/s "
        f"({flops / ms / 1e9 / (PEAK_BF16_FLOPS / 1e12):.1%} of the bf16 peak), L2 weight bytes a "
        f"point {wbytes / max(1, 64 // ns):.0f}, products alone (bf16 torch.matmul) "
        f"{products_ms:.3f} ms = {flops / products_ms / 1e9:.1f} TFLOP/s"
    )


def _bwd_split(torch, fn, calls: int = 3, tries: int = 3):
    """Device ms and launches a call of the backward's two parts (the
    cotangent chain; the weight-gradient products and their reduction) over `calls` warm
    calls under torch.profiler. The launches are those the wrapper counted
    where it launched them (`launch_bwd.chain_launches` and
    `.wgrad_launches`) over `calls`; the ms are the kernel's recorded
    device time over `calls`. The profiler can drop a kernel's record
    (PERF.md §7): a run whose records do not number the counted launches is
    profiled again, and after `tries` such runs the phase fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pixelnerf_tpu_torch.ops.resnetfc import launch_bwd

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        launch_bwd.chain_launches = launch_bwd.wgrad_launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counted = {"chain": launch_bwd.chain_launches, "wgrad": launch_bwd.wgrad_launches}
        if counted["chain"] != calls or counted["wgrad"] != WGRAD_LAUNCHES * calls:
            raise AssertionError(f"the backward's launches over {calls} calls: {counted}")
        total = {"chain": [0.0, 0], "wgrad": [0.0, 0]}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            part = ("chain" if "bwd_chain_kernel" in e.key
                    else "wgrad" if "wgrad_products" in e.key or "wgrad_reduce" in e.key else None)
            if part:
                total[part][0] += e.self_device_time_total / 1e3
                total[part][1] += e.count
        if all(total[k][1] == counted[k] for k in total):
            return {k: [ms / calls, counted[k] / calls] for k, (ms, _) in total.items()}
        print(f"the backward under the profiler: records {total}, launches {counted}; again")
    raise AssertionError(f"the profiler dropped the backward's records in {tries} runs")


def _bwd_products_ms(torch, dev, g, sb, ns, b, d_in_pad, d_latent):
    """Yardsticks, timed only and never on the port's path: the backward
    chain's matrix products alone (per block G1 @ W1^T and G0 @ W0^T, then
    g_z as one K = n_inj * H product and dxin) and the weight-gradient
    products (act^T @ G for each of the 15 weights), as bf16 torch.matmul
    at the kernels' shapes."""
    n_inj = min(COMBINE, N_BLOCKS)
    k = n_inj if ns > 1 else 0
    pre, post = sb * ns * b, sb * b
    r = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    w, wz, w_in = r(HIDDEN, HIDDEN), r(n_inj * HIDDEN, d_latent), r(HIDDEN, d_in_pad)
    act, z, xin, gout = r(pre, HIDDEN), r(pre, d_latent), r(pre, d_in_pad), r(post, 16)
    gcat = r(pre, n_inj * HIDDEN)

    def chain():
        for i in range(N_BLOCKS):
            a = act if i < k else act[:post]
            a @ w
            a @ w
        gcat @ wz
        act @ w_in

    def wgrad():
        for i in range(N_BLOCKS):
            a = act if i < k else act[:post]
            a.t() @ a
            a.t() @ a
        for _ in range(n_inj):
            z.t() @ act
        xin.t() @ act
        act[:post].t() @ gout

    return _time_ms(torch, chain, 1, 3), _time_ms(torch, wgrad, 1, 3)


def _bwd_lines(name, per, split, bwd_flops, chain_bytes, wgrad_bytes, products, plans):
    """The backward's two parts on their own: ms, launches, TFLOP/s and
    bytes of a step, bound and products yardstick each; the weight-gradient
    products' workspace, units and splits of each call (`plans`)."""
    res = {}
    for part, nbytes, prod in (("chain", chain_bytes, products[0]), ("wgrad", wgrad_bytes, products[1])):
        ms, launches = split[part]
        bound_ms, bound_by = _bound(bwd_flops, PEAK_BF16_FLOPS, nbytes)
        print(
            f"{name} {part}: {ms:.3f} ms {per}, {launches:g} launches, "
            f"{bwd_flops / ms / 1e9:.1f} TFLOP/s, {nbytes / 1e9:.3f} GB moved "
            f"({nbytes / ms / 1e6:.1f} GB/s), bound {bound_ms:.3f} ms ({bound_by}), products alone "
            f"(bf16 torch.matmul) {prod:.3f} ms"
        )
        res.update({f"{part}_ms": ms, f"{part}_launches": launches, f"{part}_bound_ms": bound_ms,
                    f"{part}_products_ms": prod})
    for call, plan in plans.items():
        print(f"{name} wgrad plan {call}: workspace {plan['workspace_bytes']} bytes, "
              f"{plan['units']} units, splits {plan['splits'][0]} (pre-pool) to {plan['splits'][1]}, "
              f"TMA boxes {plan['box_bytes'] / 1e9:.3f} GB")
    boxes = sum(p["box_bytes"] for p in plans.values())
    print(f"{name} wgrad: TMA boxes {boxes / 1e9:.3f} GB {per} read from L2, "
          f"{boxes / split['wgrad'][0] / 1e9:.3f} TB/s")
    res["wgrad_library_ms"] = products[1]
    res["wgrad_workspace_bytes"] = max(p["workspace_bytes"] for p in plans.values())
    return res


def _look_at(np, eye):
    eye = np.asarray(eye, np.float64)
    back = eye / np.linalg.norm(eye)
    x = np.cross([0.0, 1.0, 0.0], back)
    x /= np.linalg.norm(x)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, np.cross(back, x), back, eye
    return pose.astype(np.float32)


def _record(name, route, source, replaces, res, bound_by, library_ms):
    return dict(
        name=name, route=route, source=source, replaces=replaces, **res,
        bound_by=bound_by, library_ms=library_ms,
    )


def _ulp_check(torch, name, got, want):
    """The gathers: within one bf16 ulp of the plain version (plus 1e-6)."""
    diff = (got.float() - want.float()).abs()
    bad = diff - 2.0 ** -7 * want.float().abs() - 1e-6
    if not (torch.isfinite(got.float()).all() and bad.max().item() <= 0):
        i = int(bad.argmax())
        raise AssertionError(
            f"{name} disagrees with its plain version: {int((bad > 0).sum())} elements, "
            f"worst at flat index {i}: kernel {got.flatten()[i].item()} plain "
            f"{want.flatten()[i].item()}; finite {bool(torch.isfinite(got.float()).all())}"
        )
    return diff.max().item()


def _grad_err(got, want):
    """(max abs error, max abs error / max |want|, relative Frobenius error)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    scale = want.abs().max().item() + 1e-30
    return d.max().item(), d.max().item() / scale, ((got - want).norm() / (want.norm() + 1e-30)).item()


def _check_grads(torch, label, pairs, verbose):
    """Every (name, kernel, plain) gradient within GRAD_MAX of its scale and
    GRAD_FRO Frobenius; returns the largest absolute error."""
    worst = 0.0
    for name, a, b in pairs:
        mx, mrel, fro = _grad_err(a, b)
        worst = max(worst, mx)
        if not (torch.isfinite(a.float()).all() and mrel <= GRAD_MAX and fro <= GRAD_FRO):
            raise AssertionError(f"{label} {name}: max/scale {mrel:.3e}, frobenius {fro:.3e}")
        if verbose:
            print(f"{label} {name}: max_abs_err={mx:.3e} max/scale={mrel:.3e} frobenius={fro:.3e}")
    print(f"{label}: every gradient within {GRAD_MAX} of its scale and {GRAD_FRO} Frobenius")
    return worst


def _check_wgrad(torch, label, dw, again, want):
    """The weight-gradient products (csrc/wgrad.cuh) of one backward within
    WGRAD_MAX of each gradient's scale and WGRAD_FRO Frobenius of their
    plain version on the kernel's own stash and cotangents (`want`), and
    bit-identical to a second run's (`again`)."""
    bad = []
    for name in WGRAD_WEIGHTS:
        got = getattr(dw, name)
        same = torch.equal(got, getattr(again, name))
        mx, mrel, fro = _grad_err(got, want[name])
        print(f"{label} wgrad d{name}: max_abs_err={mx:.3e} max/scale={mrel:.3e} "
              f"frobenius={fro:.3e}; second run bit-identical: {same}")
        if not (torch.isfinite(got).all() and mrel <= WGRAD_MAX and fro <= WGRAD_FRO and same):
            bad.append(f"d{name}")
    if bad:
        raise AssertionError(f"{label} wgrad: {bad} beyond the bounds or not bit-identical")
    print(f"{label} wgrad: every weight gradient within {WGRAD_MAX} of its scale and {WGRAD_FRO} "
          f"Frobenius of the plain products, two runs bit-identical")


def _random_weights(torch, g, dev, d_latent):
    """Random (in, out) ResnetFC weights of the flagship head; fc_1 non-zero
    (a zero-initialized fc_1 would hide the block chain)."""
    from pixelnerf_tpu_torch.ops.field import FieldWeights

    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
    return FieldWeights(
        w_in=rnd(D_IN, HIDDEN, scale=D_IN ** -0.5), b_in=rnd(HIDDEN, scale=0.1),
        wz=rnd(3, d_latent, HIDDEN, scale=d_latent ** -0.5), bz=rnd(3, HIDDEN, scale=0.1),
        w0=rnd(N_BLOCKS, HIDDEN, HIDDEN, scale=HIDDEN ** -0.5), b0=rnd(N_BLOCKS, HIDDEN, scale=0.1),
        w1=rnd(N_BLOCKS, HIDDEN, HIDDEN, scale=0.5 * HIDDEN ** -0.5), b1=rnd(N_BLOCKS, HIDDEN, scale=0.1),
        w_out=rnd(HIDDEN, D_OUT, scale=HIDDEN ** -0.5), b_out=rnd(D_OUT, scale=0.1),
    )


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
        field_flops, field_plain, pack_field_weights, pyramid_field_fused,
    )

    ns, sb = NS, 1
    d_latent = sum(c for _, _, c in LEVELS)
    g = torch.Generator(device=dev).manual_seed(2)
    feats = [(torch.randn((sb * ns, h, w, c), generator=g, device=dev)).to(torch.bfloat16) for h, w, c in LEVELS]
    # packed once, as ResnetFC.field_weights packs a head's weights
    w = pack_field_weights(_random_weights(torch, g, dev, d_latent))
    res = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, products_ms=0.0)
    wbytes = sum(t.numel() * 2 for t in (w.w_in, w.wz, w.w0, w.w1))
    total_flops = 0.0
    for chunk, k in CHUNK_SAMPLES.items():
        b = CHUNK_RAYS * k
        grid = torch.rand((sb, ns, b, 2), generator=g, device=dev) * 2.2 - 1.1
        xin = (torch.randn((sb, ns, b, D_IN), generator=g, device=dev)).to(torch.bfloat16)
        run = lambda: pyramid_field_fused(feats, grid, xin, w, N_BLOCKS, COMBINE, ns)
        plain = lambda: field_plain(feats, grid, xin, w, N_BLOCKS, COMBINE, ns)
        got = run()
        torch.cuda.synchronize()
        want = plain()
        diff = (got - want).abs()
        err = diff.max().item()
        excess = (diff - (FIELD_ATOL + FIELD_RTOL * want.abs())).max().item()
        print(
            f"field {chunk}: NS={ns} B={b} hidden={HIDDEN} max_abs_err={err:.3e} "
            f"mean_abs_err={diff.mean().item():.3e} |out| mean={want.abs().mean().item():.3f} "
            f"(tolerance {FIELD_ATOL} + {FIELD_RTOL}*|plain|)"
        )
        if not (torch.isfinite(got).all() and excess <= 0):
            raise AssertionError(f"field kernel disagrees with its plain version: {err}")
        del got, want, diff
        ms = _time_ms(torch, run, 1, 5)
        plain_ms = _time_ms(torch, plain, 1, 2)
        flops = field_flops(ns, D_IN, d_latent, HIDDEN, D_OUT, N_BLOCKS, COMBINE) * b * sb
        nbytes = (
            sum(f.numel() * 2 for f in feats) + grid.numel() * 4 + xin.numel() * 2
            + sum(t.numel() * t.element_size() for t in w) + sb * b * D_OUT * 4
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
        res["products_ms"] += _products_ms(torch, dev, g, sb, ns, b, w.w_in.shape[0], d_latent)
        total_flops += flops
    _chain_line("pyramid_field_fused", total_flops, res["ms"], res["products_ms"], ns, wbytes, "a view")
    # the fine chunk's shape at NS=3: 21 points x 3 views fill 63 of the
    # tile's 64 rows before the pooling, 21 after it
    ns3, b = 3, CHUNK_RAYS * CHUNK_SAMPLES["fine"]
    feats3 = [torch.randn((ns3, h, wd, c), generator=g, device=dev).to(torch.bfloat16) for h, wd, c in LEVELS]
    grid = torch.rand((1, ns3, b, 2), generator=g, device=dev) * 2.2 - 1.1
    xin = torch.randn((1, ns3, b, D_IN), generator=g, device=dev).to(torch.bfloat16)
    run = lambda: pyramid_field_fused(feats3, grid, xin, w, N_BLOCKS, COMBINE, ns3)
    if not torch.isfinite(run()).all():
        raise AssertionError("the field at NS=3 gave non-finite values")
    ms = _time_ms(torch, run, 1, 3)
    flops = field_flops(ns3, D_IN, d_latent, HIDDEN, D_OUT, N_BLOCKS, COMBINE) * b
    print(
        f"field fine chunk at NS=3: B={b} {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s, "
        f"{flops / 1e9 / b:.4f} GFLOP a point (NS=2: "
        f"{field_flops(ns, D_IN, d_latent, HIDDEN, D_OUT, N_BLOCKS, COMBINE) / 1e9:.4f})"
    )
    del feats3, grid, xin
    return dict(
        name="pyramid_field_fused", route="cuda", source="pixelnerf_tpu_torch/csrc/field_fwd.cu",
        replaces="pixelnerf_tpu/ops/field_pallas.py:332", **res, bound_by=bound_by,
        library_ms=None,
    )


def check_field_vjp(torch, np, dev):
    """The field's stash forward and backward at the fused train step's two
    field calls (the coarse pass, and the fine pass's 96 samples a ray),
    against their plain versions: the output, the z-stash, and every
    gradient from the kernel's own stash."""
    from pixelnerf_tpu_torch.ops.field import (
        FieldWeights, field_bwd_plain, field_flops, field_plain, pyramid_field_fused_bwd,
        pyramid_field_fused_fwd_stash,
    )
    from pixelnerf_tpu_torch.ops.resnetfc import launch_bwd, resnetfc_wgrad_plain

    g = torch.Generator(device=dev).manual_seed(9)
    ns, dl = TRAIN_NS, sum(c for _, _, c in LEVELS)
    w = _random_weights(torch, g, dev, dl)
    feats = [torch.randn((SB * ns, h, ww, c), generator=g, device=dev).to(torch.bfloat16) for h, ww, c in LEVELS]
    feat_bytes = sum(f.numel() * 2 for f in feats)
    wbytes = sum(t.numel() * 2 for t in w)  # bf16 operands
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms")
    fwd, bwd = ({k: 0.0 for k in keys} for _ in range(2))
    fwd["products_ms"], fwd_flops = 0.0, 0.0
    split = {"chain": [0.0, 0], "wgrad": [0.0, 0]}
    chain_bytes = wgrad_bytes = 0.0
    products = [0.0, 0.0]
    plans = {}
    args = (N_BLOCKS, COMBINE, ns)
    for call, k in FIELD_CALLS.items():
        b = TRAIN_RAYS * k
        grid = torch.rand((SB, ns, b, 2), generator=g, device=dev) * 2.2 - 1.1
        xin = torch.randn((SB, ns, b, D_IN), generator=g, device=dev).to(torch.bfloat16)
        gout = torch.randn((SB, b, D_OUT), generator=g, device=dev) * 1e-3
        flops = field_flops(ns, D_IN, dl, HIDDEN, D_OUT, N_BLOCKS, COMBINE) * SB * b
        in_bytes = feat_bytes + grid.numel() * 4 + xin.numel() * 2 + wbytes
        out_bytes = SB * b * D_OUT * 4

        out, zs, spre, spost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)
        torch.cuda.synchronize()
        want, wz, wpre, wpost = field_plain(feats, grid, xin, w, *args, stash=True)
        diff = (out - want).abs()
        excess = (diff - (FIELD_ATOL + FIELD_RTOL * want.abs())).max().item()
        print(
            f"pyramid_field_fused_fwd_stash {call}: SB={SB} NS={ns} B={b} "
            f"max_abs_err={diff.max().item():.3e} |out| mean={want.abs().mean().item():.3f} "
            f"(tolerance {FIELD_ATOL} + {FIELD_RTOL}*|plain|)"
        )
        if not (torch.isfinite(out).all() and excess <= 0):
            raise AssertionError("the field's stash forward disagrees with its plain version")
        z_err = _ulp_check(torch, f"the field's z-stash ({call})", zs, wz)
        print(f"pyramid_field_fused_fwd_stash {call}: z-stash max_abs_err={z_err:.3e} (tolerance one bf16 ulp)")
        stash_bytes = sum(t.numel() * 2 for t in (zs, spre, spost) if t is not None)
        fwd["max_abs_err"] = max(fwd["max_abs_err"], diff.max().item())
        del out, want, wz, wpre, wpost, diff

        d_feats, dxin, dw = pyramid_field_fused_bwd(grid, xin, gout, zs, spre, spost, w, *args, LEVELS)
        torch.cuda.synchronize()
        wd_feats, wdxin, wdw = field_bwd_plain(grid, xin, gout, zs, spre, spost, w, *args, LEVELS)
        pairs = [(f"d_feat {i}", a, b_) for i, (a, b_) in enumerate(zip(d_feats, wd_feats))]
        pairs += [("dxin", dxin, wdxin)] + [(f"d{n}", getattr(dw, n), getattr(wdw, n)) for n in FieldWeights._fields]
        worst = _check_grads(torch, f"pyramid_field_fused_bwd {call}", pairs, call == "coarse")
        bwd["max_abs_err"] = max(bwd["max_abs_err"], worst)
        # the weight-gradient products on the kernel's own cotangents, and a
        # second run of the backward
        again, cots = launch_bwd(zs, xin, gout, spre, spost, w, *args, levels=LEVELS, grid=grid)[2:]
        torch.cuda.synchronize()
        plans[call] = dict(launch_bwd.wgrad_plan)
        _check_wgrad(torch, f"pyramid_field_fused_bwd {call}", dw, again,
                     resnetfc_wgrad_plain(zs, xin, spre, spost, *cots, *args, D_OUT))
        del d_feats, dxin, dw, wd_feats, wdxin, wdw, pairs, again, cots

        fwd["ms"] += _time_ms(torch, lambda: pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args), 1, 3)
        fwd["plain_ms"] += _time_ms(torch, lambda: field_plain(feats, grid, xin, w, *args, stash=True), 1, 2)
        fwd["bound_ms"] += _bound(flops, PEAK_BF16_FLOPS, in_bytes + out_bytes + stash_bytes)[0]
        fwd["products_ms"] += _products_ms(torch, dev, g, SB, ns, b, D_IN_PAD, dl)
        fwd_flops += flops
        bwd["ms"] += _time_ms(
            torch, lambda: pyramid_field_fused_bwd(grid, xin, gout, zs, spre, spost, w, *args, LEVELS), 1, 3,
        )
        bwd["plain_ms"] += _time_ms(
            torch, lambda: field_bwd_plain(grid, xin, gout, zs, spre, spost, w, *args, LEVELS), 1, 2,
        )
        # read: grid, xin, g, the stash, the weights; written: dxin, the f32
        # level gradients, the f32 weight gradients
        grad_bytes = xin.numel() * 2 + feat_bytes * 2 + sum(t.numel() * 4 for t in w)
        bwd["bound_ms"] += _bound(
            2 * flops, PEAK_BF16_FLOPS,
            grid.numel() * 4 + xin.numel() * 2 + out_bytes + stash_bytes + wbytes + grad_bytes,
        )[0]
        # the chain reads g, the grid, the activation stash and the weights
        # and writes dxin, the f32 level gradients and the cotangents; the
        # products read the stash (z-stash too), xin and the cotangents and
        # write the f32 weight gradients
        for part, (ms, n) in _bwd_split(
            torch, lambda: pyramid_field_fused_bwd(grid, xin, gout, zs, spre, spost, w, *args, LEVELS)
        ).items():
            split[part][0] += ms
            split[part][1] += n
        act_bytes = sum(t.numel() * 2 for t in (spre, spost) if t is not None)
        cot_bytes = act_bytes - SB * b * HIDDEN * 2 + SB * ns * b * HIDDEN * 2 + SB * b * 16 * 2
        chain_bytes += (out_bytes + grid.numel() * 4 + act_bytes + wbytes + cot_bytes
                        + xin.numel() * 2 + feat_bytes * 2)
        wgrad_bytes += stash_bytes + xin.numel() * 2 + cot_bytes + sum(t.numel() * 4 for t in w)
        pm = _bwd_products_ms(torch, dev, g, SB, ns, b, D_IN_PAD, dl)
        products = [products[0] + pm[0], products[1] + pm[1]]
        del grid, xin, gout, zs, spre, spost
        torch.cuda.empty_cache()
    _chain_line("pyramid_field_fused_fwd_stash", fwd_flops, fwd["ms"], fwd["products_ms"], ns,
                sum(t.numel() * 2 for t in (w.w_in, w.wz, w.w0, w.w1)), "a fused train step")
    for name, r in (("pyramid_field_fused_fwd_stash", fwd), ("pyramid_field_fused_bwd", bwd)):
        print(
            f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms (operations), per fused train step"
        )
    bwd.update(_bwd_lines("pyramid_field_fused_bwd", "a fused train step", split, fwd_flops,
                          chain_bytes, wgrad_bytes, products, plans))
    rep = "pixelnerf_tpu/ops/field_pallas.py"
    return [
        _record("pyramid_field_fused_fwd_stash", "cuda", "pixelnerf_tpu_torch/csrc/field_fwd.cu",
                f"{rep}:447", fwd, "operations", None),
        _record("pyramid_field_fused_bwd", "cuda", "pixelnerf_tpu_torch/csrc/resnetfc_bwd.cu",
                f"{rep}:464", bwd, "operations", None),
    ]


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
        err = _ulp_check(torch, "pyramid_gather", got, want)
        print(f"pyramid_gather {pass_}: maps={maps} N={n} max_abs_err={err:.3e} (tolerance one bf16 ulp)")
        gat["max_abs_err"] = max(gat["max_abs_err"], err)
        del got, want
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


def check_bilerp(torch, np, dev):
    """The single-map gather and scatter at the nearest-upsampling step's
    two lookups (the coarse one, whose two consumers' cotangents autograd
    adds before the scatter, and the fine pass's new samples), against
    their plain versions and against grid_sample (and its backward) on the
    same map in NCHW, which the port never calls."""
    import torch.nn.functional as F

    from pixelnerf_tpu_torch.ops.scatter import (
        _taps, bilerp_gather, bilerp_gather_plain, bilerp_scatter_add, bilerp_scatter_add_plain,
    )

    g = torch.Generator(device=dev).manual_seed(10)
    maps, (hl, wl, c) = SB * TRAIN_NS, COMPOSED
    feat = torch.randn((maps, hl, wl, c), generator=g, device=dev).to(torch.bfloat16)
    nchw = feat.permute(0, 3, 1, 2).contiguous()
    gat = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    sca = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for pass_, k in LOOKUPS.items():
        n = TRAIN_RAYS * k
        uv = torch.rand((maps, n, 2), generator=g, device=dev) * 2.2 - 1.1
        taps = int((_taps(uv, hl, wl)[1] != 0).sum()) * c
        got = bilerp_gather(feat, uv)
        torch.cuda.synchronize()
        want = bilerp_gather_plain(feat, uv)
        err = _ulp_check(torch, "bilerp_gather", got, want)
        print(f"bilerp_gather {pass_}: maps={maps} {hl}x{wl}x{c} N={n} max_abs_err={err:.3e} (tolerance one bf16 ulp)")
        gat["max_abs_err"] = max(gat["max_abs_err"], err)
        del got, want
        gat["ms"] += _time_ms(torch, lambda: bilerp_gather(feat, uv), 3, 20)
        gat["plain_ms"] += _time_ms(torch, lambda: bilerp_gather_plain(feat, uv), 1, 3)
        grid = uv[:, None].to(torch.bfloat16)  # grid_sample takes the map's dtype
        gat["library_ms"] += _time_ms(torch, lambda: F.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="border", align_corners=True), 3, 20)
        out_bytes = maps * n * c * 2
        gat["bound_ms"] += _bound(2.0 * taps, PEAK_F32_FLOPS, feat.numel() * 2 + uv.numel() * 4 + out_bytes)[0]

        dz = (torch.randn((maps, n, c), generator=g, device=dev) * 1e-3).to(torch.bfloat16)
        got = bilerp_scatter_add(uv, dz, hl, wl)
        torch.cuda.synchronize()
        want = bilerp_scatter_add_plain(uv, dz, hl, wl)
        d = (got - want).abs()
        print(
            f"bilerp_scatter_add {pass_}: max_abs_err={d.max().item():.3e} "
            f"(tolerance {SCATTER_RTOL}*|plain| + {SCATTER_ATOL}*max|plain|)"
        )
        if not bool((d <= SCATTER_ATOL * want.abs().max() + SCATTER_RTOL * want.abs()).all()):
            raise AssertionError("bilerp_scatter_add disagrees with its plain version")
        sca["max_abs_err"] = max(sca["max_abs_err"], d.max().item())
        del got, want, d
        sca["ms"] += _time_ms(torch, lambda: bilerp_scatter_add(uv, dz, hl, wl), 3, 20)
        sca["plain_ms"] += _time_ms(torch, lambda: bilerp_scatter_add_plain(uv, dz, hl, wl), 1, 3)
        gout = dz.permute(0, 2, 1)[:, :, None].contiguous()  # (maps, C, 1, N)
        sca["library_ms"] += _time_ms(torch, lambda: torch.ops.aten.grid_sampler_2d_backward(
            gout, nchw, grid, 0, 1, True, [True, False]), 3, 20)
        sca["bound_ms"] += _bound(
            2.0 * taps, PEAK_F32_FLOPS, out_bytes + uv.numel() * 4 + feat.numel() * 4
        )[0]
        del dz, gout
    for name, r in (("bilerp_gather", gat), ("bilerp_scatter_add", sca)):
        print(
            f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, grid_sample "
            f"{'backward ' if name.endswith('add') else ''}{r['library_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms (bytes), per nearest train step"
        )
    src, rep = "pixelnerf_tpu_torch/csrc/bilerp.cu", "pixelnerf_tpu/ops/scatter_pallas.py"
    return [
        _record("bilerp_gather", "cuda", src, f"{rep}:110", gat, "bytes", gat.pop("library_ms")),
        _record("bilerp_scatter_add", "cuda", src, f"{rep}:172", sca, "bytes", sca.pop("library_ms")),
    ]


def check_resnetfc(torch, np, dev):
    """The ResnetFC forward (no stash), forward with stash and backward at
    the train step's three MLP calls, against the plain versions: outputs,
    and dz, dxin and every weight gradient from the same stash."""
    from pixelnerf_tpu_torch.ops.field import FieldWeights, field_flops
    from pixelnerf_tpu_torch.ops.resnetfc import (
        launch_bwd, resnetfc_bwd, resnetfc_bwd_plain, resnetfc_cotangents_plain, resnetfc_fwd,
        resnetfc_fwd_plain, resnetfc_fwd_stash, resnetfc_wgrad_plain,
    )

    g = torch.Generator(device=dev).manual_seed(6)
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
    ns, dl = TRAIN_NS, sum(c for _, _, c in LEVELS)
    w = _random_weights(torch, g, dev, dl)
    wbytes = sum(t.numel() * 2 for t in w)  # bf16 operands
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms")
    fwd, stash, bwd = ({k: 0.0 for k in keys} for _ in range(3))
    fwd["products_ms"] = stash["products_ms"] = 0.0
    total_flops = 0.0
    split = {"chain": [0.0, 0], "wgrad": [0.0, 0]}
    chain_bytes = wgrad_bytes = 0.0
    products = [0.0, 0.0]
    plans = {}
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
        pairs = [("dz", dz, wdz), ("dxin", dxin, wdxin)] + [
            (f"d{n}", getattr(dw, n), getattr(wdw, n)) for n in FieldWeights._fields
        ]
        # the bf16 cotangents the chain hands the weight-gradient products,
        # the products on them, and a second run of the backward
        again, cots = launch_bwd(z, xin, gout, spre, spost, w, *args)[2:]
        torch.cuda.synchronize()
        plans[call] = dict(launch_bwd.wgrad_plan)
        _check_wgrad(torch, f"resnetfc_bwd {call}", dw, again,
                     resnetfc_wgrad_plain(z, xin, spre, spost, *cots, *args, D_OUT))
        wcots = resnetfc_cotangents_plain(gout, spre, spost, w, *args)
        pairs += [(n, a, b_) for n, a, b_ in zip(("gpre", "gpost", "gin", "gout"), cots, wcots)
                  if a is not None]
        worst = _check_grads(torch, f"resnetfc_bwd {call}", pairs, call == "coarse")
        bwd["max_abs_err"] = max(bwd["max_abs_err"], worst)
        cot_bytes = sum(t.numel() * 2 for t in cots if t is not None)
        del dz, dxin, dw, wdz, wdxin, wdw, wpre, wpost, want, pairs, cots, wcots, again

        fwd["ms"] += _time_ms(torch, lambda: resnetfc_fwd(z, xin, w, *args), 1, 3)
        fwd["plain_ms"] += _time_ms(torch, lambda: resnetfc_fwd_plain(z, xin, w, *args), 1, 2)
        fwd["bound_ms"] += _bound(flops, PEAK_BF16_FLOPS, in_bytes + out_bytes)[0]
        stash["ms"] += _time_ms(torch, lambda: resnetfc_fwd_stash(z, xin, w, *args), 1, 3)
        stash["plain_ms"] += _time_ms(torch, lambda: resnetfc_fwd_plain(z, xin, w, *args, stash=True), 1, 2)
        stash["bound_ms"] += _bound(flops, PEAK_BF16_FLOPS, in_bytes + out_bytes + stash_bytes)[0]
        products_ms = _products_ms(torch, dev, g, SB, ns, b, D_IN_PAD, dl)
        fwd["products_ms"] += products_ms
        stash["products_ms"] += products_ms
        total_flops += flops
        bwd["ms"] += _time_ms(torch, lambda: resnetfc_bwd(z, xin, gout, spre, spost, w, *args), 1, 3)
        bwd["plain_ms"] += _time_ms(torch, lambda: resnetfc_bwd_plain(z, xin, gout, spre, spost, w, *args), 1, 2)
        grad_bytes = in_bytes - wbytes + sum(t.numel() * 4 for t in w)  # dz, dxin, f32 dW
        bwd["bound_ms"] += _bound(
            2 * flops, PEAK_BF16_FLOPS, in_bytes + out_bytes + stash_bytes + grad_bytes
        )[0]
        # the chain reads g, the stash and the weights and writes dz, dxin and
        # the cotangents; the products read the stash, z, xin and the
        # cotangents and write the f32 weight gradients
        for part, (ms, n) in _bwd_split(
            torch, lambda: resnetfc_bwd(z, xin, gout, spre, spost, w, *args)
        ).items():
            split[part][0] += ms
            split[part][1] += n
        chain_bytes += out_bytes + stash_bytes + cot_bytes + in_bytes
        wgrad_bytes += stash_bytes + in_bytes - wbytes + cot_bytes + sum(t.numel() * 4 for t in w)
        pm = _bwd_products_ms(torch, dev, g, SB, ns, b, D_IN_PAD, dl)
        products = [products[0] + pm[0], products[1] + pm[1]]
        del z, xin, gout, spre, spost
        torch.cuda.empty_cache()
    mats = sum(t.numel() * 2 for t in (w.w_in, w.wz, w.w0, w.w1))
    for name, r in (("resnetfc_fwd", fwd), ("resnetfc_fwd_stash", stash)):
        _chain_line(name, total_flops, r["ms"], r["products_ms"], ns, mats, "a train step")
    # A tile is one CTA and an SM holds one: a wave that takes as long with
    # a quarter of the SMs busy as with all of them is bound by nothing the
    # CTAs share (L2, device memory).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for ctas in (sms // 4, sms, 10 * sms):
        b = (64 // ns) * ctas
        z = rnd(1, ns, b, dl).to(torch.bfloat16)
        xin = rnd(1, ns, b, D_IN).to(torch.bfloat16)
        waves = -(-ctas // sms)
        us = [
            _device_ms(torch, lambda f=f: f(z, xin, w, *args), 20) / waves * 1e3
            for f in (resnetfc_fwd, resnetfc_fwd_stash)
        ]
        print(f"resnetfc_fwd waves: {ctas} CTAs on {sms} SMs, primal {us[0]:.1f} us a wave, stash {us[1]:.1f}")
        del z, xin
    for name, r in (("resnetfc_fwd", fwd), ("resnetfc_fwd_stash", stash), ("resnetfc_bwd", bwd)):
        print(
            f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms (operations), per train step"
        )
    bwd.update(_bwd_lines("resnetfc_bwd", "a cached or nearest train step", split, total_flops,
                          chain_bytes, wgrad_bytes, products, plans))
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
    from pixelnerf_tpu_torch.ops import field, posenc, pyramid, resnetfc, scatter

    modules = (field, posenc, pyramid, resnetfc, scatter)
    return {name: next(getattr(m, name) for m in modules if hasattr(m, name)) for name in KERNELS}


def _counted(torch, fn, expected, label):
    """Run fn with every launch count set to 0 just before and read just
    after; fail unless each kernel launched as often as `expected` says."""
    from pixelnerf_tpu_torch.ops.resnetfc import launch_bwd

    counters = _counters()
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    chain0, wgrad0 = launch_bwd.chain_launches, launch_bwd.wgrad_launches
    res = fn()
    torch.cuda.synchronize()
    got = {name: w.launches for name, w in counters.items()}
    # the backward wrappers launch the cotangent chain and the
    # weight-gradient products: one chain each
    parts = (launch_bwd.chain_launches - chain0, launch_bwd.wgrad_launches - wgrad0)
    print(f"{label}: launches {got}; backward chain {parts[0]}, wgrad {parts[1]}")
    bwd_calls = got["resnetfc_bwd"] + got["pyramid_field_fused_bwd"]
    if got != expected or parts != (bwd_calls, WGRAD_LAUNCHES * bwd_calls):
        raise AssertionError(f"{label}: launches {got}, expected {expected}")
    return res, got


def _nearest(conf):
    """srn.conf with the reference's `encoder.upsample_interp = nearest`."""
    conf = copy.deepcopy(conf)
    conf["model"]["encoder"]["upsample_interp"] = "nearest"
    return conf


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


def compare_step(torch, np, conf, rcfg, dev, dtype_name, label, fusion=False):
    """One train step on the card against the CPU plain step: the same
    parameters (seeded), injected rays, perturb=0, a small batch; with
    `fusion`, both steps run the model's fused-field view."""
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
        stepped = m.with_field_fusion() if fusion else m
        aux = make_train_step(stepped, rcfg, make_optimizer(m, 1e-4), CMP_RAYS, 0.8, 1.8)(
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
            raise AssertionError(f"{label}: card vs CPU {dtype_name} step: gradient {n} relative error {err:.3e}")
    print(
        f"{label}: card vs CPU plain {dtype_name} step ({CMP_SB}x{CMP_RAYS} rays, CPU {cpu_s:.1f} s): "
        f"loss {loss_d:.6f} vs {loss_c:.6f} (rel {rel:.2e}, tolerance {tol['loss']}); worst "
        "relative gradient errors: " + ", ".join(
            f"{part} {e:.2e} ({n}, tolerance {tol[part]})" for part, (e, n) in sorted(worst.items())
        )
    )
    if not rel <= tol["loss"]:
        raise AssertionError(f"{label}: card vs CPU {dtype_name} step: losses disagree")
    return grads_d, grads_c


def trunk_precision(torch, grads, label):
    """Fault 2, the bf16 trunk's parameter gradients: each side's bf16 step
    against the float32 step on the same side (card with card, CPU with CPU,
    the same parameters and rays), layer by layer. Rounding shows as errors
    of one size on both sides; a fault in the card's encoder backward as
    card errors beyond the CPU's."""
    (bf_d, bf_c), (f32_d, f32_c) = grads["bfloat16"], grads["float32"]
    rel = lambda a, b: ((a - b).norm() / (b.norm() + 1e-30)).item()
    worst = {"card": (0.0, ""), "CPU": (0.0, "")}
    ratio = (0.0, "")
    for n in f32_c:
        if not n.startswith("encoder.") or not f32_c[n].norm() > 0:
            continue
        card, cpu = rel(bf_d[n], f32_d[n]), rel(bf_c[n], f32_c[n])
        if not (math.isfinite(card) and math.isfinite(cpu)):
            raise AssertionError(f"{label}: non-finite trunk gradient error at {n}")
        print(f"{label} trunk bf16 vs float32 {n}: card {card:.3e} CPU {cpu:.3e}")
        if card > TRUNK_RATIO * cpu:
            raise AssertionError(
                f"{label}: the card's bf16 trunk gradient {n} is {card:.3e} from its float32 step, "
                f"more than {TRUNK_RATIO}x the CPU's {cpu:.3e}"
            )
        worst["card"] = max(worst["card"], (card, n))
        worst["CPU"] = max(worst["CPU"], (cpu, n))
        ratio = max(ratio, (card / max(cpu, 1e-30), n))
    print(
        f"{label}: trunk bf16 vs float32, worst relative gradient error: card "
        f"{worst['card'][0]:.3e} ({worst['card'][1]}), CPU {worst['CPU'][0]:.3e} "
        f"({worst['CPU'][1]}); largest card / CPU ratio {ratio[0]:.3f} ({ratio[1]})"
    )


def run_train(torch, np, dev, conf, card, label, train_expected, eval_expected,
              fusion=False, cmp_dtypes=("bfloat16",)):
    """A training path at bench.py's shapes: counted train and eval steps,
    timed steps, a profiled step, and the card step against the CPU step.
    Returns the counted runs' launches."""
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.train.step import make_eval_step, make_optimizer, make_train_step

    rcfg = RendererConfig.from_conf(conf["renderer"])
    near, far = 0.8, 1.8
    model = make_model(conf["model"], device=dev, seed=0, train=True)
    shape_heads(torch, model)
    # the fused-field view shares every parameter and the optimizer
    stepped = model.with_field_fusion() if fusion else model
    optimizer = make_optimizer(model, 1e-4)
    step = make_train_step(stepped, rcfg, optimizer, TRAIN_RAYS, near, far)
    eval_step = make_eval_step(stepped, rcfg, TRAIN_RAYS, near, far)
    batch = _train_batch(torch, np, dev, SB)
    gen = torch.Generator(device=dev).manual_seed(7)
    print(
        f"{label}: srn.conf bf16 (upsample {model.encoder.upsample_interp}, field fusion "
        f"{stepped.use_field_fusion}), {sum(p.numel() for p in model.parameters())} params, SB={SB} "
        f"NV={NV} NS={TRAIN_NS} {TRAIN_SIZE}x{TRAIN_SIZE}, {TRAIN_RAYS} rays/object, "
        f"{rcfg.n_coarse} coarse + {rcfg.n_fine} fine samples, Adam"
    )

    aux, train_launches = _counted(torch, lambda: step(batch, gen), train_expected, f"{label} step")
    if not all(torch.isfinite(v).all() for v in aux.values()):
        raise AssertionError(f"{label}: non-finite train loss {aux}")
    eaux, eval_launches = _counted(torch, lambda: eval_step(batch, gen), eval_expected, f"{label} eval step")
    if not all(torch.isfinite(v).all() for v in eaux.values()):
        raise AssertionError(f"{label}: non-finite eval loss {eaux}")

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
        raise AssertionError(f"{label}: non-finite train loss {losses}")
    print(
        f"{label}: {TIMED_STEPS} steps, {step_s * 1e3:.1f} ms/step = "
        f"{SB * TRAIN_RAYS / step_s:.1f} train rays/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, last loss {losses}, on {card}"
    )
    profile_view(torch, lambda: step(batch, gen), f"one {label} step")
    del model, stepped, optimizer, step, eval_step
    torch.cuda.empty_cache()

    grads = {
        dtype: compare_step(torch, np, conf, rcfg.replace(perturb=0.0, noise_std=0.0), dev, dtype,
                            label, fusion)
        for dtype in cmp_dtypes
    }
    if set(grads) == {"bfloat16", "float32"}:
        trunk_precision(torch, grads, label)
    return [train_launches, eval_launches]


def run_view(torch, np, dev, conf, card, label, expected):
    """One full 128x128 view of the bf16 model through `render_full`,
    counted, timed warm, profiled, and its first rays against the CPU plain
    render. Returns the counted run's launches."""
    from pixelnerf_tpu_torch.eval.common import encode_views
    from pixelnerf_tpu_torch.eval.render_utils import render_full
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.utils.rays import gen_rays

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
        f"{label}: srn.conf bf16 (upsample {model.encoder.upsample_interp}), "
        f"{sum(p.numel() for p in model.parameters())} params, "
        f"{rays.shape[0]} rays, {rcfg.n_coarse} coarse + {rcfg.n_fine - rcfg.n_fine_depth} "
        f"importance + {rcfg.n_fine_depth} depth samples, 2 source views"
    )

    def view():
        enc = encode_views(model, images, poses, focal)
        return enc, render_full(model, enc, rays, rcfg)

    t0 = time.perf_counter()
    (enc, out), launches = _counted(torch, view, expected, label)
    first_s = time.perf_counter() - t0
    for head in ("coarse", "fine"):
        for k, v in out[head].items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{label}: {head} {k} has non-finite values")
        rgb = out[head]["rgb"]
        lo, hi = rgb.min().item(), rgb.max().item()
        # sum(w * rgb) + 1 - sum(w) rounds a few float32 ulps past [0, 1]
        if rgb.shape != (size * size, 3) or lo < -RGB_SLACK or hi > 1 + RGB_SLACK:
            raise AssertionError(
                f"{label}: {head} rgb out of [0, 1] ({lo}, {hi}) or misshapen: {tuple(rgb.shape)}"
            )
    alpha = out["fine"]["alpha"]
    print(
        f"{label}: fine alpha mean {alpha.mean().item():.4f}, rgb range "
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
        f"{label}: {size}x{size} view (encode + render_full) {view_s:.3f} s warm = "
        f"{rays.shape[0] / view_s:.1f} rays/s (first call {first_s:.3f} s), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {card}"
    )
    profile_view(torch, view, f"one {label} view")

    n = CPU_RAYS
    model_cpu = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    ref = render_full(model_cpu, enc.to("cpu"), rays[:n].cpu(), rcfg)
    print(f"{label}: CPU plain render of {n} rays {time.perf_counter() - t0:.1f} s")
    for head in ("coarse", "fine"):
        d = (out[head]["rgb"][:n].cpu() - ref[head]["rgb"]).abs()
        dd = (out[head]["depth"][:n].cpu() - ref[head]["depth"]).abs()
        alpha = ref[head]["alpha"].mean().item()
        rgb_std = ref[head]["rgb"].std(dim=0).mean().item()
        print(
            f"{label}: {head} rgb vs CPU plain max {d.max().item():.3e} mean {d.mean().item():.3e} "
            f"(tolerance {RENDER_ATOL} max, {RENDER_MEAN} mean); depth max {dd.max().item():.3e}; "
            f"compared rays' alpha mean {alpha:.4f}, rgb std {rgb_std:.4f}"
        )
        if not (d.max().item() <= RENDER_ATOL and d.mean().item() <= RENDER_MEAN):
            raise AssertionError(f"{label}: {head} render disagrees with the CPU plain render")
        # an empty or saturated render would agree whatever the field did
        if not (ALPHA_RANGE[0] <= alpha <= ALPHA_RANGE[1] and rgb_std >= RGB_STD_MIN):
            raise AssertionError(f"{label}: {head}: the compared rays show too little of the field")
    return [launches]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from pixelnerf_tpu_torch.ops.cuda_build import SOURCES, build_libraries
    from pixelnerf_tpu_torch.utils import hocon

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
            # C7519: ptxas's note on each wgmma accumulator fence it adds
            if any(w in line for w in ("Used", "spill", "smem")) and "C7519" not in line:
                print(f"build: {name}: {line.strip()}")

    kernels = [check_posenc(torch, dev), check_field(torch, np, dev)]
    kernels += check_field_vjp(torch, np, dev) + check_pyramid(torch, np, dev)
    kernels += check_resnetfc(torch, np, dev) + check_bilerp(torch, np, dev)
    torch.cuda.empty_cache()

    conf = hocon.load(str(root / "conf" / "exp" / "srn.conf"))
    nearest = _nearest(conf)
    runs = run_view(torch, np, dev, conf, card, "slice", VIEW_LAUNCHES)
    runs += run_train(torch, np, dev, conf, card, "train", TRAIN_LAUNCHES, EVAL_LAUNCHES,
                      cmp_dtypes=tuple(CMP_TOL))
    runs += run_train(torch, np, dev, conf, card, "fused train", FUSED_TRAIN_LAUNCHES,
                      FUSED_EVAL_LAUNCHES, fusion=True)
    runs += run_view(torch, np, dev, nearest, card, "nearest slice", NEAREST_VIEW_LAUNCHES)
    runs += run_train(torch, np, dev, nearest, card, "nearest train", NEAREST_TRAIN_LAUNCHES,
                      NEAREST_EVAL_LAUNCHES)
    if sorted(k["name"] for k in kernels) != sorted(KERNELS):
        raise AssertionError("the kernels line must list every kernel once")
    for k in kernels:
        k["launches"] = max(r[k["name"]] for r in runs)
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
