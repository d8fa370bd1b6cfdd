#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py                  (from the repository root)
    python3 chip_smoke.py --baseline DIR   (also time the lookup kernels,
                                            posenc, the field's backward,
                                            the layered products and the
                                            train step's own code of an
                                            earlier tree of the repository)

Phases, each failing loudly (an exception and a non-zero exit):

1. require CUDA, print the card's name and power limit, turn TF32 off;
2. build the package's CUDA sources (`csrc/*.cu`), one nvcc each, at once;
3. hold each of the eleven hand-written kernels against its plain PyTorch
   version on the card at the shapes its path gives it, and time both with
   CUDA events: the field at the render's two chunk shapes (coarse, fine);
   the ResnetFC forward, forward with stash and backward at the train
   step's shapes (bench.py's: 4 objects x 1024 rays, 2 source views, 64
   coarse + 32 fine samples); every gradient of the backwards included.
   posenc, the lookups and the field's VJP run after the path that hands
   them their arguments: posenc after the counted view of phase 4 (at the
   render's two chunk shapes on random points, then on the points and
   directions the view handed it, `view_ms`, with the count of entries
   that differ from the plain version); the pyramid gather and scatter
   after phase 5, the field's stash forward and backward after phase 6 (at
   the fused train step's shapes: 64 coarse and all 96 fine samples a ray
   through the field), the bilerp gather and scatter after phase 7 (8
   composed 64x64x512 maps, 65,536 and 32,768 points a map): on random
   uv or a random grid as before, then again on the uv (and cotangents)
   that the step's counted run handed them (`step_uv_ms`), the bilerp
   gather also on the maps and uv of the counted nearest view
   (`view_uv_ms`, with its bound `view_uv_bound_ms`); each gather call with
   its unit plan and the tap-row bytes it reads, each scatter call with its
   unit plan and the reductions into device memory it makes, both counted
   from the plan and the taps. The field's backward also has its level
   scatter measured on its own, on the random grid and on the grid and
   output cotangent the counted fused step handed it: the chain kernel
   with the level scatter (1) and without levels, writing dz (2), whose
   difference is the scatter's share, and (3) 2 followed by
   `pyramid_scatter_add` of that dz, the split design, with the level
   gradients of both held to the float32 sum's bound against a float64
   scatter of the chain's own bf16 cotangent, and the reductions into
   device memory each design makes. With `--baseline`, the earlier tree's
   kernels are timed beside them on each, in turns;
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
   step's, layer by layer. With `--baseline`, the earlier tree's
   `train/step.py` (over this tree's model and renderer) builds a second
   step whose time is taken beside this tree's, in turns;
6. path A, training through the fused field: phase 5 for
   `model.with_field_fusion()` (the field's stash forward and backward in
   the train step, its primal in the eval step, no pyramid or ResnetFC
   kernel), its card step held against the CPU plain step in bf16;
7. path B, srn.conf with `encoder.upsample_interp = nearest` (set in
   code): phase 4's view (the bilerp gather and the ResnetFC forward) and
   phase 5's train step (the bilerp gather and scatter and the ResnetFC
   stash forward and backward), its card step held against the CPU plain
   step in bf16;
8. the training CLI, `pixelnerf_tpu_torch.train.train_pixelnerf.main`, as
   a user runs it: on an SRN-format dataset of simple shapes written to a
   temporary directory (24 train, 4 val and 4 test objects x 8 views, 128x128
   PNGs), srn.conf at full width in bf16 with only the train intervals
   set (print 1, eval, vis and save 2), `-B 4 -V 2 -R 1024` for 2 epochs
   with --vis_debug, then --resume to a third. Launch counts are set to 0
   before the first run and read after the second: each of the seven
   kernels of the path (posenc, the pyramid gather and scatter, the
   ResnetFC stash forward, backward and primal, the field primal) must
   have launched. The checkpoint files, `_iter.json` and the vis PNGs must
   exist, every loss be finite, and the resumed run start at the saved
   iteration with its model and Adam state equal bit for bit to the
   files. It prints the median wall time of the iterations that run no
   eval, vis or save (the batch's load, make_step_batch, the pinned copy
   and the step) and its rays/s beside phase 5's bare cached step, the
   host batch preparation's median, the image decoder that ran and the
   peak device memory;
9. the serving CLIs on the trained flagship, as a user runs them: the
   port reads `artifacts/srn600_bf16.ckpt` itself (put in a checkpoints
   dir as `pixel_nerf_latest`), conf/exp/srn600.conf at full width in bf16
   with the renderer's jitter off, on a pollen dataset written to a
   temporary directory (3 test objects x 24 views of 128x128 with
   near_far.txt): `eval_approx` (-P "0 12", 3 objects), `gen_video` (40
   views), `eval_mesh --mode both` (one object, the default 256^3 grid in
   65,536-point chunks, 22 novel views), `calc_metrics` on its renders and
   `eval_real` on one written 128x128 image (24 views), each through its
   `main(argv, device)` with the launch counts set to 0 just before and
   read just after: posenc and the field primal must launch in each
   rendering CLI and no plain version may run. Each CLI's wall time, the
   rays/s of its render_full calls, the grid's points/s, the isosurface's
   host time and peak memory are printed; 256 rays of the first view of
   eval_approx (two source views) and of eval_real (one; two image rows
   each) and the middle 65,536-point slab of the grid are held against the
   CPU plain run of the same checkpoint and inputs; PSNR and SSIM must be
   finite, the mesh non-empty and every output file written;
10. the configs off the flagship: conf/exp/dtu.conf uncut (bf16, 3
   source views) on a DTU-layout dataset written here (4 train, 1 val and
   1 test scans x 49 views of 300x400, `cameras.npz` with `world_mat_i` and
   `scale_mat_i`, `new_{train,val,test}.lst`): the training CLI with `-V 3`
   (2 epochs, then --resume to a third, bit for bit) from a seeded init
   checkpoint, then `eval_approx -P "25 22 28"` (128 rays strided across
   its first view held against the CPU plain render) and `gen_video` on
   the DTU spline; conf/exp/sn64.conf uncut (float32: no kernel may launch) on a
   64x64 NMR ShapeNet layout through the training CLI (`-V 1`) and
   `eval_approx`; then srn.conf with a global encoder (d_latent 640), with
   `num_layers = 5` (d_latent 1024, the fused field) and with `backbone =
   custom` at 64x64 (the bilerp kernels) through phase 4's view and phase
   5's train path. Each run prints its wall time, rays/s, peak memory and
   launches, and counts the kernels' plain versions (none may run). Phase
   3 also holds the ResnetFC forward, stash forward and backward at
   d_latent 640 and 1024 (hidden 512, the train step's coarse call)
   against their plain versions, timed beside d_latent 512;
11. what is left of the JAX package: (a) the sharded flagship step
   (bench.py's batch, injected rays, perturb 0) on the meshes `data:2`,
   `data:1,rays:2` and `data:2,rays:2`, in turn on subgroups of one world
   of four spawned ranks that share the card through gloo, and on a world
   of one on NCCL in this process: every rank's state after the step equal
   to rank 0's bit for bit, each rank's launches those of the one-process
   step, and rank 0's loss and gradients held (CMP_TOL's bf16 bounds) to
   the one-process step on each data index's objects averaged over the data
   axis; each rank's step time and peak memory; (b) the training CLI with
   `--mesh data:2` on two spawned ranks (srn.conf at full width, -B 4 -V 2
   -R 1024, 2 epochs then --resume), each through `_train_cli`, rank 0
   alone writing files; (c) the cached and the fused flagship steps with
   remat on and off: launches (each query twice, the primal first), step
   time and peak memory, the remat step's loss and gradients within the
   plain step's run-to-run spread; (d) `tools/profile_step` through its
   `main` at the flagship's shapes, writing its trace; (e)
   `tools/export_checkpoint` on the trained artifact: import, export (the
   artifact again, byte for byte), import, and a srn600.conf view from it
   equal to the artifact's. sn64.conf's CLI run in phase 10 rematerializes
   its float32 MLP's query (remat "auto");
12. past the chains' widths (hidden or padded d_in past 512, more than 64
   views), the layered kernels of `ops/layer_chain.py`: phase 3 records
   each launch of a stash forward and a backward at the coarse call's
   shapes (hidden 1024 with 2 views, hidden 64 with 80, hidden 512 with 2)
   and replays it as the kernel and as its plain version, timed beside
   bf16 torch.matmul of the same product (the pooling beside torch.mean)
   and, with `--baseline`, the earlier tree's four layered kernels in
   turns (`layered` lines, each product's plan: N tile, N tiles, row
   slots, grid; each pooling's event time and the card's own time, 20
   launches in one CUDA graph, read twice, the baseline's and torch.mean's
   beside them, the pooling's forward held equal to the baseline's; at
   hidden 512 also against the chain); at the end srn.conf with d_hidden 1024 runs
   phase 4's view and phase 5's cached and fused steps against the CPU
   (`wide` lines), and srn.conf renders one 128x128 view from 80 source
   views of an object written by the port's `make_synthetic_dataset`, in
   chunks of 8.8M pre-pool rows, 64 rays spread over the view held against
   the CPU plain render in rgb, depth and alpha, the card's plain route
   beside them (`80 views` lines); the tools phase also runs `trace_summary`,
   `make_synthetic_dataset` and `pose_sanity_check`;
13. a `kernels` JSON line, the card line, and the result line. A kernel's
   ms, plain_ms, bound_ms and library_ms there are sums over the shapes of
   one view (posenc, field) or of one train step (the others); its
   launches are the most that one counted run of phases 4-7 made,
   posenc's and the field primal's `serve_launches` those of each CLI of
   phase 9, `config_launches` those of each counted run of phase 10, and
   the ResnetFC records' `d_latent_640` and `d_latent_1024` phase 3's
   readings at those widths.

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
# instructions one precise sinf issues on its fast path (|x| < 105615, every
# argument here), counted in `cuobjdump -sass` of csrc/posenc.cu's kernel as
# ops/cuda_build.py builds it for sm_90a: 10 for the Cody-Waite reduction
# and its range branch, 16 for the polynomial and the quadrant's selects.
# The FP32 pipe issues one a lane and clock, half the published f32 rate
# (which counts an FMA as two operations).
SIN_INSTRUCTIONS = 26
PEAK_F32_ISSUE = PEAK_F32_FLOPS / 2

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
    "layer_fwd", "layer_bwd", "view_pool_fwd", "view_pool_bwd",
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
# A global encoder's trunk (a second ResNet-34, its gradient through the
# average pool and fc) reads up to 0.786 in bf16 against the CPU (NVIDIA
# H100 80GB HBM3, 700 W): it is held as trunk_precision holds the flagship's,
# each side's bf16 against its own float32 step, the card within
# TRUNK_RATIO of the CPU, and to 3e-2 in float32.
CMP_SB, CMP_RAYS = 2, 64
CMP_TOL = {
    "bfloat16": {"loss": 1e-2, "latent": 1e-1, "head": 5e-2, "encoder": 0.75, "global": None},
    "float32": {"loss": 1e-4, "latent": 1e-2, "head": 1e-2, "encoder": 3e-2, "global": 3e-2},
}
TRUNK_RATIO = 1.5
PROFILE_WATCH = ("pyramid_", "bilerp_")  # kernel names profile_view always prints


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


def _random_weights(torch, g, dev, d_latent, hidden=HIDDEN):
    """Random (in, out) ResnetFC weights of the flagship head (at `hidden`);
    fc_1 non-zero (a zero-initialized fc_1 would hide the block chain)."""
    from pixelnerf_tpu_torch.ops.field import FieldWeights

    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
    h = hidden
    return FieldWeights(
        w_in=rnd(D_IN, h, scale=D_IN ** -0.5), b_in=rnd(h, scale=0.1),
        wz=rnd(3, d_latent, h, scale=d_latent ** -0.5), bz=rnd(3, h, scale=0.1),
        w0=rnd(N_BLOCKS, h, h, scale=h ** -0.5), b0=rnd(N_BLOCKS, h, scale=0.1),
        w1=rnd(N_BLOCKS, h, h, scale=0.5 * h ** -0.5), b1=rnd(N_BLOCKS, h, scale=0.1),
        w_out=rnd(h, D_OUT, scale=h ** -0.5), b_out=rnd(D_OUT, scale=0.1),
    )


def check_posenc(torch, dev, view_calls=(), baseline=None):
    """posenc at the render's two chunk shapes (random points), then on the
    base points and view directions that the counted view handed it
    (`view_calls`, `view_ms`): every entry against the plain version (the
    count of entries that differ is printed), the kernel timed with CUDA
    events over back-to-back launches (with `baseline`, beside the earlier
    tree's posenc in turns)."""
    from pixelnerf_tpu_torch.ops.posenc import posenc_concat, posenc_concat_plain

    def one(label, base, vd, nf, ff, acc):
        m = base.shape[0]
        got = posenc_concat(base, vd, nf, ff)
        torch.cuda.synchronize()
        want = posenc_concat_plain(base, vd, nf, ff)
        err = (got.float() - want.float()).abs().max().item()
        differ = int((got != want).sum())
        print(f"posenc {label}: M={m} max_abs_err={err:.3e} (tolerance {POSENC_TOL:.3e}), "
              f"{differ} of {got.numel()} entries differ from the plain version")
        if not err <= POSENC_TOL:
            raise AssertionError(f"posenc kernel disagrees with its plain version: {err}")
        del got, want
        run = lambda: posenc_concat(base, vd, nf, ff)
        if baseline is None:
            ms, base_ms = _device_ms(torch, run, 100), None
        else:
            old = lambda: baseline["posenc_concat"](base, vd, nf, ff)
            b0, k0, k1, b1 = (_device_ms(torch, f, 100) for f in (old, run, run, old))
            ms, base_ms = (k0 + k1) / 2, (b0 + b1) / 2
        # bytes: base and viewdirs read, the bf16 rows written; operations:
        # the precise sines' instructions at the FP32 pipe's issue rate
        nbytes = m * (3 * 4 + 3 * 4) + m * (6 * nf + 6) * 2
        bound_ms, bound_by = _bound(m * 6 * nf * SIN_INSTRUCTIONS, PEAK_F32_ISSUE, nbytes)
        print(f"posenc {label}: kernel {ms:.4f} ms" + ("" if base_ms is None else f", baseline {base_ms:.4f} ms")
              + f", bound {bound_ms:.4f} ms ({bound_by}; bytes {nbytes / PEAK_BYTES * 1e3:.4f} ms, sines "
              f"{m * 6 * nf * SIN_INSTRUCTIONS / PEAK_F32_ISSUE * 1e3:.4f} ms)")
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        acc["differ"] = acc.get("differ", 0) + differ
        acc["ms"] += ms
        acc["base_ms"] = None if base_ms is None else (acc["base_ms"] or 0.0) + base_ms
        acc["bound_ms"] += bound_ms
        return bound_by

    g = torch.Generator(device=dev).manual_seed(1)
    res = dict(max_abs_err=0.0, ms=0.0, base_ms=None, plain_ms=0.0, bound_ms=0.0)
    for chunk, k in CHUNK_SAMPLES.items():
        m = NS * CHUNK_RAYS * k
        base = torch.randn((m, 3), generator=g, device=dev) * 0.5
        vd = torch.nn.functional.normalize(torch.randn((m, 3), generator=g, device=dev), dim=-1)
        bound_by = one(chunk, base, vd, 6, 1.5, res)
        res["plain_ms"] += _time_ms(torch, lambda: posenc_concat_plain(base, vd, 6, 1.5), 3, 20)
    view = dict(max_abs_err=0.0, ms=0.0, base_ms=None, bound_ms=0.0)
    for i, call in enumerate(view_calls):
        if call["out_dtype"] != torch.bfloat16:
            raise AssertionError(f"the view's posenc call {i} writes {call['out_dtype']}")
        one(f"view call {i}", call["base"].to(dev), call["viewdirs"].to(dev), call["num_freqs"],
            call["freq_factor"], view)
    res["max_abs_err"] = max(res["max_abs_err"], view["max_abs_err"])
    res["differ"] = res.get("differ", 0) + view.get("differ", 0)
    res.update(view_ms=view["ms"] if view_calls else None, view_base_ms=view["base_ms"],
               view_bound_ms=view["bound_ms"] if view_calls else None)
    print(
        f"posenc_concat: kernel {res['ms']:.4f} ms"
        + ("" if res["base_ms"] is None else f", baseline {res['base_ms']:.4f} ms")
        + f", plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({bound_by}), per view; on the "
        f"counted view's inputs {res['view_ms'] or 0:.4f} ms"
        + ("" if view["base_ms"] is None else f", baseline {view['base_ms']:.4f} ms")
        + f"; {res['differ']} entries differ from the plain version in all"
    )
    return dict(
        name="posenc_concat", route="cuda", source="pixelnerf_tpu_torch/csrc/posenc.cu",
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


def _sum_bound_check(torch, name, got, uv, dz, taps):
    """Level gradients (float32) against the float64 scatter of the bf16
    cotangent `dz` (B, N, sum C) through `taps`, element by element within
    the bound of a float32 sum in any order (ops/scatter_plan.py:
    scatter_reference); returns the largest error over its bound."""
    from pixelnerf_tpu_torch.ops.scatter_plan import scatter_reference

    worst, c0 = 0.0, 0
    for i, (grad, (idx, wt)) in enumerate(zip(got, taps)):
        b, h, w, c = grad.shape
        want, bound = scatter_reference(idx, wt, dz[..., c0:c0 + c], h * w)
        c0 += c
        d = (grad.double().reshape(b, h * w, c) - want).abs()
        if not bool((d <= bound).all()):
            k = int((d - bound).argmax())
            raise AssertionError(
                f"{name} level {i}: {int((d > bound).sum())} elements beyond the float32 sum's bound, "
                f"worst {d.flatten()[k].item():.3e} against {bound.flatten()[k].item():.3e}")
        worst = max(worst, (d / bound.clamp_min(1e-300)).max().item())
        del want, bound, d
    return worst


def _on_library(lib, fn):
    """fn() with ops/resnetfc.py's built `resnetfc_bwd` replaced by `lib`
    (an earlier tree's, `--baseline`)."""
    from pixelnerf_tpu_torch.ops import resnetfc

    real = resnetfc._library
    resnetfc._library = lambda name: lib if name == "resnetfc_bwd" else real(name)
    try:
        return fn()
    finally:
        resnetfc._library = real


def check_field_vjp(torch, np, dev, step_calls=(), baseline=None):
    """The field's stash forward and backward at the fused train step's two
    field calls (the coarse pass, and the fine pass's 96 samples a ray),
    against their plain versions: the output, the z-stash, and every
    gradient from the kernel's own stash. Then the backward's level scatter
    at each call on its own, on the random grid and on the grid and output
    cotangent that the counted fused train step handed the backward
    (`step_calls`): the level gradients against the float64 scatter of the
    chain's own bf16 cotangent within the float32 sum's bound, and three
    yardsticks, each the chain kernel's device time: (1) the chain with the
    level scatter, (2) the chain without levels (writing dz), (3) 2 and
    then `pyramid_scatter_add` of that dz (the split design), with the
    reductions into device memory each design makes; with `baseline`, an
    earlier tree's backward timed beside it in turns and its 1 and 2."""
    from pixelnerf_tpu_torch.ops.field import (
        FieldWeights, field_bwd_plain, field_flops, field_plain, level_scatter_plan,
        pyramid_field_fused_bwd, pyramid_field_fused_fwd_stash,
    )
    from pixelnerf_tpu_torch.ops.pyramid import _level_taps, pyramid_scatter_add
    from pixelnerf_tpu_torch.ops.resnetfc import launch_bwd, resnetfc_wgrad_plain
    from pixelnerf_tpu_torch.ops.scatter_plan import count_reductions

    g = torch.Generator(device=dev).manual_seed(9)
    ns, dl = TRAIN_NS, sum(c for _, _, c in LEVELS)
    csizes, hws = [c for *_, c in LEVELS], [(h, ww) for h, ww, _ in LEVELS]
    base_lib = None if baseline is None else baseline["resnetfc_bwd"]

    def level_scatter(label, grid, gout, xin, zs, spre, spost, acc):
        b = grid.shape[2]
        fused = lambda: launch_bwd(zs, xin, gout, spre, spost, w, *args, levels=LEVELS, grid=grid)
        nolev = lambda: launch_bwd(zs, xin, gout, spre, spost, w, *args)
        dz = nolev()[0]
        got = fused()[0]
        torch.cuda.synchronize()
        uv, dzf = grid.reshape(SB * ns, b, 2), dz.reshape(SB * ns, b, dl)
        scatter = lambda: pyramid_scatter_add(uv, dzf, csizes, hws, hws[0])
        split = scatter()
        taps = [_level_taps(uv, h, ww, *hws[0], torch.bfloat16) for h, ww in hws]
        err = _sum_bound_check(torch, f"the chain's level scatter ({label})", got, uv, dzf, taps)
        split_err = _sum_bound_check(torch, f"the split's scatter ({label})", split, uv, dzf, taps)
        lplan = level_scatter_plan(LEVELS, SB * ns, ns, b)
        red = count_reductions(lplan, LEVELS, taps)
        split_red = count_reductions(pyramid_scatter_add.plan, LEVELS, taps)
        del got, split, taps
        y = {"1": _bwd_split(torch, fused)["chain"][0], "2": _bwd_split(torch, nolev)["chain"][0]}
        # the epilogue's bound: its vector reductions' bytes (`vec` floats
        # each, 4 at the flagship's levels) at the memory rate
        y["bound"] = red["vector"] * 4 * max(sg.vec for sg in lplan.segments) / PEAK_BYTES * 1e3
        y["scatter"] = _time_ms(torch, scatter, 3, 20)
        y["3"] = y["2"] + y["scatter"]
        if base_lib is not None:
            y["base 1"] = _on_library(base_lib, lambda: _bwd_split(torch, fused)["chain"][0])
            y["base 2"] = _on_library(base_lib, lambda: _bwd_split(torch, nolev)["chain"][0])
        print(
            f"level scatter {label}: B={b}; chain with levels (1) {y['1']:.3f} ms, without (2) "
            f"{y['2']:.3f} ms, share (1 - 2) {y['1'] - y['2']:.3f} ms; split (3) = 2 + pyramid_scatter_add "
            f"{y['scatter']:.3f} ms = {y['3']:.3f} ms; the epilogue's reductions' bytes at "
            f"{PEAK_BYTES / 1e12} TB/s {y['bound']:.3f} ms"
            + ("" if base_lib is None else f"; baseline (1) {y['base 1']:.3f} (2) {y['base 2']:.3f} ms, "
               f"share {y['base 1'] - y['base 2']:.3f} ms")
            + f"; level gradients within {err:.3f} (chain) and {split_err:.3f} (split) of the float32 sum's "
            f"bound; reductions into device memory: one a channel and tap {red['scalar']}, the chain's "
            f"epilogue {red['vector']} vector, the split {split_red['vector']} vector + {split_red['flush']} "
            f"flush"
        )
        for k, v in y.items():
            acc[k] = acc.get(k, 0.0) + v
        acc["err"] = max(acc.get("err", 0.0), err, split_err)
        _add_red(acc.setdefault("red", {}), {"scalar": red["scalar"], "epilogue": red["vector"],
                                             "split": split_red["vector"] + split_red["flush"]})
        del dz, dzf
    w = _random_weights(torch, g, dev, dl)
    feats = [torch.randn((SB * ns, h, ww, c), generator=g, device=dev).to(torch.bfloat16) for h, ww, c in LEVELS]
    feat_bytes = sum(f.numel() * 2 for f in feats)
    wbytes = sum(t.numel() * 2 for t in w)  # bf16 operands
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms")
    fwd, bwd = ({k: 0.0 for k in keys} for _ in range(2))
    fwd["products_ms"], fwd_flops = 0.0, 0.0
    split = {"chain": [0.0, 0], "wgrad": [0.0, 0]}
    rnd, step = {}, {}  # the level scatter's yardsticks a step: random grid, the step's grid
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
        if base_lib is not None:
            run = lambda: pyramid_field_fused_bwd(grid, xin, gout, zs, spre, spost, w, *args, LEVELS)
            b0, k0, k1, b1 = (_time_ms(torch, f, 1, 3) for f in (
                lambda: _on_library(base_lib, run), run, run, lambda: _on_library(base_lib, run)))
            bwd["base_ms"] = (bwd.get("base_ms") or 0.0) + (b0 + b1) / 2
            print(f"pyramid_field_fused_bwd {call}: kernel {(k0 + k1) / 2:.3f} ms, baseline "
                  f"{(b0 + b1) / 2:.3f} ms (in turns)")
        level_scatter(f"random grid {call}", grid, gout, xin, zs, spre, spost, rnd)
        del grid, xin, gout, zs, spre, spost
        torch.cuda.empty_cache()
    # the grid and output cotangent of the counted fused step's field calls
    # (their backward runs the fine call first); the stash from the kernel's
    # forward on that grid
    for i, call in enumerate(step_calls):
        grid, gout = call["grid"].to(dev), call["g"].to(dev)
        b = grid.shape[2]
        xin = torch.randn((SB, ns, b, D_IN), generator=g, device=dev).to(torch.bfloat16)
        _, zs, spre, spost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *args)
        level_scatter(f"step grid call {i}", grid, gout, xin, zs, spre, spost, step)
        del grid, gout, xin, zs, spre, spost
        torch.cuda.empty_cache()
    for where, acc in (("random grid", rnd), ("the counted fused step's grid", step)):
        if not acc:
            continue
        red = acc["red"]
        print(
            f"level scatter on {where}, per fused train step: share (1 - 2) {acc['1'] - acc['2']:.3f} ms "
            f"(chain with levels {acc['1']:.3f}, without {acc['2']:.3f})"
            + ("" if base_lib is None else f", baseline share {acc['base 1'] - acc['base 2']:.3f} ms "
               f"(chain with levels {acc['base 1']:.3f}, without {acc['base 2']:.3f})")
            + f"; the split design (3) {acc['3']:.3f} ms against the chain with levels {acc['1']:.3f} "
            f"(pyramid_scatter_add {acc['scatter']:.3f}); reductions into device memory: one a channel "
            f"and tap {red['scalar']}, the chain's epilogue {red['epilogue']}, the split {red['split']}"
        )
    bwd["level_scatter"] = {
        key: {k: v for k, v in acc.items() if k != "red"} | {"reductions": acc["red"]}
        for key, acc in (("random", rnd), ("step", step)) if acc
    }
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


def _kept_calls(keep):
    """A context in which each `module.name` of `keep` ((module, name, list)
    triples, or (module, name, list, argument names) to keep only those) is
    wrapped so that each call's arguments are appended to its list, their
    tensors copied to the host (so that they add nothing to the device's
    peak memory); the wrapped function runs as before and counts its own
    launches."""
    import contextlib
    import inspect

    def wrap(real, calls, names):
        sig = inspect.signature(real)

        def keep_call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            host = lambda v: v.cpu() if hasattr(v, "cpu") else v
            calls.append({  # a sequence of levels: each level copied
                k: tuple(map(host, v)) if isinstance(v, (tuple, list)) else host(v)
                for k, v in bound.arguments.items() if names is None or k in names
            })
            return real(*args, **kwargs)

        # the wrapper counts its launches (and keeps its plan) on the function
        # its module names, which is `keep_call` while patched: share its
        # attributes
        keep_call.__dict__ = real.__dict__
        return keep_call

    @contextlib.contextmanager
    def patched():
        reals = [(module, name, getattr(module, name)) for module, name, *_ in keep]
        for (module, name, real), (_, _, calls, *names) in zip(reals, keep):
            setattr(module, name, wrap(real, calls, names[0] if names else None))
        try:
            yield
        finally:
            for module, name, real in reals:
                setattr(module, name, real)

    return patched()


BASELINE_SOURCES = ("pyramid", "bilerp", "resnetfc_bwd", "posenc", "layer_chain")


def _baseline_build(path):
    """Start building an earlier tree's kernels (`--baseline`): its
    `csrc/pyramid.cu`, `csrc/bilerp.cu`, `csrc/resnetfc_bwd.cu` and, where
    it has them, `csrc/posenc.cu` and `csrc/layer_chain.cu`, under `path`,
    one nvcc each, into build/baseline; returns the running builds and each
    source's text."""
    from pixelnerf_tpu_torch.ops.cuda_build import nvcc_command

    src = Path(path).resolve() / "pixelnerf_tpu_torch" / "csrc"
    out = Path(__file__).resolve().parent / "build" / "baseline"
    out.mkdir(parents=True, exist_ok=True)
    return {
        name: (subprocess.Popen(nvcc_command(src / f"{name}.cu", out / f"lib{name}.so"),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
               out / f"lib{name}.so", (src / f"{name}.cu").read_text())
        for name in BASELINE_SOURCES if (src / f"{name}.cu").exists()
    }


def _baseline_posenc(torch, path, builds):
    """The earlier tree's posenc_concat: its CUDA kernel through its C
    interface, or, for a tree whose posenc was a Triton kernel, its
    ops/posenc.py loaded as a module of its own."""
    import ctypes
    import importlib.util

    from pixelnerf_tpu_torch.models.code import freq_phase

    if "posenc" not in builds:
        file = Path(path).resolve() / "pixelnerf_tpu_torch" / "ops" / "posenc.py"
        spec = importlib.util.spec_from_file_location("baseline_posenc", file)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.posenc_concat
    proc, lib, _ = builds["posenc"]
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"baseline nvcc failed for posenc.cu:\n{log}")
    fn = ctypes.CDLL(str(lib)).pnt_posenc
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 2 + [
        ctypes.c_int, ctypes.c_void_p]

    def posenc_concat(base, vd, nf, ff, out_dtype=torch.bfloat16):
        freqs, phases = freq_phase(nf, ff)
        out = torch.empty((base.shape[0], 6 * nf + 6), dtype=out_dtype, device=base.device)
        err = fn(base.data_ptr(), vd.data_ptr(), out.data_ptr(), base.shape[0], nf, float(freqs[0]),
                 float(phases[1]), int(out_dtype == torch.float32),
                 torch.cuda.current_stream(base.device).cuda_stream)
        if err:
            raise RuntimeError(f"baseline posenc failed: {err}")
        return out

    return posenc_concat


def _baseline_kernels(torch, builds):
    """The earlier tree's gathers and scatters as functions of the port's
    wrappers' arguments, through its C interface: for the scatters, one f32
    atomic a channel and tap (no plan) or units planned by the port's
    ops/scatter_plan.py; for the gathers, one warp a point (no plan) or
    units planned by the port's ops/gather_plan.py. Which one, each
    source's includes say. And its backward's library (`resnetfc_bwd`),
    bound as the port binds its own."""
    import ctypes

    from pixelnerf_tpu_torch.ops import pyramid as pyr, scatter as bil
    from pixelnerf_tpu_torch.ops.gather_plan import plan_gather
    from pixelnerf_tpu_torch.ops.pyramid import _level_args
    from pixelnerf_tpu_torch.ops.scatter_plan import device_sms, plan_scatter

    from pixelnerf_tpu_torch.ops.resnetfc import bind_library

    libs, planned = {}, {}
    for name, (proc, lib, text) in builds.items():
        if name == "posenc":
            continue
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"baseline nvcc failed for {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        planned[name] = ("scatter_accum.cuh" in text, "gather_tile.cuh" in text)
    vp, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    ints = lambda xs: (ctypes.c_int * len(xs))(*xs)
    sms = lambda t: device_sms(t.device)
    stream = lambda t: torch.cuda.current_stream(t.device).cuda_stream
    pyr_sc, pyr_ga = planned["pyramid"]
    bil_sc, bil_ga = planned["bilerp"]
    fps, fbs = libs["pyramid"].pnt_pyramid_scatter, libs["bilerp"].pnt_bilerp_scatter
    fpg, fbg = libs["pyramid"].pnt_pyramid_gather, libs["bilerp"].pnt_bilerp_gather
    for f in (fps, fbs, fpg, fbg):
        f.restype = i
    head = [ctypes.POINTER(vp), ip, i]
    fps.argtypes = head + ([ip] if pyr_sc else []) + [vp] * 3 + [i] * (3 if pyr_sc else 4) + [vp]
    fbs.argtypes = ([ip] if bil_sc else []) + [vp] * 3 + [i] * 5 + [vp]
    fpg.argtypes = head + ([ip] if pyr_ga else []) + [vp] * 2 + [i] * 2 + [vp]
    fbg.argtypes = ([ip] if bil_ga else []) + [vp] * 3 + [i] * 5 + [vp]

    def check(err, what):
        if err:
            raise RuntimeError(f"baseline {what} failed: {err}")

    def pyramid_scatter(uv, dz, csizes, hws, fine_hw, dz2=None):
        b, n, csum = dz.shape
        maps = [(h, w, c) for c, (h, w) in zip(csizes, hws)]
        grads = [torch.zeros((b, h, w, c), device=uv.device) for h, w, c in maps]
        ptrs, dims, nlev = _level_args(grads, maps)
        second = 0 if dz2 is None else dz2.data_ptr()
        if pyr_sc:
            plan = plan_scatter(maps, b, n, [True] * len(maps), sms(uv), 3).as_ints()
            err = fps(ptrs, dims, nlev, ints(plan), uv.data_ptr(), dz.data_ptr(), second, b, n,
                      csum, stream(uv))
        else:
            err = fps(ptrs, dims, nlev, uv.data_ptr(), dz.data_ptr(), second, b, n, csum,
                      int(dz2 is not None), stream(uv))
        check(err, "pyramid scatter")
        return grads

    def bilerp_scatter(uv, dz, hl, wl):
        b, n, c = dz.shape
        grad = torch.zeros((b, hl, wl, c), device=uv.device)
        args = (uv.data_ptr(), dz.data_ptr(), grad.data_ptr(), b, n, hl, wl, c, stream(uv))
        plan = plan_scatter([(hl, wl, c)], b, n, [True], sms(uv), 2).as_ints()
        check(fbs(ints(plan), *args) if bil_sc else fbs(*args), "bilerp scatter")
        return grad

    def pyramid_gather(feats, uv):
        b, n, _ = uv.shape
        maps = [tuple(f.shape[1:]) for f in feats]
        out = torch.empty((b, n, sum(c for _, _, c in maps)), dtype=torch.bfloat16, device=uv.device)
        ptrs, dims, nlev = _level_args(feats, maps)
        if pyr_ga:
            plan = plan_gather(maps, b, n, sms(uv), pyr.LANES, pyr.ROWS, True).as_ints()
            err = fpg(ptrs, dims, nlev, ints(plan), uv.data_ptr(), out.data_ptr(), b, n, stream(uv))
        else:
            err = fpg(ptrs, dims, nlev, uv.data_ptr(), out.data_ptr(), b, n, stream(uv))
        check(err, "pyramid gather")
        return out

    def bilerp_gather(feat, uv):
        b, hl, wl, c = feat.shape
        n = uv.shape[1]
        out = torch.empty((b, n, c), dtype=torch.bfloat16, device=uv.device)
        args = (feat.data_ptr(), uv.data_ptr(), out.data_ptr(), b, n, hl, wl, c, stream(uv))
        plan = plan_gather([(hl, wl, c)], b, n, sms(uv), bil.LANES, bil.ROWS, True).as_ints()
        check(fbg(ints(plan), *args) if bil_ga else fbg(*args), "bilerp gather")
        return out

    out = {"pyramid_scatter_add": pyramid_scatter, "bilerp_scatter_add": bilerp_scatter,
           "pyramid_gather": pyramid_gather, "bilerp_gather": bilerp_gather,
           "resnetfc_bwd": bind_library(libs["resnetfc_bwd"], "resnetfc_bwd")}
    if "layer_chain" in libs:
        out.update(_baseline_layers(torch, libs["layer_chain"]))
    return out


def _baseline_layers(torch, lib):
    """The earlier tree's layered kernels as functions of the port's
    wrappers' arguments, through its C interface as the symbols it exports
    tell it: `pnt_layer` with 8 pointers and a workspace of its plan's
    floats for the column sums where the library exports `pnt_layer_plan`,
    else the 7 of a tree whose column sums were f32 atomics;
    `pnt_view_pool_fwd` (x, xo, y, sb, ns, b, h, stream) in every tree;
    `pnt_view_pool_bwd` with a fifth pointer, a workspace of
    `pnt_view_pool_bwd_workspace`'s floats for the column sums, where the
    library exports that, else (g, gx, y, colsum, sb, ns, b, c, ldy,
    stream) with f32 atomics."""
    import ctypes

    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.pnt_layer
    fn.restype = ci
    fn.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ci), ci, vp]
    planned = hasattr(lib, "pnt_layer_plan")
    if planned:
        lib.pnt_layer_plan.restype = ci
        lib.pnt_layer_plan.argtypes = [ctypes.POINTER(ci), ctypes.POINTER(ci)]
    ptr = lambda t: 0 if t is None else t.data_ptr()
    ld = lambda t: 0 if t is None else t.stride(0)
    stream = lambda t: torch.cuda.current_stream(t.device).cuda_stream

    def check(err, what):
        if err:
            raise RuntimeError(f"baseline {what} failed: {err}")

    def launch(wt, a, w, bias, mask, x, add, y, relu, colsum, cols):
        n = w.shape[0] if wt else w.shape[1]
        ints = (ci * 11)(a.shape[0], n, a.shape[1], ld(a), ld(w), ld(mask), ld(x), ld(y), cols or n,
                         int(add), int(relu))
        tensors = [a, w, bias, mask, x, y, colsum]
        if planned:
            plan = (ci * 6)()
            check(lib.pnt_layer_plan(ints, plan), "pnt_layer_plan")
            tensors.append(torch.empty(plan[4] if colsum is not None else 0, dtype=torch.float32,
                                       device=a.device))
        check(fn((vp * len(tensors))(*[ptr(t) for t in tensors]), ints, wt, stream(a)), "pnt_layer")

    def layer_fwd(a, w, bias, x=None, add=False, y=None, relu=True, cols=None):
        launch(0, a, w, bias, None, x, add, y, relu, None, cols)

    def layer_bwd(a, w, mask=None, x=None, add=False, y=None, colsum=None, cols=None):
        launch(1, a, w, None, mask, x, add, y, False, colsum, cols)

    pool_fwd, pool_bwd = lib.pnt_view_pool_fwd, lib.pnt_view_pool_bwd
    pool_fwd.restype = pool_bwd.restype = ci
    pool_fwd.argtypes = [vp] * 3 + [ci] * 4 + [vp]
    pool_ws = hasattr(lib, "pnt_view_pool_bwd_workspace")
    pool_bwd.argtypes = [vp] * (5 if pool_ws else 4) + [ci] * 5 + [vp]
    if pool_ws:
        lib.pnt_view_pool_bwd_workspace.restype = ctypes.c_longlong
        lib.pnt_view_pool_bwd_workspace.argtypes = [ci] * 3

    def view_pool_fwd(x, out, y=None):
        sb, ns, b, h = x.shape
        check(pool_fwd(x.data_ptr(), out.data_ptr(), ptr(y), sb, ns, b, h, stream(x)),
              "pnt_view_pool_fwd")

    def view_pool_bwd(g, ns, gx=None, y=None, colsum=None):
        sb, b, c = g.shape
        ptrs = [g.data_ptr(), ptr(gx), ptr(y), ptr(colsum)]
        if pool_ws:
            ws = torch.empty(lib.pnt_view_pool_bwd_workspace(sb, b, c) if colsum is not None else 0,
                             dtype=torch.float32, device=g.device)
            ptrs.append(ptr(ws))
        check(pool_bwd(*ptrs, sb, ns, b, c, 0 if y is None else y.shape[-1], stream(g)),
              "pnt_view_pool_bwd")

    return {"layer_fwd": layer_fwd, "layer_bwd": layer_bwd, "view_pool_fwd": view_pool_fwd,
            "view_pool_bwd": view_pool_bwd}


def _time_ab(torch, run, base):
    """The kernel's ms; with a baseline, both timed in turns (baseline,
    kernel, kernel, baseline) and each the mean of its two."""
    if base is None:
        return _time_ms(torch, run, 3, 20), None
    b0, k0, k1, b1 = (_time_ms(torch, f, 3, 20) for f in (base, run, run, base))
    return (k0 + k1) / 2, (b0 + b1) / 2


def _scatter_check(torch, name, got, want):
    """A scatter's gradients against its plain version's: each element
    within SCATTER_RTOL of its own magnitude plus SCATTER_ATOL of the map's
    largest; returns the largest absolute error."""
    err = 0.0
    for a, b in zip(got, want):
        d = (a - b).abs()
        err = max(err, d.max().item())
        if not bool((d <= SCATTER_ATOL * b.abs().max() + SCATTER_RTOL * b.abs()).all()):
            raise AssertionError(f"{name} disagrees with its plain version (max abs err {err:.3e})")
    return err


def _scatter_plan_line(name, plan, maps, red):
    """The plan of a launch and the reductions it makes, counted from the
    plan and the points' taps (ops/scatter_plan.py:count_reductions)."""
    segs = "; ".join(
        f"map {s.map} {'x'.join(map(str, maps[s.map]))}: {'shared' if s.smem else 'global'} "
        f"{s.units} units (slice {s.slice}, chunk {s.chunk}, vec {s.vec}"
        f"{f', {s.smem_bytes} B' if s.smem else ''})" for s in plan.segments
    )
    return (
        f"{name} plan: {plan.units} units, {plan.smem_bytes} B of shared memory a block; {segs}; "
        f"reductions into device memory: scalar design {red['scalar']}, now {red['vector']} vector "
        f"+ {red['flush']} flush; shared-memory atomics {red['shared']}"
    )


def _scatter_totals(name, where, acc):
    print(
        f"{name} on {where}: kernel {acc['ms']:.3f} ms"
        + (f", baseline {acc['base_ms']:.3f} ms" if acc["base_ms"] is not None else "")
        + f"; reductions into device memory {acc['red']['scalar']} scalar (one a channel and tap) -> "
        f"{acc['red']['vector']} vector + {acc['red']['flush']} flush, shared-memory atomics "
        f"{acc['red']['shared']}, per train step"
    )


def _add_red(total, red):
    for k, v in red.items():
        total[k] = total.get(k, 0) + v


def _gather_plan_line(name, plan, maps, tb):
    """The plan of a gather launch and the tap-row bytes it reads, counted
    from the plan and the points' taps (ops/gather_plan.py:count_tap_bytes)."""
    staged = [f"map {i} {'x'.join(map(str, maps[i]))}" for i, o in enumerate(plan.soff) if o >= 0]
    return (
        f"{name} plan: {plan.units} units of {plan.chunk} points, {plan.smem_bytes} B of shared "
        f"memory a block, {plan.vec} channels a lane, map 0 cached {plan.cached}, staged "
        f"{', '.join(staged) or 'none'}; {_tap_bytes(tb)}"
    )


def _tap_bytes(tb):
    return (
        f"tap-row bytes: window {tb['window']} (every K x K tap), nonzero {tb['nonzero']}, of which "
        f"{tb['shared']} from shared memory and {tb['device']} from device memory (L2) after the "
        f"fine map's register cache; {tb['staged']} staged"
    )


def _gather_totals(name, where, acc):
    leads = ", ".join(f"without the {k} {v:.3f} ms" for k, v in acc["leads"].items())
    print(
        f"{name} on {where}: kernel {acc['ms']:.3f} ms"
        + (f", baseline {acc['base_ms']:.3f} ms" if acc["base_ms"] is not None else "")
        + (f" ({leads})" if leads else "")
        + f", bound {acc['bound_ms']:.4f} ms; {_tap_bytes(acc['bytes'])}"
    )


GATHER_LEADS = ("register cache", "staging")


def _gather_lead_off(torch, name, args, lead):
    """A launch of the port's gather `name` on `args` through its own
    library, with one lead of its plan switched off: the `register cache`
    (map 0's rows loaded at every point) or `staging` (every map read from
    device memory); None where the plan does not use it. Timed only."""
    import ctypes

    from pixelnerf_tpu_torch.ops import pyramid as pyr, scatter as bil
    from pixelnerf_tpu_torch.ops.gather_plan import plan_gather, table_bytes
    from pixelnerf_tpu_torch.ops.scatter_plan import device_sms

    mod = pyr if name == "pyramid_gather" else bil
    feats, uv = (args[0], args[1]) if mod is pyr else ((args[0],), args[1])
    maps = [tuple(f.shape[1:]) for f in feats]
    b, n, _ = uv.shape
    plan = plan_gather(maps, b, n, device_sms(uv.device), mod.LANES, mod.ROWS, True)
    if lead == "register cache" and plan.cached:
        plan = plan._replace(cached=False)
    elif lead == "staging" and max(plan.soff) >= 0:
        plan = plan._replace(soff=(-1,) * len(maps), smem_bytes=table_bytes(len(maps)))
    else:
        return None
    ints = plan.as_ints()
    arr = (ctypes.c_int * len(ints))(*ints)
    out = torch.empty((b, n, sum(c for *_, c in maps)), dtype=torch.bfloat16, device=uv.device)
    stream = torch.cuda.current_stream(uv.device).cuda_stream
    if mod is pyr:
        ptrs, dims, nlev = pyr._level_args(feats, maps)
        call = lambda: mod._library().pnt_pyramid_gather(
            ptrs, dims, nlev, arr, uv.data_ptr(), out.data_ptr(), b, n, stream)
    else:
        call = lambda: mod._library().pnt_bilerp_gather(
            arr, feats[0].data_ptr(), uv.data_ptr(), out.data_ptr(), b, n, *maps[0], stream)

    def run():
        err = call()
        if err:
            raise RuntimeError(f"{name} without its {lead} failed: {err}")
        return out

    return run


def _timed_gather(torch, name, args, base, acc, label, maps, taps, bound):
    """One call of the gather `name` on `args`: held within one bf16 ulp of
    its plain version, its tap-row bytes counted, timed (with `base`, beside
    the earlier tree's, in turns), and timed with each lead of its plan
    switched off (the same result, bit for bit); adds to `acc`."""
    from pixelnerf_tpu_torch.ops import pyramid as pyr, scatter as bil
    from pixelnerf_tpu_torch.ops.gather_plan import count_tap_bytes

    mod = pyr if name == "pyramid_gather" else bil
    fn, plain = getattr(mod, name), getattr(mod, name + "_plain")
    run = lambda: fn(*args)
    got = run()
    torch.cuda.synchronize()
    want = plain(*args)
    err = _ulp_check(torch, name, got, want)
    del want
    plan = fn.plan
    tb = count_tap_bytes(plan, maps, taps)
    ms, base_ms = _time_ab(torch, run, base)
    leads = {}
    for lead in GATHER_LEADS:
        off = _gather_lead_off(torch, name, args, lead)
        if off is not None:
            if not torch.equal(off(), got):
                raise AssertionError(f"{name} without its {lead} changed its result")
            leads[lead] = _time_ms(torch, off, 3, 20)
            acc["leads"][lead] = acc["leads"].get(lead, 0.0) + leads[lead]
    shape = tuple(got.shape)
    del got
    acc["ms"] += ms
    acc["base_ms"] = None if base_ms is None else (acc["base_ms"] or 0.0) + base_ms
    acc["bound_ms"] += bound
    acc["max_abs_err"] = max(acc["max_abs_err"], err)
    _add_red(acc["bytes"], tb)
    print(
        f"{name} {label}: out {shape} max_abs_err={err:.3e} (tolerance one bf16 ulp + 1e-6), "
        f"kernel {ms:.3f} ms" + ("" if base_ms is None else f", baseline {base_ms:.3f} ms")
        + "".join(f", without the {k} {v:.3f} ms" for k, v in leads.items())
        + f", bound {bound:.4f} ms"
    )
    print(_gather_plan_line(f"{name} {label}", plan, maps, tb))
    return err


def _yardstick():
    return dict(ms=0.0, base_ms=None, bound_ms=0.0, max_abs_err=0.0, bytes={}, leads={})


def check_pyramid(torch, np, dev, step_calls=None, baseline=None):
    """The gather and the scatter at the train step's two lookups (the
    coarse one dual, the fine pass's new samples single), against their
    plain versions and against grid_sample (and its backward) on the
    pre-composed 64x64 map, which the port never calls; both again on the
    uv (and for the scatter the cotangents) that one counted train step
    passed to them (`step_calls`, each function's calls by name), the
    gather with its plan and the tap-row bytes it reads, the scatter with
    its plan and the reductions it makes; with `baseline`, an earlier
    tree's kernels timed beside them on both."""
    import torch.nn.functional as F

    from pixelnerf_tpu_torch.models.encoder import compose_pyramid
    from pixelnerf_tpu_torch.ops.pyramid import (
        _level_taps, pyramid_gather, pyramid_gather_plain, pyramid_scatter_add,
        pyramid_scatter_add_plain,
    )
    from pixelnerf_tpu_torch.ops.scatter_plan import count_reductions

    def scatter(label, uv, dz, dz2, csizes, hws, acc):
        run = lambda: pyramid_scatter_add(uv, dz, csizes, hws, hws[0], dz2=dz2)
        got = run()
        torch.cuda.synchronize()
        want = pyramid_scatter_add_plain(uv, dz, csizes, hws, hws[0], dz2=dz2)
        err = _scatter_check(torch, "pyramid_scatter_add", got, want)
        del got, want
        maps = [(h, w, c) for c, (h, w) in zip(csizes, hws)]
        taps = [_level_taps(uv, h, w, *hws[0], torch.bfloat16) for h, w, _ in maps]
        red = count_reductions(pyramid_scatter_add.plan, maps, taps)
        base = None if baseline is None else (
            lambda: baseline["pyramid_scatter_add"](uv, dz, csizes, hws, hws[0], dz2=dz2))
        ms, base_ms = _time_ab(torch, run, base)
        acc["ms"] += ms
        acc["base_ms"] = None if base_ms is None else (acc["base_ms"] or 0.0) + base_ms
        _add_red(acc["red"], red)
        print(
            f"pyramid_scatter_add {label}{' (dual)' if dz2 is not None else ''}: N={uv.shape[1]} "
            f"max_abs_err={err:.3e} (tolerance {SCATTER_RTOL}*|plain| + {SCATTER_ATOL}*max|plain|), "
            f"kernel {ms:.3f} ms" + ("" if base_ms is None else f", baseline {base_ms:.3f} ms")
        )
        print(_scatter_plan_line("pyramid_scatter_add " + label, pyramid_scatter_add.plan, maps, red))
        return err, taps

    g = torch.Generator(device=dev).manual_seed(5)
    maps = SB * TRAIN_NS
    feats = [torch.randn((maps, h, w, c), generator=g, device=dev).to(torch.bfloat16) for h, w, c in LEVELS]
    csizes = [c for _, _, c in LEVELS]
    hws = [(h, w) for h, w, _ in LEVELS]
    csum = sum(csizes)
    composed = compose_pyramid(feats).permute(0, 3, 1, 2).contiguous()  # (maps, 512, 64, 64)
    feat_bytes = sum(f.numel() * 2 for f in feats)
    def gather(label, feats, uv, acc):
        b, n, _ = uv.shape
        levels = [tuple(f.shape[1:]) for f in feats]
        taps = [_level_taps(uv, h, w, *levels[0][:2], torch.bfloat16) for h, w, _ in levels]
        nz = sum(int((w != 0).sum()) * c for (_, w), (_, _, c) in zip(taps, levels))
        nbytes = sum(f.numel() * 2 for f in feats) + uv.numel() * 4 + b * n * csum * 2
        base = None if baseline is None else (lambda: baseline["pyramid_gather"](feats, uv))
        return _timed_gather(torch, "pyramid_gather", (feats, uv), base, acc, label, levels, taps,
                             _bound(2.0 * nz, PEAK_F32_FLOPS, nbytes)[0])

    step_calls = step_calls or {}
    gat = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    sca = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    rnd = dict(ms=0.0, base_ms=None, red={})
    grnd = _yardstick()
    for pass_, k in LOOKUPS.items():
        n = TRAIN_RAYS * k
        uv = torch.rand((maps, n, 2), generator=g, device=dev) * 2.2 - 1.1
        gather(f"random uv {pass_}", feats, uv, grnd)
        grid = uv[:, None]  # (maps, 1, N, 2)
        gat["plain_ms"] += _time_ms(torch, lambda: pyramid_gather_plain(feats, uv), 1, 3)
        # grid_sample takes its grid in the map's dtype
        grid = grid.to(torch.bfloat16)
        gat["library_ms"] += _time_ms(torch, lambda: F.grid_sample(
            composed, grid, mode="bilinear", padding_mode="border", align_corners=True), 3, 20)
        out_bytes = maps * n * csum * 2

        dual = pass_ == "coarse"
        dz = (torch.randn((maps, n, csum), generator=g, device=dev) * 1e-3).to(torch.bfloat16)
        dz2 = (torch.randn((maps, n, csum), generator=g, device=dev) * 1e-3).to(torch.bfloat16) if dual else None
        err, tap_list = scatter(f"random uv {pass_}", uv, dz, dz2, csizes, hws, rnd)
        taps = sum(int((w != 0).sum()) * c for (_, w), c in zip(tap_list, csizes))
        sca["max_abs_err"] = max(sca["max_abs_err"], err)
        sca["plain_ms"] += _time_ms(torch, lambda: pyramid_scatter_add_plain(uv, dz, csizes, hws, hws[0], dz2=dz2), 1, 3)
        gout = (dz.float() + (dz2.float() if dual else 0.0)).to(torch.bfloat16).permute(0, 2, 1)[:, :, None]
        gout = gout.contiguous()  # (maps, 512, 1, N)
        sca["library_ms"] += _time_ms(torch, lambda: torch.ops.aten.grid_sampler_2d_backward(
            gout, composed, grid, 0, 1, True, [True, False]), 3, 20)
        grad_bytes = sum(m * h * w * c * 4 for m, (h, w), c in zip([maps] * 3, hws, csizes))
        sca["bound_ms"] += _bound(
            2.0 * taps, PEAK_F32_FLOPS, (2 if dual else 1) * out_bytes + uv.numel() * 4 + grad_bytes
        )[0]
        del dz, dz2, gout, tap_list
    sca["ms"] = rnd["ms"]
    gat.update(ms=grnd["ms"], bound_ms=grnd["bound_ms"], max_abs_err=grnd["max_abs_err"])
    gstep = _yardstick()
    for i, call in enumerate(step_calls.get("pyramid_gather", ())):
        gather(f"step uv call {i}", [f.to(dev) for f in call["feats"]], call["uv"].to(dev), gstep)
        gat["max_abs_err"] = max(gat["max_abs_err"], gstep["max_abs_err"])
    gat["step_uv_ms"] = gstep["ms"] if gstep["bytes"] else None
    step = dict(ms=0.0, base_ms=None, red={})
    scatter_calls = step_calls.get("pyramid_scatter_add", ())
    for i, call in enumerate(scatter_calls):
        call = {k: v.to(dev) if hasattr(v, "to") else v for k, v in call.items()}
        err, _ = scatter(f"step uv call {i}", call["uv"], call["dz"], call.get("dz2"),
                         call["csizes"], call["hws"], step)
        sca["max_abs_err"] = max(sca["max_abs_err"], err)
    sca["step_uv_ms"] = step["ms"] if scatter_calls else None
    for name, r in (("pyramid_gather", gat), ("pyramid_scatter_add", sca)):
        print(
            f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, grid_sample "
            f"{'backward ' if name.endswith('add') else ''}{r['library_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms (bytes), per train step"
        )
    _gather_totals("pyramid_gather", "random uv", grnd)
    if gstep["bytes"]:
        _gather_totals("pyramid_gather", "the counted train step's uv", gstep)
    _scatter_totals("pyramid_scatter_add", "random uv", rnd)
    if scatter_calls:
        _scatter_totals("pyramid_scatter_add", "the counted train step's uv", step)
    src, rep = "pixelnerf_tpu_torch/csrc/pyramid.cu", "pixelnerf_tpu/ops/pyramid_pallas.py"
    return [
        _record("pyramid_gather", "cuda", src, f"{rep}:227", gat, "bytes", gat.pop("library_ms")),
        _record("pyramid_scatter_add", "cuda", src, f"{rep}:282", sca, "bytes", sca.pop("library_ms")),
    ]


def check_bilerp(torch, np, dev, step_calls=None, view_calls=(), baseline=None):
    """The single-map gather and scatter at the nearest-upsampling step's
    two lookups (the coarse one, whose two consumers' cotangents autograd
    adds before the scatter, and the fine pass's new samples), against
    their plain versions and against grid_sample (and its backward) on the
    same map in NCHW, which the port never calls; both again on the uv (and
    for the scatter the cotangents) that one counted nearest train step
    passed to them (`step_calls`, each function's calls by name), the
    gather also on the maps and uv of the counted nearest view's calls
    (`view_calls`), the gather with its plan and the tap-row bytes it
    reads, the scatter with its plan and the reductions it makes; with
    `baseline`, an earlier tree's kernels timed beside them."""
    import torch.nn.functional as F

    from pixelnerf_tpu_torch.ops.scatter import (
        _taps, bilerp_gather, bilerp_gather_plain, bilerp_scatter_add, bilerp_scatter_add_plain,
    )
    from pixelnerf_tpu_torch.ops.scatter_plan import count_reductions

    def scatter(label, uv, dz, hl, wl, acc):
        run = lambda: bilerp_scatter_add(uv, dz, hl, wl)
        got = run()
        torch.cuda.synchronize()
        want = bilerp_scatter_add_plain(uv, dz, hl, wl)
        err = _scatter_check(torch, "bilerp_scatter_add", [got], [want])
        del got, want
        maps = [(hl, wl, dz.shape[2])]
        taps = _taps(uv, hl, wl)
        red = count_reductions(bilerp_scatter_add.plan, maps, [taps])
        base = None if baseline is None else (
            lambda: baseline["bilerp_scatter_add"](uv, dz, hl, wl))
        ms, base_ms = _time_ab(torch, run, base)
        acc["ms"] += ms
        acc["base_ms"] = None if base_ms is None else (acc["base_ms"] or 0.0) + base_ms
        _add_red(acc["red"], red)
        print(
            f"bilerp_scatter_add {label}: N={uv.shape[1]} max_abs_err={err:.3e} "
            f"(tolerance {SCATTER_RTOL}*|plain| + {SCATTER_ATOL}*max|plain|), kernel {ms:.3f} ms"
            + ("" if base_ms is None else f", baseline {base_ms:.3f} ms")
        )
        print(_scatter_plan_line("bilerp_scatter_add " + label, bilerp_scatter_add.plan, maps, red))
        return err, taps

    def gather(label, feat, uv, acc):
        b, h, w, c = feat.shape
        taps = _taps(uv, h, w)
        nz = int((taps[1] != 0).sum()) * c
        nbytes = feat.numel() * 2 + uv.numel() * 4 + b * uv.shape[1] * c * 2
        base = None if baseline is None else (lambda: baseline["bilerp_gather"](feat, uv))
        return _timed_gather(torch, "bilerp_gather", (feat, uv), base, acc, label, [(h, w, c)],
                             [taps], _bound(2.0 * nz, PEAK_F32_FLOPS, nbytes)[0])

    step_calls = step_calls or {}
    g = torch.Generator(device=dev).manual_seed(10)
    maps, (hl, wl, c) = SB * TRAIN_NS, COMPOSED
    feat = torch.randn((maps, hl, wl, c), generator=g, device=dev).to(torch.bfloat16)
    nchw = feat.permute(0, 3, 1, 2).contiguous()
    gat = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    sca = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    rnd = dict(ms=0.0, base_ms=None, red={})
    grnd = _yardstick()
    for pass_, k in LOOKUPS.items():
        n = TRAIN_RAYS * k
        uv = torch.rand((maps, n, 2), generator=g, device=dev) * 2.2 - 1.1
        taps = int((_taps(uv, hl, wl)[1] != 0).sum()) * c
        gather(f"random uv {pass_}", feat, uv, grnd)
        gat["plain_ms"] += _time_ms(torch, lambda: bilerp_gather_plain(feat, uv), 1, 3)
        grid = uv[:, None].to(torch.bfloat16)  # grid_sample takes the map's dtype
        gat["library_ms"] += _time_ms(torch, lambda: F.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="border", align_corners=True), 3, 20)
        out_bytes = maps * n * c * 2

        dz = (torch.randn((maps, n, c), generator=g, device=dev) * 1e-3).to(torch.bfloat16)
        err, _ = scatter(f"random uv {pass_}", uv, dz, hl, wl, rnd)
        sca["max_abs_err"] = max(sca["max_abs_err"], err)
        sca["plain_ms"] += _time_ms(torch, lambda: bilerp_scatter_add_plain(uv, dz, hl, wl), 1, 3)
        gout = dz.permute(0, 2, 1)[:, :, None].contiguous()  # (maps, C, 1, N)
        sca["library_ms"] += _time_ms(torch, lambda: torch.ops.aten.grid_sampler_2d_backward(
            gout, nchw, grid, 0, 1, True, [True, False]), 3, 20)
        sca["bound_ms"] += _bound(
            2.0 * taps, PEAK_F32_FLOPS, out_bytes + uv.numel() * 4 + feat.numel() * 4
        )[0]
        del dz, gout
    sca["ms"] = rnd["ms"]
    gat.update(ms=grnd["ms"], bound_ms=grnd["bound_ms"], max_abs_err=grnd["max_abs_err"])
    gstep, gview = _yardstick(), _yardstick()
    for acc, calls, where in ((gstep, step_calls.get("bilerp_gather", ()), "step"),
                              (gview, view_calls, "view")):
        for i, call in enumerate(calls):
            gather(f"{where} uv call {i}", call["feat"].to(dev), call["uv"].to(dev), acc)
        gat["max_abs_err"] = max(gat["max_abs_err"], acc["max_abs_err"])
    gat["step_uv_ms"] = gstep["ms"] if gstep["bytes"] else None
    gat["view_uv_ms"] = gview["ms"] if gview["bytes"] else None
    gat["view_uv_bound_ms"] = gview["bound_ms"] if gview["bytes"] else None
    step = dict(ms=0.0, base_ms=None, red={})
    scatter_calls = step_calls.get("bilerp_scatter_add", ())
    for i, call in enumerate(scatter_calls):
        call = {k: v.to(dev) if hasattr(v, "to") else v for k, v in call.items()}
        err, _ = scatter(f"step uv call {i}", call["uv"], call["dz"], call["hl"], call["wl"], step)
        sca["max_abs_err"] = max(sca["max_abs_err"], err)
    sca["step_uv_ms"] = step["ms"] if scatter_calls else None
    for name, r in (("bilerp_gather", gat), ("bilerp_scatter_add", sca)):
        print(
            f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, grid_sample "
            f"{'backward ' if name.endswith('add') else ''}{r['library_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms (bytes), per nearest train step"
        )
    _gather_totals("bilerp_gather", "random uv", grnd)
    if gstep["bytes"]:
        _gather_totals("bilerp_gather", "the counted nearest train step's uv", gstep)
    if gview["bytes"]:
        _gather_totals("bilerp_gather", "the counted nearest view's uv (one view)", gview)
    _scatter_totals("bilerp_scatter_add", "random uv", rnd)
    if scatter_calls:
        _scatter_totals("bilerp_scatter_add", "the counted nearest train step's uv", step)
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


def fit_heads(torch, model, render, label):
    """Bring a model whose latents differ in scale from the flagship's (a
    global latent, five levels, the conv encoder) to a render that shows the
    field, as `shape_heads` does for the flagship: unless the held rays
    (`render()`) already show it in both heads, move each head's sigma
    offset by bisection until their alpha mean is 0.6, then double the
    gain of its rgb rows of W_out until their rgb std is twice
    RGB_STD_MIN. The flagship's models show it as they are and keep
    `shape_heads`' weights."""

    def shows(out, head):
        alpha = out[head]["alpha"].mean().item()
        return (ALPHA_RANGE[0] <= alpha <= ALPHA_RANGE[1]
                and out[head]["rgb"].std(dim=0).mean().item() >= RGB_STD_MIN)

    with torch.no_grad():
        out = render()
        if all(shows(out, head) for head in ("coarse", "fine")):
            return
        fitted = []
        for head, mlp in (("coarse", model.mlp_coarse), ("fine", model.mlp_fine)):
            lo, hi = -64.0, 64.0
            for _ in range(16):
                mlp.lin_out.bias[3] = (lo + hi) / 2
                if render()[head]["alpha"].mean().item() > 0.6:
                    hi = (lo + hi) / 2
                else:
                    lo = (lo + hi) / 2
            gain = 1.0
            while gain < 256 and render()[head]["rgb"].std(dim=0).mean().item() < 2 * RGB_STD_MIN:
                mlp.lin_out.weight[:3] *= 2
                gain *= 2
            fitted.append(f"{head} sigma offset {mlp.lin_out.bias[3].item():.3f}, rgb gain {gain:g}")
    print(f"{label}: heads fitted to the held rays: " + "; ".join(fitted))


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
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the 14 longest, and every kernel of the port's lookups
    for i, e in enumerate(ranked):
        if i < 14 or any(w in e.key for w in PROFILE_WATCH):
            print(f"profile: {e.self_device_time_total / 1e3:10.3f} ms x{e.count:<4d} {e.key[:100]}")


def _counters():
    from pixelnerf_tpu_torch.ops import field, layer_chain, posenc, pyramid, resnetfc, scatter

    modules = (field, layer_chain, posenc, pyramid, resnetfc, scatter)
    return {name: next(getattr(m, name) for m in modules if hasattr(m, name)) for name in KERNELS}


def _counted(torch, fn, expected, label):
    """Run fn with every launch count set to 0 just before and read just
    after; fail unless each kernel launched as often as `expected` says."""
    from pixelnerf_tpu_torch.ops.layer_chain import layer_wgrad
    from pixelnerf_tpu_torch.ops.resnetfc import launch_bwd

    counters = _counters()
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    chain0, wgrad0 = launch_bwd.chain_launches, launch_bwd.wgrad_launches
    layered0 = layer_wgrad.launches
    res = fn()
    torch.cuda.synchronize()
    got = {name: w.launches for name, w in counters.items()}
    # the backward wrappers launch the cotangent chain and the
    # weight-gradient products: one chain each; the layered backward the
    # weight-gradient products too
    parts = (launch_bwd.chain_launches - chain0, launch_bwd.wgrad_launches - wgrad0)
    layered_wgrad = layer_wgrad.launches - layered0
    print(f"{label}: launches {got}; backward chain {parts[0]}, wgrad {parts[1]}, layered wgrad "
          f"{layered_wgrad}")
    bwd_calls = got["resnetfc_bwd"] + got["pyramid_field_fused_bwd"]
    if got != expected or parts != (bwd_calls, WGRAD_LAUNCHES * bwd_calls) or (
            (layered_wgrad > 0) != (got["layer_bwd"] > 0)):
        raise AssertionError(f"{label}: launches {got}, expected {expected}")
    return res, got


def _nearest(conf):
    """srn.conf with the reference's `encoder.upsample_interp = nearest`."""
    conf = copy.deepcopy(conf)
    conf["model"]["encoder"]["upsample_interp"] = "nearest"
    return conf


def _train_batch(torch, np, dev, sb, size=TRAIN_SIZE):
    """bench.py's batch: random images, identity cameras at z = 1.3."""
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.uniform(-1, 1, (sb, NV, size, size, 3)).astype(np.float32)
    ).to(dev)
    poses = torch.eye(4, device=dev).repeat(sb, NV, 1, 1)
    poses[..., 2, 3] = 1.3
    return {
        "images": images, "poses": poses,
        "focal": torch.full((sb, 2), float(size), device=dev),
        "c": torch.full((sb, 2), size / 2.0, device=dev),
        "src_images": images[:, :TRAIN_NS], "src_poses": poses[:, :TRAIN_NS],
    }


def compare_step(torch, np, conf, rcfg, dev, dtype_name, label, fusion=False, size=TRAIN_SIZE):
    """One train step on the card against the CPU plain step: the same
    parameters (seeded), injected rays, perturb=0, a small batch; with
    `fusion`, both steps run the model's fused-field view. The encoder's
    output and a global encoder's parameters count with the trunk's."""
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.train.step import make_optimizer, make_train_step, sample_rays

    tol = CMP_TOL[dtype_name]
    batch = {k: v.cpu() for k, v in _train_batch(torch, np, dev, CMP_SB, size).items()}
    rng = np.random.default_rng(8)
    pix = 2 * size * size + rng.integers(0, size * size, size=(CMP_SB, CMP_RAYS))
    batch["rays"], batch["rgb_gt"] = sample_rays(
        batch["images"], batch["poses"], batch["focal"], batch["c"], 0.8, 1.8, CMP_RAYS,
        draws={"pix": torch.from_numpy(pix)},
    )
    results = []
    for d in (dev, torch.device("cpu")):
        m = make_model(conf["model"], device=d, seed=0, train=True, dtype=getattr(torch, dtype_name))
        m.init_shapes(batch["images"])
        shape_heads(torch, m)
        latent = []

        def keep(mod, inp, out):
            for level in out[0] if isinstance(out[0], tuple) else (out[0],):
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
        part = ("latent" if n.startswith("encoder output") else "encoder" if n.startswith("encoder")
                else "global" if n.startswith("global_encoder") else "head")
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
    the same parameters and rays), layer by layer, a global encoder's trunk
    too. Rounding shows as errors of one size on both sides; a fault in the
    card's encoder backward as card errors beyond the CPU's."""
    (bf_d, bf_c), (f32_d, f32_c) = grads["bfloat16"], grads["float32"]
    rel = lambda a, b: ((a - b).norm() / (b.norm() + 1e-30)).item()
    worst = {"card": (0.0, ""), "CPU": (0.0, "")}
    ratio = (0.0, "")
    for n in f32_c:
        if not n.startswith(("encoder.", "global_encoder.")) or not f32_c[n].norm() > 0:
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
              fusion=False, cmp_dtypes=("bfloat16",), keep=(), times=None, base_step=None,
              size=TRAIN_SIZE, name="srn.conf"):
    """A training path at bench.py's shapes: counted train and eval steps,
    timed steps, a profiled step, and the card step against the CPU step.
    With `keep`, (module, function name, list) triples, the counted train
    step appends each call's arguments of each function to its list; with
    `times`, a dict, the timed steps' mean seconds go to times[label]; with
    `base_step`, an earlier tree's `make_train_step`, its step on the same
    model, batch and a fresh Adam is timed beside this tree's, in turns.
    `size` is the views' side, `name` the model's name in the output.
    Returns the counted runs' launches."""
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.train.step import make_eval_step, make_optimizer, make_train_step

    rcfg = RendererConfig.from_conf(conf["renderer"])
    near, far = 0.8, 1.8
    model = make_model(conf["model"], device=dev, seed=0, train=True)
    batch = _train_batch(torch, np, dev, SB, size)
    model.init_shapes(batch["images"])
    shape_heads(torch, model)
    # the fused-field view shares every parameter and the optimizer
    stepped = model.with_field_fusion() if fusion else model
    optimizer = make_optimizer(model, 1e-4)
    step = make_train_step(stepped, rcfg, optimizer, TRAIN_RAYS, near, far)
    eval_step = make_eval_step(stepped, rcfg, TRAIN_RAYS, near, far)
    gen = torch.Generator(device=dev).manual_seed(7)
    print(
        f"{label}: {name} bf16 (upsample {model.encoder.upsample_interp}, field fusion "
        f"{stepped.use_field_fusion}), {sum(p.numel() for p in model.parameters())} params, SB={SB} "
        f"NV={NV} NS={TRAIN_NS} {size}x{size}, {TRAIN_RAYS} rays/object, "
        f"{rcfg.n_coarse} coarse + {rcfg.n_fine} fine samples, Adam"
    )

    def counted_step():
        with _kept_calls(keep):
            return step(batch, gen)

    aux, train_launches = _counted(torch, counted_step, train_expected, f"{label} step")
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
    if times is not None:
        times[label] = step_s
    losses = {k: round(v.item(), 6) for k, v in aux.items()}
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{label}: non-finite train loss {losses}")
    print(
        f"{label}: {TIMED_STEPS} steps, {step_s * 1e3:.1f} ms/step = "
        f"{SB * TRAIN_RAYS / step_s:.1f} train rays/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, last loss {losses}, on {card}"
    )
    if base_step is not None:
        old_step = base_step(stepped, rcfg, make_optimizer(model, 1e-4), TRAIN_RAYS, near, far)
        _step_ab(torch, label, lambda: step(batch, gen), lambda: old_step(batch, gen), card)
    profile_view(torch, lambda: step(batch, gen), f"one {label} step")
    del model, stepped, optimizer, step, eval_step
    torch.cuda.empty_cache()

    grads = {
        dtype: compare_step(torch, np, conf, rcfg.replace(perturb=0.0, noise_std=0.0), dev, dtype,
                            label, fusion, size)
        for dtype in cmp_dtypes
    }
    if set(grads) == {"bfloat16", "float32"}:
        trunk_precision(torch, grads, label)
    return [train_launches, eval_launches]


def _step_ab(torch, label, new, old, card):
    """Time a train step of this tree and of an earlier one in turns
    (earlier, this, this, earlier), TIMED_STEPS each after WARMUP_STEPS,
    with a synchronise around each run of steps."""
    for fn in (old, new):
        for _ in range(WARMUP_STEPS):
            fn()
    ms = {"this tree": [], "baseline": []}
    for name, fn in (("baseline", old), ("this tree", new), ("this tree", new), ("baseline", old)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            fn()
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) / TIMED_STEPS * 1e3)
    print(
        f"{label}: train step in turns (baseline, this tree, this tree, baseline), "
        f"{TIMED_STEPS} steps each: this tree {ms['this tree'][0]:.1f} {ms['this tree'][1]:.1f} ms, "
        f"baseline's train/step.py {ms['baseline'][0]:.1f} {ms['baseline'][1]:.1f} ms; on {card}"
    )


def _baseline_step(path):
    """The earlier tree's `make_train_step`: its `train/step.py` loaded as a
    module of its own over this tree's renderer and losses."""
    import importlib.util

    file = Path(path).resolve() / "pixelnerf_tpu_torch" / "train" / "step.py"
    spec = importlib.util.spec_from_file_location("baseline_step", file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_train_step


def run_view(torch, np, dev, conf, card, label, expected, keep=(), size=VIEW_SIZE,
             name="srn.conf"):
    """One full size x size (128x128) view of the bf16 model through
    `render_full`, counted, timed warm, profiled, and its first rays
    against the CPU plain render; the counted view keeps the arguments of
    `keep`'s functions as `run_train` does. Returns the counted run's
    launches."""
    from pixelnerf_tpu_torch.eval.common import encode_views
    from pixelnerf_tpu_torch.eval.render_utils import render_full
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.utils.rays import gen_rays

    model = make_model(conf["model"], device=dev, seed=0)
    if model.dtype != torch.bfloat16:
        raise AssertionError(f"{name} should build a bf16 model")
    shape_heads(torch, model)

    rng = np.random.default_rng(4)
    focal, near, far = 131.25 * size / 128, 0.8, 1.8
    images = rng.uniform(-1, 1, size=(2, size, size, 3)).astype(np.float32)
    model.init_shapes(torch.from_numpy(images))
    poses = np.stack([_look_at(np, [1.3, 0.2, 0.1]), _look_at(np, [0.2, 0.3, 1.3])])
    target = torch.from_numpy(_look_at(np, [0.9, 0.4, 0.9])[None]).to(dev)
    rays = gen_rays(target, size, size, focal, near, far).reshape(-1, 8)
    rcfg = RendererConfig.from_conf(conf["renderer"]).replace(perturb=0.0)
    print(
        f"{label}: {name} bf16 (upsample {model.encoder.upsample_interp}), "
        f"{sum(p.numel() for p in model.parameters())} params, "
        f"{rays.shape[0]} rays, {rcfg.n_coarse} coarse + {rcfg.n_fine - rcfg.n_fine_depth} "
        f"importance + {rcfg.n_fine_depth} depth samples, 2 source views"
    )
    held = encode_views(model, images, poses, focal)
    fit_heads(torch, model, lambda: render_full(model, held, rays[:CPU_RAYS], rcfg), label)
    del held

    def view():
        enc = encode_views(model, images, poses, focal)
        return enc, render_full(model, enc, rays, rcfg)

    def counted_view():
        with _kept_calls(keep):
            return view()

    t0 = time.perf_counter()
    (enc, out), launches = _counted(torch, counted_view, expected, label)
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


# the training CLI phase: an SRN-format dataset written here (CLI_OBJECTS
# train objects and CLI_VAL_OBJECTS val and test objects, CLI_VIEWS
# 128x128 views each), srn.conf at full width with only the train intervals set, and
# bench.py's -B 4 -V 2 -R 1024 for 2 epochs, then --resume to a third
CLI_OBJECTS, CLI_VAL_OBJECTS, CLI_VIEWS = 24, 4, 8
CLI_ARGS = ["-B", str(SB), "-V", str(TRAIN_NS), "-R", str(TRAIN_RAYS)]
CLI_CONF = """include required("{srn}")
train {{
    print_interval = 1
    eval_interval = 2
    vis_interval = 2
    save_interval = 2
}}
"""
# the kernels the CLI's path launches: posenc, the pyramid gather and
# scatter, the ResnetFC stash forward and backward (train_step), the
# ResnetFC primal (eval_step, vis_debug) and the field primal (vis_step)
CLI_KERNELS = (
    "posenc_concat", "pyramid_gather", "pyramid_scatter_add", "resnetfc_fwd_stash",
    "resnetfc_bwd", "resnetfc_fwd", "pyramid_field_fused",
)


def _write_srn_dataset(np, root, name="cars", stages=None, views=CLI_VIEWS, near_far=None):
    """An SRN-format dataset of simple shapes: per object a coloured disc
    and bar on white, moving with the view, `pose/*.txt` cameras on a
    circle looking at the origin (stored flipped by diag(1, -1, -1, 1), as
    SRN stores them) and `intrinsics.txt`; with `near_far` (near, far) also
    the `near_far.txt` the pollen format reads. `stages`: (stage, objects)
    pairs, by default CLI_OBJECTS train and CLI_VAL_OBJECTS val and test."""
    from PIL import Image

    rng = np.random.default_rng(11)
    size, focal = TRAIN_SIZE, 131.25 * TRAIN_SIZE / 128
    yy, xx = np.mgrid[0:size, 0:size]
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    if stages is None:
        stages = (("train", CLI_OBJECTS), ("val", CLI_VAL_OBJECTS), ("test", CLI_VAL_OBJECTS))
    for stage, n in stages:
        for obj in range(n):
            d = Path(root) / name / f"{name}_{stage}" / f"obj{obj:03d}"
            (d / "rgb").mkdir(parents=True)
            (d / "pose").mkdir()
            (d / "intrinsics.txt").write_text(f"{focal} {size / 2} {size / 2} 0.\n0. 0. 0.\n1.\n{size} {size}\n")
            if near_far is not None:
                (d / "near_far.txt").write_text(f"{near_far[0]} {near_far[1]}\n")
            disc, bar = rng.integers(20, 230, 3), rng.integers(20, 230, 3)
            for v in range(views):
                theta = 2 * np.pi * v / views
                img = np.full((size, size, 3), 255, np.uint8)
                cx, cy = size * (0.5 + 0.15 * np.sin(theta)), size * 0.5
                img[(yy - cy) ** 2 + (xx - cx) ** 2 <= (0.25 * size) ** 2] = disc
                img[int(0.7 * size):int(0.8 * size), int(0.3 * size):int(0.7 * size)] = bar
                Image.fromarray(img).save(d / "rgb" / f"{v:06d}.png")
                eye = [1.3 * np.sin(theta), 0.3, 1.3 * np.cos(theta)]
                np.savetxt(d / "pose" / f"{v:06d}.txt", (_look_at(np, eye) @ flip).reshape(1, 16))
    return str(Path(root) / name)


def _tree_equal(torch, a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(torch, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(torch, x, y) for x, y in zip(a, b))
    return a == b


def _on_card(args) -> bool:
    """Does any tensor among `args` (nested in tuples, lists and dicts) lie
    on the card?"""
    if hasattr(args, "is_cuda"):
        return bool(args.is_cuda)
    if isinstance(args, dict):
        args = list(args.values())
    return isinstance(args, (tuple, list)) and any(_on_card(a) for a in args)


def _plain_watch():
    """(patch, counts): a context manager that counts the calls of the
    kernels' plain versions on the card's tensors (CPU references are
    theirs to run), and the counts."""
    import contextlib
    import importlib

    counts = {name: 0 for names in PLAIN_VERSIONS.values() for name in names}

    @contextlib.contextmanager
    def watching():
        reals = []
        for mod_name, names in PLAIN_VERSIONS.items():
            mod = importlib.import_module(f"pixelnerf_tpu_torch.ops.{mod_name}")
            for name in names:
                real = getattr(mod, name)

                def fn(*a, _real=real, _name=name, **k):
                    counts[_name] += _on_card((a, k))
                    return _real(*a, **k)

                reals.append((mod, name, real))
                setattr(mod, name, fn)
        try:
            yield
        finally:
            for mod, name, real in reals:
                setattr(mod, name, real)

    return watching, counts


def _train_cli(torch, dev, label, argv, card, runs=None, profile=False):
    """`train_pixelnerf.main` as a user runs it: `runs`, (label, extra
    flags) pairs, by default 2 epochs then --resume to a third. Every
    launch count is set to 0 before the first run and read after the
    last, and the plain versions are counted (none may run on the card).
    The resumed run must start from the saved files (the iteration, and the
    model and Adam state bit for bit) and every loss must be finite. Each
    step (a synchronise around it, the host's batch preparation taken
    out), that preparation and each iteration (from the previous one's
    end) are timed; with `profile`, one more warm step of the first run is
    profiled. Returns a dict of the launches, the backward wrappers' chain
    and wgrad launches, the iterations' (batch, end time) ticks, the step
    and host seconds, the wall time, the peak memory and the losses."""
    import contextlib
    import io
    import statistics

    from pixelnerf_tpu_torch.ops.resnetfc import launch_bwd
    from pixelnerf_tpu_torch.train import train_pixelnerf as cli
    from pixelnerf_tpu_torch.train.trainer import Trainer
    from pixelnerf_tpu_torch.utils import checkpoint as ckpt

    if runs is None:
        runs = (("2 epochs", ["--epochs", "2"]), ("--resume to a third", ["--epochs", "3", "--resume"]))
    orig_start, orig_post = Trainer.start, Trainer.post_batch
    out = {"ticks": [], "losses": [], "step_s": [], "host_s": [], "resumed": {}}
    rays = []

    def start(self):
        if self.args.resume:
            cdir = Path(self.args.checkpoints_path) / self.args.name
            meta = json.loads((cdir / "_iter.json").read_text())
            out["resumed"] = {
                "iter": (self.start_iter_id, meta["iter"]),
                "model": _tree_equal(torch, self.model.state_dict(),
                                     ckpt.load_state(str(cdir / "pixel_nerf_latest"), dev)),
                "optimizer": _tree_equal(torch, self.optimizer.state_dict(),
                                         ckpt.load_state(str(cdir / "_optim"), dev)),
            }
        train_step, eval_step, device_batch = self.train_step, self.eval_step, self._device_batch
        rays.append(self.args.batch_size * self.args.ray_batch_size)

        def timed_step(data, global_step):
            torch.cuda.synchronize()
            n, t0 = len(out["host_s"]), time.perf_counter()
            aux = train_step(data, global_step)
            torch.cuda.synchronize()
            # the call prepares the batch on the host (timed_batch), then steps
            out["step_s"].append(time.perf_counter() - t0 - sum(out["host_s"][n:]))
            out["losses"].append(aux)
            if profile and len(out["step_s"]) == 2:  # one more, warm step on this batch
                with contextlib.redirect_stdout(sys.__stdout__):
                    profile_view(torch, lambda: train_step(data, global_step), f"one {label} step")
            return aux

        def timed_batch(data, global_step, train=True):
            t0 = time.perf_counter()
            res = device_batch(data, global_step, train=train)
            if train:
                out["host_s"].append(time.perf_counter() - t0)
            return res

        self.train_step, self._device_batch = timed_step, timed_batch
        self.eval_step = lambda data, global_step: out["losses"].append(
            eval_step(data, global_step)) or out["losses"][-1]
        torch.cuda.synchronize()
        out["ticks"].append((None, time.perf_counter()))
        orig_start(self)

    def post_batch(self, epoch, batch):
        torch.cuda.synchronize()
        out["ticks"].append((batch, time.perf_counter()))
        orig_post(self, epoch, batch)

    counters = _counters()
    watching, plain = _plain_watch()
    Trainer.start, Trainer.post_batch = start, post_batch
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    chain0, wgrad0 = launch_bwd.chain_launches, launch_bwd.wgrad_launches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with watching():
            for run, extra in runs:
                log = io.StringIO()
                try:
                    with contextlib.redirect_stdout(log):
                        cli.main(argv + extra, device=dev)
                finally:
                    tail = log.getvalue().strip().splitlines()
                    print(f"{label} ({run}): {len(tail)} lines of output, the last: " + " | ".join(tail[-3:]))
    finally:
        Trainer.start, Trainer.post_batch = orig_start, orig_post
    torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    out["launches"] = {name: counters[name].launches for name in KERNELS}
    out["parts"] = (launch_bwd.chain_launches - chain0, launch_bwd.wgrad_launches - wgrad0)
    out["peak"] = torch.cuda.max_memory_allocated()
    print(f"{label}: launches over the runs {out['launches']}; backward chain {out['parts'][0]}, "
          f"wgrad {out['parts'][1]}; plain versions {plain}")
    if any(plain.values()):
        raise AssertionError(f"{label}: a plain version ran on the card: {plain}")
    values = [float(v) for aux in out["losses"] for v in aux.values()]
    if not values or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{label}: non-finite losses {values}")
    resumed = out["resumed"]
    start_iter, saved_iter = resumed.get("iter", (None, None))
    if start_iter is None or start_iter != saved_iter or not (resumed["model"] and resumed["optimizer"]):
        raise AssertionError(f"{label}: the resumed run does not start from the saved state: {resumed}")
    own = out["step_s"][1:]  # the first run's first step warms up
    med = statistics.median(own)
    print(
        f"{label}: {len(out['step_s'])} train steps in {out['wall']:.1f} s over the runs (the loader, "
        f"eval, vis and saves included) = {out['wall'] / len(out['step_s']):.2f} s a step; the step "
        f"itself median {med * 1e3:.1f} ms over {len(own)} = {rays[0] / med:.1f} rays/s; the host's "
        f"batch preparation (make_step_batch and the copy) median "
        f"{statistics.median(out['host_s']) * 1e3:.1f} ms; resumed at iter {start_iter} with model "
        f"and Adam state bit-equal to the files; peak device memory {out['peak'] / 2**30:.2f} GiB; "
        f"on {card}"
    )
    return out


def _eval_cli(torch, dev, label, main, argv, card, patches=()):
    """One eval CLI through `main(argv, device)`: its launches counted
    from 0, its plain versions counted (none may run on the card), its
    render_full calls timed, with `patches`, (module, name, function)
    triples, in place while it runs. Returns (result, launches, the first
    render's (args, kwargs, output) or None)."""
    import contextlib
    import io

    from pixelnerf_tpu_torch.eval import render_utils

    counters = _counters()
    watching, plain = _plain_watch()
    real = render_utils.render_full
    renders, first = [], []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        rays = a[2] if len(a) > 2 else k["rays"]
        renders.append((time.perf_counter() - t0, rays.reshape(-1, 8).shape[0]))
        if not first:
            first.append((a, k, out))
        return out

    patches = [(render_utils, "render_full", timed), *patches]
    reals = [(m, n, getattr(m, n)) for m, n, _ in patches]
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    for m, n, f in patches:
        setattr(m, n, f)
    t0 = time.perf_counter()
    try:
        with watching(), contextlib.redirect_stdout(log):
            res = main(argv, device=dev)
        torch.cuda.synchronize()
    finally:
        for m, n, f in reals:
            setattr(m, n, f)
        tail = log.getvalue().strip().splitlines()
        print(f"{label}: {len(tail)} lines of output, the last: " + " | ".join(tail[-2:]))
    wall = time.perf_counter() - t0
    got = {name: counters[name].launches for name in KERNELS}
    secs, rays = sum(r[0] for r in renders), sum(r[1] for r in renders)
    print(
        f"{label}: wall {wall:.2f} s; {len(renders)} render_full calls, {rays} rays in {secs:.3f} s"
        + (f" = {rays / secs:.1f} rays/s" if secs else "")
        + f"; launches {got}; plain versions {plain}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}"
    )
    if any(plain.values()):
        raise AssertionError(f"{label}: a plain version ran on the card: {plain}")
    return res, got, (first[0] if first else None)


def _held_render(torch, label, model_cpu, first, idx, alpha_range):
    """The card's first render against the CPU plain render of the same
    rays (`idx` of them) on the same checkpoint and encoding; returns the
    CPU render."""
    from pixelnerf_tpu_torch.eval.render_utils import render_full

    args, kw, out = first
    enc, rays, rcfg = args[1], args[2].reshape(-1, 8), args[3]
    t0 = time.perf_counter()
    ref = render_full(model_cpu, enc.to("cpu"), rays[idx.to(rays.device)].cpu(), rcfg, seed=kw.get("seed", 0))
    print(f"{label}: CPU plain render of {len(idx)} rays ({enc.num_views} source views) "
          f"{time.perf_counter() - t0:.1f} s")
    for head in ("coarse", "fine"):
        d = (out[head]["rgb"][idx.to(out[head]["rgb"].device)].cpu() - ref[head]["rgb"]).abs()
        alpha = ref[head]["alpha"].mean().item()
        rgb_std = ref[head]["rgb"].std(dim=0).mean().item()
        print(f"{label}: {head} rgb vs CPU plain max {d.max().item():.3e} mean {d.mean().item():.3e} "
              f"(tolerance {RENDER_ATOL} max, {RENDER_MEAN} mean); compared rays' alpha mean "
              f"{alpha:.4f}, rgb std {rgb_std:.4f}")
        if not (d.max().item() <= RENDER_ATOL and d.mean().item() <= RENDER_MEAN):
            raise AssertionError(f"{label}: {head} render disagrees with the CPU plain render")
        if not (alpha_range[0] <= alpha <= alpha_range[1] and rgb_std >= RGB_STD_MIN):
            raise AssertionError(f"{label}: {head}: the compared rays show too little of the field")
    return ref


def run_cli(torch, np, dev, root, card, bare_step_s):
    """`train_pixelnerf.main` on the card as a user runs it (`_train_cli`:
    2 epochs with --vis_debug, then --resume to a third); the files it
    writes are checked, and the wall time of each iteration that runs no
    eval, vis or save is set beside the bare step's."""
    import statistics
    import tempfile

    from pixelnerf_tpu_torch.native import imagecodec

    with tempfile.TemporaryDirectory() as tmp:
        datadir = _write_srn_dataset(np, tmp)
        conf = Path(tmp) / "cli.conf"
        conf.write_text(CLI_CONF.format(srn=root / "conf" / "exp" / "srn.conf"))
        argv = ["-c", str(conf), "-D", datadir, "-n", "cli", "--logs_path", f"{tmp}/logs",
                "--checkpoints_path", f"{tmp}/ckpt", "--visual_path", f"{tmp}/vis"] + CLI_ARGS
        res = _train_cli(torch, dev, "cli", argv, card,
                         runs=(("2 epochs", ["--epochs", "2", "--vis_debug"]),
                               ("--resume to a third", ["--epochs", "3", "--resume"])))
        cdir, vdir = Path(tmp) / "ckpt" / "cli", Path(tmp) / "vis" / "cli"
        files = sorted(p.name for p in cdir.iterdir())
        vis = sorted(p.name for p in vdir.glob("*_vis.png"))
        debug = sorted(p.name for p in (vdir / "vis_debug").glob("*_sigma_z0.png"))
        meta = json.loads((cdir / "_iter.json").read_text())
    got, ticks = res["launches"], res["ticks"]
    missing = [name for name in CLI_KERNELS if got[name] <= 0]
    if missing or res["parts"][0] <= 0:
        raise AssertionError(f"cli: the training CLI never launched {missing or ['the backward chain']}")
    for name in ("pixel_nerf_latest", "pixel_nerf_backup", "_optim", "_iter.json", "_renderer.json"):
        if name not in files:
            raise AssertionError(f"cli: checkpoint file {name} missing ({files})")
    if not vis or not debug:
        raise AssertionError(f"cli: vis PNGs missing ({vis}, {debug})")
    # iterations that ran no eval, vis or save (odd batches with the
    # intervals of 2), timed from the previous iteration's end
    steps = [t1 - t0 for (_, t0), (b, t1) in zip(ticks, ticks[1:]) if b is not None and b % 2 == 1]
    med = statistics.median(steps)
    print(
        f"cli: srn.conf bf16 at full width, {CLI_OBJECTS} objects x {CLI_VIEWS} views of "
        f"{TRAIN_SIZE}x{TRAIN_SIZE}, {' '.join(CLI_ARGS)}, {len(ticks) - 2} iterations in "
        f"{res['wall']:.1f} s (2 runs, eval, vis and saves included); resumed at iter "
        f"{res['resumed']['iter'][0]} with model and Adam state bit-equal to the checkpoint; last "
        f"iter {meta['iter']}, {len(vis)} vis PNGs, {len(res['losses'])} finite loss sets"
    )
    print(
        f"cli: train step wall time (an iteration without eval/vis/save, the batch's load, "
        f"make_step_batch, pinned copy and step) median {med * 1e3:.1f} ms over {len(steps)} "
        f"= {SB * TRAIN_RAYS / med:.1f} rays/s; the bare cached step of the train phase "
        f"{bare_step_s * 1e3:.1f} ms = {SB * TRAIN_RAYS / bare_step_s:.1f} rays/s; difference "
        f"{(med - bare_step_s) * 1e3:.1f} ms; host make_step_batch + copy median "
        f"{statistics.median(res['host_s']) * 1e3:.2f} ms; on {card}"
    )
    print(f"cli: image decoder {imagecodec.decoder()}; peak device memory {res['peak'] / 2**30:.2f} GiB")
    return got


# the serving CLIs phase: the trained flagship (artifacts/srn600_bf16.ckpt,
# read by the port's own reader) on conf/exp/srn600.conf at full width,
# with the renderer's jitter off (perturb 0) so that the card and the CPU
# draw the same samples; a pollen dataset of SERVE_OBJECTS test objects x
# SERVE_VIEWS 128x128 views with near_far.txt written here
SERVE_OBJECTS, SERVE_VIEWS, SERVE_SOURCE = 3, 24, "0 12"
SERVE_CONF = """include required("{srn600}")
renderer {{
    perturb = 0.0
}}
"""
SERVE_KERNELS = ("posenc_concat", "pyramid_field_fused")
GRID_RESO, GRID_CHUNK, VIDEO_VIEWS, REAL_VIEWS = 256, 65536, 40, 24
# sigma of the card's grid against the CPU plain query of the same points,
# as fractions of the largest sigma of the compared points: bf16 operands
# on both sides, float32 sums in other orders, an unbounded relu output.
# Set from a reading on the trained flagship (H100 80GB HBM3, 700 W): max
# 2.086e-2 and mean 7.725e-5 with a largest sigma of 14.72, i.e. 1.4e-3
# and 5.2e-6 of it; the limits give the max 7x and the mean 10x that (a
# wrong tap or row is off by O(1) of the sigma it touches)
SIGMA_RTOL_MAX, SIGMA_RTOL_MEAN = 1e-2, 5e-5
# the CLIs whose first render_full is held against the CPU plain render:
# eval_approx's (two source views) and eval_real's (one view, 393,216 rays
# in 16,384-ray chunks), two image rows of the first view each (the middle
# one crosses the object, the one at 3/4 the object or the background)
SERVE_HELD = ("eval_approx", "eval_real")


def run_serving_clis(torch, np, dev, root, card):
    """The eval CLIs through their `main(argv, device)` on the trained
    flagship (`_eval_cli`: launch counts from 0, plain versions counted,
    none may run): eval_approx, gen_video, eval_mesh --mode both (the
    default 256^3 grid), calc_metrics on its renders and eval_real on one
    written image. The first render of eval_approx and of eval_real (256
    rays on two image rows of the first view each) and the middle slab of
    eval_mesh's grid (65,536 points) are held against the CPU plain run of
    the same checkpoint and inputs. Returns each CLI's launches."""
    import tempfile

    from pixelnerf_tpu_torch.eval import calc_metrics, eval_approx, eval_mesh, eval_real, gen_video
    from pixelnerf_tpu_torch.eval import common
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.native import isosurface
    from pixelnerf_tpu_torch.utils import checkpoint as ckpt
    from pixelnerf_tpu_torch.utils import hocon, recon
    from pixelnerf_tpu_torch.utils.visualize import write_png

    # each grid's (seconds, volume); the isosurface's seconds; the
    # encodings `encode_views` gave
    seen = {"grids": [], "iso_s": [], "encodings": []}
    real_grid, real_iso, real_encode = recon.eval_sigma_grid, isosurface.load_isosurface, common.encode_views

    def timed_grid(query_sigma, reso, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vol = real_grid(query_sigma, reso, *a, **k)
        seen["grids"].append((time.perf_counter() - t0, vol))
        return vol

    def timed_iso():
        extract = real_iso()

        def run(vol, iso):
            t0 = time.perf_counter()
            res = extract(vol, iso)
            seen["iso_s"].append(time.perf_counter() - t0)
            return res

        return run

    def kept_encode(*a, **k):
        enc = real_encode(*a, **k)
        seen["encodings"].append(enc)
        return enc

    patches = [(recon, "eval_sigma_grid", timed_grid), (isosurface, "load_isosurface", timed_iso),
               (common, "encode_views", kept_encode)]

    results, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        datadir = _write_srn_dataset(np, tmp, "shapes", stages=(("test", SERVE_OBJECTS),),
                                     views=SERVE_VIEWS, near_far=(0.8, 1.8))
        cdir = Path(tmp) / "ckpt" / "srn600"
        cdir.mkdir(parents=True)
        (cdir / "pixel_nerf_latest").write_bytes((root / "artifacts" / "srn600_bf16.ckpt").read_bytes())
        conf_path = Path(tmp) / "srn600_serve.conf"
        conf_path.write_text(SERVE_CONF.format(srn600=root / "conf" / "exp" / "srn600.conf"))
        base = ["-n", "srn600", "-c", str(conf_path), "-D", datadir, "--checkpoints_path",
                f"{tmp}/ckpt", "--visual_path", f"{tmp}/vis", "--image_size", str(TRAIN_SIZE),
                str(TRAIN_SIZE)]
        out_root = Path(tmp) / "eval_out"
        inp = Path(tmp) / "real_in"
        inp.mkdir()
        first_view = Path(datadir) / "shapes_test" / "obj000" / "rgb" / "000000.png"
        from PIL import Image

        write_png(str(inp / "shape_normalize.png"), np.asarray(Image.open(first_view))[..., :3])
        runs = [
            ("eval_approx", eval_approx.main,
             base + ["--split", "test", "-P", SERVE_SOURCE, "--limit", str(SERVE_OBJECTS),
                     "--seed", "1234"]),
            ("gen_video", gen_video.main,
             base + ["--split", "test", "-S", "0", "-P", SERVE_SOURCE, "--num_views",
                     str(VIDEO_VIEWS)]),
            ("eval_mesh", eval_mesh.main,
             base + ["--split", "test", "-P", SERVE_SOURCE, "--mode", "both", "--limit", "1",
                     "--mesh_reso", str(GRID_RESO), "--mesh_chunk", str(GRID_CHUNK),
                     "--output", str(out_root)]),
            ("calc_metrics", calc_metrics.main,
             ["-D", str(Path(datadir) / "shapes_test"), "-O", str(out_root / "srn600"), "-F", "srn",
              "-P", SERVE_SOURCE]),
            ("eval_real", eval_real.main,
             base + ["-I", str(inp), "-O", f"{tmp}/real_out", "--size", str(TRAIN_SIZE),
                     "--out_size", str(VIEW_SIZE), "--num_views", str(REAL_VIEWS)]),
        ]
        encodings, firsts = {}, {}
        for name, main, argv in runs:
            n_grids, n_enc = len(seen["grids"]), len(seen["encodings"])
            results[name], launches[name], firsts[name] = _eval_cli(
                torch, dev, f"serve {name}", main, argv, card, patches)
            encodings[name] = seen["encodings"][n_enc:]
            for g_s, vol in seen["grids"][n_grids:]:
                print(f"serve {name}: sigma grid {vol.shape} ({vol.size} points) in {g_s:.3f} s = "
                      f"{vol.size / g_s:.1f} points/s; isosurface on the host "
                      f"{seen['iso_s'][-1]:.3f} s")
            if name != "calc_metrics" and not all(launches[name][k] > 0 for k in SERVE_KERNELS):
                raise AssertionError(f"serve {name}: the kernels did not launch: {launches[name]}")

        # what each CLI wrote
        vis = Path(tmp) / "vis" / "srn600"
        obj_out = out_root / "srn600"
        mesh = obj_out / "obj000.stl"
        wanted = [vis / "video_test0000_view.jpg", obj_out / "finish.txt", mesh,
                  obj_out / "obj000" / "metrics.txt", obj_out / "all_metrics.txt"]
        wanted += [obj_out / "obj000" / f"{v:06d}.png" for v in range(SERVE_VIEWS)
                   if v not in map(int, SERVE_SOURCE.split())]
        wanted += [Path(tmp) / "real_out" / "shape_normalize_frames" / f"{k:04d}.png"
                   for k in range(REAL_VIEWS)]
        missing = [str(p.relative_to(tmp)) for p in wanted if not p.exists()]
        videos = [p.name for p in [*vis.glob("video_test0000.*"), *(Path(tmp) / "real_out").glob("*_vid.*")]]
        if missing or len(videos) != 2:
            raise AssertionError(f"serve: output files missing: {missing}, videos {videos}")
        mesh_bytes = mesh.stat().st_size

    psnr, ssim = results["eval_approx"]
    _, frames = results["gen_video"]
    (obj, mres), = results["eval_mesh"].items()
    total = results["calc_metrics"]["total"]
    print(
        f"serve: eval_approx psnr {psnr:.4f} ssim {ssim:.4f} over {SERVE_OBJECTS} objects; "
        f"eval_mesh {obj}: {mres['n_verts']} verts {mres['n_tris']} tris ({mesh_bytes} bytes of STL), "
        f"nvs psnr {mres['psnr']:.4f} ssim {mres['ssim']:.4f}; calc_metrics total psnr "
        f"{total['psnr']:.4f} ssim {total['ssim']:.4f} lpips {total['lpips']} n {total['n']}; "
        f"videos {videos}"
    )
    finite = [psnr, ssim, mres["psnr"], mres["ssim"], total["psnr"], total["ssim"]]
    if not all(math.isfinite(v) for v in finite) or mres["n_tris"] <= 0 or frames.std() <= 0:
        raise AssertionError(f"serve: metrics {finite}, mesh {mres}, frames std {frames.std()}")
    (real_frames,) = results["eval_real"].values()
    if real_frames.shape != (REAL_VIEWS, VIEW_SIZE, VIEW_SIZE, 3):
        raise AssertionError(f"serve: eval_real frames {real_frames.shape}")

    # the card against the CPU plain run of the same checkpoint and inputs
    conf = hocon.load(str(root / "conf" / "exp" / "srn600.conf"))
    model_cpu = make_model(conf["model"], device="cpu")
    ckpt.load_weights_file(model_cpu, str(root / "artifacts" / "srn600_bf16.ckpt"))
    # two image rows (CPU_RAYS rays) of each held CLI's first view
    rows = (VIEW_SIZE // 2, 3 * VIEW_SIZE // 4)
    idx = torch.tensor([r * VIEW_SIZE + c for r in rows for c in range(VIEW_SIZE)][:CPU_RAYS])
    for name in SERVE_HELD:
        _held_render(torch, f"serve {name} (rows {rows})", model_cpu, firsts[name], idx, ALPHA_RANGE)
    # eval_mesh's grid: the middle x slab, GRID_CHUNK points, the chunk the
    # card's query gave, against the CPU plain query (zero view directions)
    _, vol = seen["grids"][0]
    (enc_mesh,) = encodings["eval_mesh"]
    axis = np.linspace(-1.0, 1.0, GRID_RESO, dtype=np.float32)
    mid = GRID_RESO // 2
    yz = np.stack(np.meshgrid(axis, axis, indexing="ij"), -1).reshape(-1, 2)
    pts = torch.from_numpy(np.concatenate([np.full((len(yz), 1), axis[mid], np.float32), yz], 1))
    t0 = time.perf_counter()
    with torch.inference_mode():
        sig = model_cpu.with_field_fusion().query(
            enc_mesh.to("cpu"), pts[None], torch.zeros_like(pts)[None], True)[0, :, 3].numpy()
    got = vol[mid].reshape(-1)
    d = np.abs(got - sig)
    scale = float(np.abs(sig).max())
    print(f"serve: sigma grid slab x={axis[mid]:.4f} ({len(sig)} points) vs CPU plain query "
          f"({time.perf_counter() - t0:.1f} s): max {d.max():.3e} mean {d.mean():.3e}, largest "
          f"sigma {scale:.3e} (tolerance {SIGMA_RTOL_MAX} max, {SIGMA_RTOL_MEAN} mean of it = "
          f"{SIGMA_RTOL_MAX * scale:.3e}, {SIGMA_RTOL_MEAN * scale:.3e}), mean |sigma| "
          f"{float(np.abs(sig).mean()):.3e}, {int((sig > 10.0).sum())} points above the mesh "
          "threshold")
    if not (scale > 0 and d.max() <= SIGMA_RTOL_MAX * scale and d.mean() <= SIGMA_RTOL_MEAN * scale):
        raise AssertionError("serve: the sigma grid disagrees with the CPU plain query")
    return launches


# the configs phase: conf/exp/dtu.conf and sn64.conf uncut through the
# training and serving CLIs on datasets written here, then three bf16
# models off the flagship (a global encoder, five encoder levels, the
# custom conv encoder) through a counted view and train steps
DTU_SCANS = (("train", 4), ("val", 1), ("test", 1))
DTU_VIEWS, DTU_H, DTU_W, DTU_FOCAL = 49, 300, 400, 723.0  # rs_dtu_4: DTU at 1/4 size
DTU_SOURCE = "25 22 28"  # the pixelNeRF paper's DTU source views
DTU_ARGS = ["-V", "3"]  # with the CLI's -B 4 -R 128
DTU_VIDEO_VIEWS = 5  # gen_video's DTU spline: a frame a key interval, 6 frames
DTU_HELD_RAYS = 128  # rays of eval_approx's first view on the CPU, strided over the view
# shape_heads' sigma offset of 2 makes DTU's long 0.1-5.0 depth range
# opaque at its first samples; 0 leaves the held rays partly transparent
# (a CPU reading at full width: alpha 0.83 coarse, 0.29 fine), and a gain
# on the rgb rows of W_out spreads the colours (fine rgb std 0.0089 over
# the view's middle row without it on an NVIDIA H100 80GB HBM3 at 700 W)
DTU_SIGMA_BIAS, DTU_RGB_GAIN = 0.0, 4.0
SN64_OBJECTS, SN64_VIEWS, SN64_SIZE = (("train", 8), ("val", 2), ("test", 2)), 24, 64
SN64_ARGS = ["-V", "1"]
# the train intervals (and DTU's 32 epoch repeats cut to 1: a DTU batch
# takes its loader ~7 s, the colour jitter of 4 scans x 49 views on the
# host, 1.64 s a scan on the H100 machine's), and the renderer's jitter off for the
# eval CLIs, over the shipped conf
CONFIG_TRAIN_CONF = """include required("{conf}")
train {{
    print_interval = 1
    eval_interval = 2
    vis_interval = 1000
    save_interval = 1
    num_epoch_repeats = 1
}}
"""
CONFIG_SERVE_CONF = """include required("{conf}")
renderer {{
    perturb = 0.0
}}
"""
# the d_latent 640 model's view: the field path is off for a global
# latent, so the pyramid gather (single output) and the ResnetFC primal
GLOBAL_VIEW_LAUNCHES = _launch_table(posenc_concat=2, pyramid_gather=2, resnetfc_fwd=2)
DTU_CLI_KERNELS = ("posenc_concat", "resnetfc_fwd_stash", "resnetfc_bwd", "resnetfc_fwd")
DTU_SERVE_KERNELS = ("posenc_concat", "resnetfc_fwd")
WIDE_LATENTS = (640, 1024)
PLAIN_VERSIONS = {
    "field": ("field_plain", "field_bwd_plain"),
    "posenc": ("posenc_concat_plain",),
    "pyramid": ("pyramid_gather_plain", "pyramid_scatter_add_plain"),
    "resnetfc": ("resnetfc_fwd_plain", "resnetfc_bwd_plain"),
    "scatter": ("bilerp_gather_plain", "bilerp_scatter_add_plain"),
}


def check_wide_latent(torch, np, dev):
    """The ResnetFC forward, stash forward and backward at d_latent 640 (a
    global latent) and 1024 (five encoder levels), hidden 512, at the train
    step's coarse call (SB x 2 views x 65,536 points), against the plain
    versions, timed beside the flagship's d_latent 512 at the same shape.
    Returns {kernel: {"d_latent_640": {...}, "d_latent_1024": {...}}}."""
    from pixelnerf_tpu_torch.ops.field import FieldWeights, field_flops
    from pixelnerf_tpu_torch.ops.resnetfc import (
        resnetfc_bwd, resnetfc_bwd_plain, resnetfc_fwd, resnetfc_fwd_plain, resnetfc_fwd_stash,
    )

    g = torch.Generator(device=dev).manual_seed(9)
    ns, b = TRAIN_NS, TRAIN_RAYS * N_COARSE
    args = (N_BLOCKS, COMBINE, ns)
    out = {k: {} for k in ("resnetfc_fwd", "resnetfc_fwd_stash", "resnetfc_bwd")}
    flagship = {}
    for dl in (512,) + WIDE_LATENTS:
        w = _random_weights(torch, g, dev, dl)
        z = (torch.randn((SB, ns, b, dl), generator=g, device=dev)).to(torch.bfloat16)
        xin = torch.randn((SB, ns, b, D_IN), generator=g, device=dev).to(torch.bfloat16)
        gout = torch.randn((SB, b, D_OUT), generator=g, device=dev) * 1e-3
        flops = field_flops(ns, D_IN, dl, HIDDEN, D_OUT, N_BLOCKS, COMBINE) * SB * b
        wbytes = sum(t.numel() * 2 for t in w)
        in_bytes = z.numel() * 2 + xin.numel() * 2 + wbytes
        out_bytes = SB * b * D_OUT * 4
        fwd = lambda: resnetfc_fwd(z, xin, w, *args)
        stash = lambda: resnetfc_fwd_stash(z, xin, w, *args)
        ms = {"resnetfc_fwd": _time_ms(torch, fwd, 1, 3), "resnetfc_fwd_stash": _time_ms(torch, stash, 1, 3)}
        _, spre, spost = stash()
        bwd = lambda: resnetfc_bwd(z, xin, gout, spre, spost, w, *args)
        ms["resnetfc_bwd"] = _time_ms(torch, bwd, 1, 3)
        if dl == 512:
            flagship = ms
            print(f"wide latent: d_latent 512 (the flagship's) at SB={SB} NS={ns} B={b}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
            del z, xin, gout, spre, spost
            continue
        got = fwd()
        got_s, spre2, spost2 = stash()
        torch.cuda.synchronize()
        want, wpre, wpost = resnetfc_fwd_plain(z, xin, w, *args, stash=True)
        diff = (got - want).abs()
        excess = (diff - (FIELD_ATOL + FIELD_RTOL * want.abs())).max().item()
        if not (torch.isfinite(got).all() and excess <= 0 and torch.equal(got, got_s)):
            raise AssertionError(f"wide latent {dl}: the ResnetFC forward disagrees with its plain version")
        dz, dxin, dw = bwd()
        torch.cuda.synchronize()
        wdz, wdxin, wdw = resnetfc_bwd_plain(z, xin, gout, spre, spost, w, *args)
        pairs = [("dz", dz, wdz), ("dxin", dxin, wdxin)] + [
            (f"d{n}", getattr(dw, n), getattr(wdw, n)) for n in FieldWeights._fields]
        worst = _check_grads(torch, f"wide latent {dl} resnetfc_bwd", pairs, False)
        stash_bytes = sum(t.numel() * 2 for t in (spre, spost) if t is not None)
        grad_bytes = in_bytes - wbytes + sum(t.numel() * 4 for t in w)
        plain = {
            "resnetfc_fwd": _time_ms(torch, lambda: resnetfc_fwd_plain(z, xin, w, *args), 1, 2),
            "resnetfc_fwd_stash": _time_ms(
                torch, lambda: resnetfc_fwd_plain(z, xin, w, *args, stash=True), 1, 2),
            "resnetfc_bwd": _time_ms(
                torch, lambda: resnetfc_bwd_plain(z, xin, gout, spre, spost, w, *args), 1, 2),
        }
        bounds = {
            "resnetfc_fwd": _bound(flops, PEAK_BF16_FLOPS, in_bytes + out_bytes),
            "resnetfc_fwd_stash": _bound(flops, PEAK_BF16_FLOPS, in_bytes + out_bytes + stash_bytes),
            "resnetfc_bwd": _bound(2 * flops, PEAK_BF16_FLOPS,
                                   in_bytes + out_bytes + stash_bytes + grad_bytes),
        }
        errs = {"resnetfc_fwd": diff.max().item(), "resnetfc_fwd_stash": diff.max().item(),
                "resnetfc_bwd": worst}
        for k in out:
            out[k][f"d_latent_{dl}"] = {
                "shape": f"SB={SB} NS={ns} B={b} hidden {HIDDEN}", "ms": ms[k], "plain_ms": plain[k],
                "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "max_abs_err": errs[k],
                "flagship_ms": flagship[k],
            }
            print(f"wide latent: d_latent {dl} {k}: kernel {ms[k]:.3f} ms ({ms[k] / flagship[k]:.3f}x "
                  f"the flagship's {flagship[k]:.3f} ms; FLOPs {flops / 1e12:.2f} T = "
                  f"{flops / ms[k] / 1e9:.1f} TFLOP/s), plain {plain[k]:.3f} ms, bound "
                  f"{bounds[k][0]:.3f} ms ({bounds[k][1]}), max_abs_err {errs[k]:.3e}")
        del z, xin, gout, spre, spost, spre2, spost2, got, got_s, want, wpre, wpost, diff
        del dz, dxin, dw, wdz, wdxin, wdw, pairs
        torch.cuda.empty_cache()
    return out


# the layered path (ops/layer_chain.py, csrc/layer_chain.cu): the widths the
# chains lack. Its kernels are held against their plain versions launch by
# launch at the coarse train call's shapes (SB x NS x B = 524,288 pre-pool
# rows) at hidden 1024 with 2 views (the wide phase's model), hidden 64
# with 80 views and hidden 512 with 2 views (also against the chain there).
# One product's f32 outputs: the same exact bf16 products summed in another
# order, within 1e-3 of the largest magnitude; bf16 copies that and one
# bf16 ulp more (a value near zero may round from either side of it).
LAYERED_CASES = (
    ("hidden_1024", 1024, TRAIN_NS, TRAIN_RAYS * N_COARSE),
    ("views_80", 64, 80, TRAIN_RAYS * N_COARSE * TRAIN_NS // 80),
    ("hidden_512", 512, TRAIN_NS, TRAIN_RAYS * N_COARSE),
)
LAYER_F32_TOL, LAYER_BF16_ULP = 1e-3, 2.0 ** -7
WIDE_HIDDEN = 1024
WIDE_NAME = f"srn.conf d_hidden {WIDE_HIDDEN}"
LAYERED_REPLACES = {
    "layer_fwd": "pixelnerf_tpu/ops/resnetfc_pallas.py:551",
    "view_pool_fwd": "pixelnerf_tpu/ops/resnetfc_pallas.py:551",
    "layer_bwd": "pixelnerf_tpu/ops/resnetfc_pallas.py:607",
    "view_pool_bwd": "pixelnerf_tpu/ops/resnetfc_pallas.py:607",
}
# the layered launches of one ResnetFC call at srn.conf's 5 blocks and 3
# injections (more than one view): w_in, 3 injections, 2 a block and
# lin_out; the pooling. The backward: lin_out, 2 a block, 3 injections and
# dxin, and a column-sum reduction after each product that sums bias
# gradients (lin_out's and 2 a block, but the one before the pooling,
# whose sums view_pool_bwd takes); bf(g) and the pooling, each with the
# reduction of its column sums (b_out's, the sums before the pooling)
LAYER_FWD_CALL = 1 + 3 + 2 * N_BLOCKS + 1
LAYER_BWD_CALL = (1 + 2 * N_BLOCKS + 3 + 1) + (1 + 2 * N_BLOCKS - 1)


def _layered(fwd_calls, bwd_calls=0, **counts):
    """A launch table of layered calls: each forward call's layer_fwd and
    pooling launches, each backward call's layer_bwd and pooling ones."""
    return _launch_table(layer_fwd=LAYER_FWD_CALL * fwd_calls, view_pool_fwd=fwd_calls,
                         layer_bwd=LAYER_BWD_CALL * bwd_calls, view_pool_bwd=4 * bwd_calls, **counts)


WIDE_VIEW_LAUNCHES = _layered(2, posenc_concat=2, pyramid_gather=2)
WIDE_TRAIN_LAUNCHES = _layered(3, 3, posenc_concat=2, pyramid_gather=2, pyramid_scatter_add=2)
WIDE_EVAL_LAUNCHES = _layered(3, posenc_concat=2, pyramid_gather=2)
WIDE_FUSED_TRAIN_LAUNCHES = _layered(2, 2, posenc_concat=2, pyramid_gather=2, pyramid_scatter_add=2)
WIDE_FUSED_EVAL_LAUNCHES = _layered(2, posenc_concat=2, pyramid_gather=2)
# the 80-view render: one object of VIEWS80 + 1 views written by the
# port's make_synthetic_dataset, the last rendered from the others through
# render_full in chunks of 1,152 rays (x 96 fine samples x 80 views = 8.8M
# pre-pool rows, 69,120 row tiles of the layered products: past the 65,535
# of a grid's y axis); VIEWS80_HELD rays, one every other row with its
# column stepped by 37 (prime to the width), so that they cover the view's
# rows and columns, against the CPU plain render
VIEWS80, VIEWS80_CHUNK, VIEWS80_HELD = 80, 1152, 64


def _recording(names):
    """A context that records each call of `ops/layer_chain.py`'s `names`
    (its bound arguments, the tensors themselves) while it runs them."""
    import contextlib
    import inspect

    from pixelnerf_tpu_torch.ops import layer_chain

    calls = []

    @contextlib.contextmanager
    def patched():
        reals = {n: getattr(layer_chain, n) for n in names}

        def wrap(name, real):
            sig = inspect.signature(real)

            def call(*args, **kwargs):
                calls.append((name, dict(sig.bind(*args, **kwargs).arguments)))
                return real(*args, **kwargs)

            call.__dict__ = real.__dict__
            return call

        for n, real in reals.items():
            setattr(layer_chain, n, wrap(n, real))
        try:
            yield calls
        finally:
            for n, real in reals.items():
                setattr(layer_chain, n, real)

    return patched()


# each layered kernel's outputs (written in place) among its arguments
LAYER_OUTPUTS = {"layer_fwd": ("x", "y"), "layer_bwd": ("x", "y", "colsum"),
                 "view_pool_fwd": ("out", "y"), "view_pool_bwd": ("gx", "y", "colsum")}


def _launch_cost(name, a):
    """(FLOPs, bytes, library call or None) of one recorded launch: each
    input read once, each output written once (the residual read too where
    the product adds into it); the library call is the same product as one
    bf16 torch.matmul, or the mean as torch.mean."""
    nb = lambda t: 0 if t is None else t.numel() * t.element_size()
    if name in ("layer_fwd", "layer_bwd"):
        w = a["w"]
        m, k = a["a"].shape
        n = w.shape[0] if name == "layer_bwd" else w.shape[1]
        cols = a.get("cols") or n
        out_bytes = sum(m * cols * s for key, s in (("x", 4), ("y", 2)) if a.get(key) is not None)
        in_bytes = nb(a["a"]) + nb(w) + nb(a.get("bias")) + (m * cols * 2 if a.get("mask") is not None else 0)
        in_bytes += m * cols * 4 if a.get("add") else 0
        lib = (lambda: a["a"] @ w.t()) if name == "layer_bwd" else (lambda: a["a"] @ w)
        return 2 * m * n * k, in_bytes + out_bytes + nb(a.get("colsum")), lib
    if name == "view_pool_fwd":
        x = a["x"]
        return x.numel(), nb(x) + nb(a["out"]) + nb(a.get("y")), (lambda: x.mean(dim=1))
    g, ns = a["g"], a["ns"]
    return g.numel() * ns, nb(g) + nb(a.get("gx")) + nb(a.get("y")) + nb(a.get("colsum")), None


def _graph_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    """The card's own time of `fn` a call: `calls` calls captured in one
    CUDA graph, replayed `replays` times between two events. The replay
    launches the kernels back to back from the card, so the host's share of
    a call (a wrapper's checks, ctypes, the queueing), which events around
    a launch of 0.05-0.1 ms can hold the stream for, is not read as kernel
    time. `fn` runs once on a side stream first, as capture asks."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms


def _replay_launch(torch, name, a, base=None):
    """One recorded launch again, on copies of its outputs, as the kernel
    and as the plain version: a dict of the max abs error (`err`), the
    kernel's, plain version's and library call's event ms (`ms`,
    `plain_ms`, `lib_ms`: None without a library call), FLOPs, bytes, the
    kernel's plan (or None) and, with `base` (an earlier tree's kernel of
    the same arguments), its ms timed in turns (baseline, kernel, kernel,
    baseline; `base_ms`). The pooling's launches also give the card's own
    time of each (`dev_ms`, `base_dev_ms`, `lib_dev_ms`: `_graph_ms`, in
    turns too; `dev_two`: the kernel's two readings, for their spread), and
    `view_pool_fwd`'s `base_equal`: its outputs equal to the baseline's
    (both add the views in order). f32 outputs within LAYER_F32_TOL of their largest magnitude, bf16
    ones within one bf16 ulp more."""
    from pixelnerf_tpu_torch.ops import layer_chain

    kernel, plain = getattr(layer_chain, name), getattr(layer_chain, f"{name}_plain")
    outs = [k for k in LAYER_OUTPUTS[name] if a.get(k) is not None]
    start = {k: a[k].clone() for k in outs}

    def run(fn):
        args = dict(a)
        args.update({k: start[k].clone() for k in outs})
        fn(**args)
        return {k: args[k] for k in outs}

    got = run(kernel)
    r = {"plan": getattr(kernel, "plan", None), "base_equal": None}
    want = run(plain)
    torch.cuda.synchronize()
    err = 0.0
    for k in outs:
        g, w = got[k].float(), want[k].float()
        d = (g - w).abs()
        err = max(err, d.max().item())
        # a bf16 copy: the f32 value's allowance, then one bf16 ulp
        bound = LAYER_F32_TOL * w.abs().max() + (
            LAYER_BF16_ULP * w.abs() if got[k].dtype == torch.bfloat16 else 0.0)
        if not (torch.isfinite(g).all() and (d <= bound + 1e-30).all()):
            raise AssertionError(f"{name}: output {k} disagrees with the plain version "
                                 f"(max abs error {d.max().item():.3e})")
    if base is not None and name == "view_pool_fwd":
        theirs = run(base)
        r["base_equal"] = all(torch.equal(got[k], theirs[k]) for k in outs)
        if not r["base_equal"]:
            raise AssertionError("view_pool_fwd: the outputs differ from the baseline's")
        del theirs
    del got, want
    r["err"] = err
    r["flops"], r["bytes"], lib = _launch_cost(name, a)
    ka = dict(a)
    ka.update({k: start[k] for k in outs})
    run_k = lambda: kernel(**ka)
    pool = name.startswith("view_pool")
    r["dev_ms"] = r["base_dev_ms"] = r["dev_two"] = None
    if base is None:
        r["ms"], r["base_ms"] = _time_ms(torch, run_k, 1, 3), None
        if pool:
            r["dev_two"] = (_graph_ms(torch, run_k), _graph_ms(torch, run_k))
    else:
        run_b = lambda: base(**ka)
        b0, k0, k1, b1 = (_time_ms(torch, f, 1, 3) for f in (run_b, run_k, run_k, run_b))
        r["ms"], r["base_ms"] = (k0 + k1) / 2, (b0 + b1) / 2
        if pool:
            b0, k0, k1, b1 = (_graph_ms(torch, f) for f in (run_b, run_k, run_k, run_b))
            r["dev_two"], r["base_dev_ms"] = (k0, k1), (b0 + b1) / 2
    if r["dev_two"] is not None:
        r["dev_ms"] = sum(r["dev_two"]) / 2
    r["plain_ms"] = _time_ms(torch, lambda: plain(**ka), 0, 1)
    r["lib_ms"] = None if lib is None else _time_ms(torch, lib, 1, 3)
    r["lib_dev_ms"] = _graph_ms(torch, lib) if pool and lib is not None else None
    return r


def _launch_line(name, a, ms, base_ms, lib_ms, flops, nbytes):
    """One replayed product: its shape, which epilogue parts it runs (x
    written, + added into, y, mask, column sums), its times and bound."""
    m, k = a["a"].shape
    n = a["w"].shape[0] if name == "layer_bwd" else a["w"].shape[1]
    on = {"x": a.get("x") is not None, "+": bool(a.get("add")), "y": a.get("y") is not None,
          "m": a.get("mask") is not None, "s": a.get("colsum") is not None}
    parts = "".join(c for c, v in on.items() if v)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (f"{name} M={m} K={k} N={n} {parts}: kernel {ms:.3f} ms"
            + ("" if base_ms is None else f", baseline {base_ms:.3f} ms")
            + ("" if lib_ms is None else f", library {lib_ms:.3f} ms")
            + f", bound {max(t_ops, t_bytes):.3f} ms ({'operations' if t_ops >= t_bytes else 'bytes'})"
            + f", {flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s")


def _pool_line(name, a, r):
    """One replayed pooling launch: its shape, which outputs it writes, the
    event and the card's own times (the kernel's two readings, the
    baseline's and the library's beside them), the bytes bound and the
    kernel's rate."""
    x = a["x"] if name == "view_pool_fwd" else a["g"]
    shape = ("SB={} NS={} B={} H={}".format(*x.shape) if name == "view_pool_fwd" else
             "SB={} B={} C={} NS={}".format(*x.shape, a["ns"]))
    outs = "+".join(k for k in LAYER_OUTPUTS[name] if a.get(k) is not None)
    bound = r["bytes"] / PEAK_BYTES * 1e3
    timed = lambda what, ev, dv: [] if ev is None else [
        f"{what} {ev:.4f} ms" + ("" if dv is None else f" (device {dv:.4f} ms)")]
    two = "" if r["dev_two"] is None else " (device {:.4f} and {:.4f} ms)".format(*r["dev_two"])
    parts = ([f"kernel {r['ms']:.4f} ms{two}"] + timed("baseline", r["base_ms"], r["base_dev_ms"])
             + timed("library", r["lib_ms"], r["lib_dev_ms"])
             + [f"bound {bound:.4f} ms (bytes)", f"{r['bytes'] / (r['dev_ms'] or r['ms']) / 1e6:.1f} GB/s"]
             + ([] if r["base_equal"] is None else ["equal to the baseline"]))
    return f"{name} {shape} ({outs}): " + ", ".join(parts)


def check_layered(torch, np, dev, baseline=None):
    """The layered kernels at the widths the chains lack, launch by launch
    at the coarse train call's shapes, against their plain versions: the
    stash forward and the backward of each case in LAYERED_CASES through
    the wrappers the model calls, each recorded launch replayed as the
    kernel and as the plain version and timed beside bf16 torch.matmul of
    the same product or torch.mean of the same pooling (and, with
    `baseline`, an earlier tree's kernel of the same launch in turns with
    the kernel); the pooling's launches also in the card's own time
    (`_graph_ms`); the whole forward and backward against the plain ones;
    at hidden 512 the layered path against the chain. Each product's plan
    (N tile, N tiles, row slots, grid) is printed. Returns the four
    kernels' records (hidden 1024's sums, the other cases under their
    names)."""
    from pixelnerf_tpu_torch.ops.field import FieldWeights
    from pixelnerf_tpu_torch.ops.layer_chain import layered_bwd, layered_fwd
    from pixelnerf_tpu_torch.ops.resnetfc import (
        resnetfc_bwd, resnetfc_bwd_plain, resnetfc_fwd, resnetfc_fwd_plain, resnetfc_fwd_stash,
        takes_chains,
    )

    g = torch.Generator(device=dev).manual_seed(12)
    recs = {}
    for case, hidden, ns, b in LAYERED_CASES:
        args = (N_BLOCKS, COMBINE, ns)
        w = _random_weights(torch, g, dev, 512, hidden)
        z = torch.randn((SB, ns, b, 512), generator=g, device=dev).to(torch.bfloat16)
        xin = torch.randn((SB, ns, b, D_IN), generator=g, device=dev).to(torch.bfloat16)
        gout = torch.randn((SB, b, D_OUT), generator=g, device=dev) * 1e-3
        chained = takes_chains(hidden, 512, D_IN, D_OUT, ns)
        if chained != (case == "hidden_512"):
            raise AssertionError(f"layered {case}: the wrappers' route is not the expected one")
        fwd = (lambda: layered_fwd(z, xin, w, *args, stash=True)) if chained else (
            lambda: resnetfc_fwd_stash(z, xin, w, *args))
        with _recording(LAYER_OUTPUTS) as calls:
            out, spre, spost = fwd()
            bwd = (lambda: layered_bwd(z, xin, gout, spre, spost, w, *args)[:3]) if chained else (
                lambda: resnetfc_bwd(z, xin, gout, spre, spost, w, *args))
            dz, dxin, dw = bwd()
        torch.cuda.synchronize()
        sums = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0, bytes=0, max_abs_err=0.0, n=0,
                        lib=False, baseline_ms=0.0, plans={}, device_ms=0.0, baseline_device_ms=0.0,
                        library_device_ms=0.0) for k in LAYER_OUTPUTS}
        label = f"layered {case} (SB={SB} NS={ns} B={b} hidden {hidden})"
        for i, (name, a) in enumerate(calls):
            base = None if baseline is None else baseline.get(name)
            r = _replay_launch(torch, name, a, base)
            s, plan = sums[name], r["plan"]
            if name.startswith("layer_"):
                print(f"{label}: launch {i} "
                      + _launch_line(name, a, r["ms"], r["base_ms"], r["lib_ms"], r["flops"], r["bytes"]))
                if plan is not None:
                    key = (plan.bn, plan.n_tiles, plan.slots, plan.grid)
                    s["plans"][key] = s["plans"].get(key, 0) + 1
            else:
                print(f"{label}: launch {i} {_pool_line(name, a, r)}")
            s["baseline_ms"] += r["base_ms"] or 0.0
            s["ms"] += r["ms"]
            s["plain_ms"] += r["plain_ms"]
            s["library_ms"] += r["lib_ms"] or 0.0
            s["lib"] |= r["lib_ms"] is not None
            s["device_ms"] += r["dev_ms"] or 0.0
            s["baseline_device_ms"] += r["base_dev_ms"] or 0.0
            s["library_device_ms"] += r["lib_dev_ms"] or 0.0
            s["flops"] += r["flops"]
            s["bytes"] += r["bytes"]
            s["max_abs_err"] = max(s["max_abs_err"], r["err"])
            # a launch that sums bias gradients launches its reduction too
            s["n"] += 1 + (name in ("layer_bwd", "view_pool_bwd") and a.get("colsum") is not None)
        del calls
        torch.cuda.empty_cache()
        for name, s in sums.items():
            t_ops = s["flops"] / (PEAK_BF16_FLOPS if name.startswith("layer_") else PEAK_F32_FLOPS) * 1e3
            t_bytes = s["bytes"] / PEAK_BYTES * 1e3
            s["bound_ms"], s["bound_by"] = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
            on_card = lambda key: f" (device {s[key]:.4f} ms)" if s[key] else ""
            print(f"{label}: {name} x{s['n']} launches: kernel {s['ms']:.3f} ms{on_card('device_ms')}, plain "
                  f"{s['plain_ms']:.3f} ms, bound {s['bound_ms']:.3f} ms ({s['bound_by']}), library "
                  + (f"{s['library_ms']:.3f} ms{on_card('library_device_ms')}" if s["lib"] else "none")
                  + f", {s['flops'] / max(s['ms'], 1e-9) / 1e9:.1f} TFLOP/s, max_abs_err "
                  f"{s['max_abs_err']:.3e}; each launch against its plain version"
                  + (f"; baseline {s['baseline_ms']:.3f} ms{on_card('baseline_device_ms')} in turns"
                     if s["baseline_ms"] else ""))
            if s["plans"]:
                print(f"{label}: {name} plans (N tile, N tiles, row slots, grid: launches): "
                      + ", ".join(f"{k}: {v}" for k, v in sorted(s["plans"].items())))
        want = resnetfc_fwd_plain(z, xin, w, *args)
        excess = ((out - want).abs() - (FIELD_ATOL + FIELD_RTOL * want.abs())).max().item()
        primal = layered_fwd(z, xin, w, *args, stash=False)[0] if chained else resnetfc_fwd(
            z, xin, w, *args)
        if not (torch.isfinite(out).all() and excess <= 0 and torch.equal(out, primal)):
            raise AssertionError(f"{label}: the forward disagrees with its plain version")
        del want, primal
        wdz, wdxin, wdw = resnetfc_bwd_plain(z, xin, gout, spre, spost, w, *args)
        pairs = [("dz", dz, wdz), ("dxin", dxin, wdxin)] + [
            (f"d{n}", getattr(dw, n), getattr(wdw, n)) for n in FieldWeights._fields]
        _check_grads(torch, f"{label} backward", pairs, False)
        del wdz, wdxin, wdw, pairs
        if chained:  # the chain's forward and backward beside the layered ones
            out_c, cpre, cpost = resnetfc_fwd_stash(z, xin, w, *args)
            d = (out - out_c).abs()
            if (d - (FIELD_ATOL + FIELD_RTOL * out_c.abs())).max().item() > 0:
                raise AssertionError(f"{label}: the layered forward disagrees with the chain's")
            for st, sc in ((spre, cpre), (spost, cpost)):
                if (st.float() - sc.float()).abs().gt(FIELD_ATOL + FIELD_RTOL * sc.float().abs()).any():
                    raise AssertionError(f"{label}: the layered stash disagrees with the chain's")
            for pre, post, which in ((cpre, cpost, "chain"), (spre, spost, "layered")):
                lz, lx, lw = layered_bwd(z, xin, gout, pre, post, w, *args)[:3]
                cz, cx, cw = resnetfc_bwd(z, xin, gout, pre, post, w, *args)
                pairs = [("dz", lz, cz), ("dxin", lx, cx)] + [
                    (f"d{n}", getattr(lw, n), getattr(cw, n)) for n in FieldWeights._fields]
                _check_grads(torch, f"{label} layered vs chain backward on the {which} stash",
                             pairs, False)
            print(f"{label}: the layered forward within {FIELD_ATOL} + {FIELD_RTOL} relative of the "
                  f"chain's (max {d.max().item():.3e}), its stash too, and both backwards agree on "
                  "either stash")
            del out_c, cpre, cpost, d, pairs
        res = {k: {"ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                   "bound_by": s["bound_by"], "max_abs_err": s["max_abs_err"],
                   "library_ms": s["library_ms"] if s["lib"] else None,
                   "launches_a_call": s["n"], "shape": f"SB={SB} NS={ns} B={b} hidden {hidden}"}
               for k, s in sums.items()}
        for k, s in sums.items():
            for key in ("baseline_ms", "device_ms", "baseline_device_ms", "library_device_ms"):
                if s[key]:
                    res[k][key] = s[key]
        for k, r in res.items():
            if case == "hidden_1024":
                recs[k] = _record(k, "cuda", "pixelnerf_tpu_torch/csrc/layer_chain.cu",
                                  LAYERED_REPLACES[k], {x: r[x] for x in (
                                      "ms", "plain_ms", "bound_ms", "max_abs_err", "shape",
                                      "launches_a_call", "baseline_ms", "device_ms",
                                      "baseline_device_ms", "library_device_ms") if x in r},
                                  r["bound_by"], r["library_ms"])
            else:
                recs[k][case] = r
        del z, xin, gout, out, spre, spost, dz, dxin, dw, w
        torch.cuda.empty_cache()
    return [recs[k] for k in LAYER_OUTPUTS]


def run_wide(torch, np, dev, conf, card):
    """srn.conf with d_hidden 1024 in both heads, everything else uncut: a
    128x128 view through render_full (held rays against the CPU plain
    render), the cached and the fused train steps at bench.py's batch
    (against the CPU plain step), every counted run on the layered
    kernels and no chain. Returns the counted runs' launches."""
    wide = _config_variant(conf, **{"mlp_coarse.d_hidden": WIDE_HIDDEN,
                                    "mlp_fine.d_hidden": WIDE_HIDDEN})
    runs = run_view(torch, np, dev, wide, card, "wide slice", WIDE_VIEW_LAUNCHES, name=WIDE_NAME)
    torch.cuda.empty_cache()
    runs += run_train(torch, np, dev, wide, card, "wide train", WIDE_TRAIN_LAUNCHES,
                      WIDE_EVAL_LAUNCHES, name=WIDE_NAME)
    torch.cuda.empty_cache()
    runs += run_train(torch, np, dev, wide, card, "wide fused train", WIDE_FUSED_TRAIN_LAUNCHES,
                      WIDE_FUSED_EVAL_LAUNCHES, fusion=True, name=WIDE_NAME)
    return runs


def _card_plain_route():
    """A context manager in which the kernel wrappers of the ResnetFC, the
    field, the layered path and the bilerp lookup run their plain versions
    on the card's tensors (their device test answers "cpu"): the card's
    own float32 arithmetic, for a witness beside the CPU plain render."""
    import contextlib
    import importlib

    @contextlib.contextmanager
    def plain():
        mods = [importlib.import_module(f"pixelnerf_tpu_torch.ops.{m}")
                for m in ("resnetfc", "field", "layer_chain", "scatter")]
        real = [m._device_of for m in mods]
        for m in mods:
            m._device_of = lambda t, what: "cpu"
        try:
            yield
        finally:
            for m, f in zip(mods, real):
                m._device_of = f

    return plain()


def run_views80(torch, np, dev, conf, card):
    """srn.conf (hidden 512) rendering one 128x128 view of an object from
    VIEWS80 source views: the object written by the port's
    make_synthetic_dataset (srn layout), read by the port's SRN loader,
    encoded, and the last view rendered through render_full in chunks of
    VIEWS80_CHUNK rays on the layered kernels (80 views are past one
    64-row tile, a chunk's rows past a grid's y axis); VIEWS80_HELD rays
    spread over the view against the CPU plain render: rgb as every held
    render, and each ray's depth and alpha. The same rays through the
    card's plain route are printed beside them, as the witness of how far
    the card's own float32 arithmetic lies from the CPU's. Returns the
    counted run's launches."""
    import tempfile

    from pixelnerf_tpu_torch.data import get_split_dataset
    from pixelnerf_tpu_torch.eval.common import encode_views
    from pixelnerf_tpu_torch.eval.render_utils import render_full
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.tools import make_synthetic_dataset
    from pixelnerf_tpu_torch.utils.rays import gen_rays

    label = "80 views"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_synthetic_dataset.main(["--out", tmp, "--format", "srn", "--n_objs", "1", "--n_views",
                                     str(VIEWS80 + 1), "--size", str(VIEW_SIZE), "--seed", "5"])
        item = get_split_dataset("srn", f"{tmp}/shapes", want_split="train", training=False)[0]
        print(f"{label}: make_synthetic_dataset wrote one object of {VIEWS80 + 1} "
              f"{VIEW_SIZE}x{VIEW_SIZE} views in {time.perf_counter() - t0:.1f} s")
    images, poses, focal = item["images"], item["poses"], float(item["focal"])
    model = make_model(conf["model"], device=dev, seed=0)
    shape_heads(torch, model)
    rcfg = RendererConfig.from_conf(conf["renderer"]).replace(perturb=0.0)
    target = torch.from_numpy(poses[VIEWS80:]).to(dev)
    rays = gen_rays(target, VIEW_SIZE, VIEW_SIZE, focal, 0.8, 1.8).reshape(-1, 8)
    enc = encode_views(model, images[:VIEWS80], poses[:VIEWS80], focal)
    i = torch.arange(VIEWS80_HELD, device=dev)
    held = 2 * i * VIEW_SIZE + 37 * i % VIEW_SIZE
    fit_heads(torch, model, lambda: render_full(model, enc, rays[held], rcfg, chunk=VIEWS80_CHUNK),
              label)
    chunks = -(-rays.shape[0] // VIEWS80_CHUNK)
    expected = _layered(2 * chunks, posenc_concat=2 * chunks, pyramid_gather=2 * chunks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = _counted(torch, lambda: render_full(model, enc, rays, rcfg, chunk=VIEWS80_CHUNK),
                             expected, label)
    view_s = time.perf_counter() - t0
    print(f"{label}: srn.conf bf16, {VIEWS80} source views, {rays.shape[0]} rays in chunks of "
          f"{VIEWS80_CHUNK} (render_full, encoding excluded) {view_s:.3f} s = "
          f"{rays.shape[0] / view_s:.1f} rays/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {card}")
    for head in ("coarse", "fine"):
        rgb = out[head]["rgb"]
        if not torch.isfinite(rgb).all() or rgb.shape != (VIEW_SIZE * VIEW_SIZE, 3):
            raise AssertionError(f"{label}: {head} rgb non-finite or misshapen")
    ref = _held_render(torch, label, copy.deepcopy(model).to("cpu"),
                       ((model, enc, rays, rcfg), {}, out), held, ALPHA_RANGE)
    with torch.no_grad(), _card_plain_route():
        plain = render_full(model, enc, rays[held], rcfg, chunk=VIEWS80_CHUNK)
    for head in ("coarse", "fine"):
        for key in ("depth", "alpha", "rgb"):
            d = (out[head][key][held].cpu() - ref[head][key]).abs()
            dp = (plain[head][key].cpu() - ref[head][key]).abs()
            print(f"{label}: {head} {key} vs CPU plain max {d.max().item():.3e} mean "
                  f"{d.mean().item():.3e}; the card's plain route vs CPU plain max "
                  f"{dp.max().item():.3e} mean {dp.mean().item():.3e}")
            if key != "rgb" and not (d.max().item() <= RENDER_ATOL and d.mean().item() <= RENDER_MEAN):
                raise AssertionError(f"{label}: {head} {key} disagrees with the CPU plain render")
    return [launches]


def _write_dtu_dataset(np, root):
    """A DTU-layout dataset (rs_dtu_4: `DTU/scanN/image/*.png` at 300x400,
    `cameras.npz` with `world_mat_i` = K [R | t] and `scale_mat_i`, and
    `DTU/new_{train,val,test}.lst`): DTU_VIEWS cameras on an arc looking
    at the origin, each view a coloured disc and bar on black that move
    with the view."""
    from PIL import Image

    rng = np.random.default_rng(13)
    cat = Path(root) / "dtu" / "DTU"
    yy, xx = np.mgrid[0:DTU_H, 0:DTU_W]
    K = np.array([[DTU_FOCAL, 0, DTU_W / 2], [0, DTU_FOCAL, DTU_H / 2], [0, 0, 1]])
    flip = np.diag([1.0, -1.0, -1.0, 1.0])  # the loader's OpenCV <-> OpenGL camera flip
    n = 0
    for stage, count in DTU_SCANS:
        names = []
        for _ in range(count):
            n += 1
            d = cat / f"scan{n}"
            (d / "image").mkdir(parents=True)
            disc, bar = rng.integers(40, 230, 3), rng.integers(40, 230, 3)
            cams = {}
            for v in range(DTU_VIEWS):
                theta = -0.6 + 1.2 * v / (DTU_VIEWS - 1)
                img = np.zeros((DTU_H, DTU_W, 3), np.uint8)
                cx, cy = DTU_W * (0.5 + 0.15 * np.sin(3 * theta)), DTU_H * 0.5
                img[(yy - cy) ** 2 + (xx - cx) ** 2 <= (0.25 * DTU_H) ** 2] = disc
                img[int(0.7 * DTU_H):int(0.8 * DTU_H), int(0.3 * DTU_W):int(0.7 * DTU_W)] = bar
                Image.fromarray(img).save(d / "image" / f"{v:06d}.png")
                eye = [2.0 * np.sin(theta), 0.4, 2.0 * np.cos(theta)]
                pose_cv = flip @ _look_at(np, eye).astype(np.float64) @ flip  # camera-to-world
                rot = pose_cv[:3, :3].T
                P = np.eye(4)
                P[:3] = K @ np.concatenate([rot, -rot @ pose_cv[:3, 3:]], 1)
                cams[f"world_mat_{v}"] = P
                cams[f"scale_mat_{v}"] = np.eye(4)
            np.savez(d / "cameras.npz", **cams)
            names.append(d.name)
        (cat / f"new_{stage}.lst").write_text("\n".join(names) + "\n")
    return str(Path(root) / "dtu")


def _write_nmr_dataset(np, root):
    """An NMR ShapeNet layout at 64x64 (the DVR format of sn64.conf: a
    category dir with `softras_{train,val,test}.lst`, objects with
    `image/`, `mask/` and `cameras.npz` holding `world_mat_inv_i` and a
    side-2 `camera_mat_i`): SN64_VIEWS views on a circle, a disc and bar on
    white."""
    from PIL import Image

    rng = np.random.default_rng(17)
    cat = Path(root) / "nmr" / "02691156"
    s = SN64_SIZE
    yy, xx = np.mgrid[0:s, 0:s]
    tw = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)
    tc = np.diag([1.0, -1.0, -1.0, 1.0])
    n = 0
    for stage, count in SN64_OBJECTS:
        names = []
        for _ in range(count):
            n += 1
            d = cat / f"obj{n:03d}"
            (d / "image").mkdir(parents=True)
            (d / "mask").mkdir()
            disc, bar = rng.integers(20, 230, 3), rng.integers(20, 230, 3)
            cams = {}
            for v in range(SN64_VIEWS):
                theta = 2 * np.pi * v / SN64_VIEWS
                img = np.full((s, s, 3), 255, np.uint8)
                cx, cy = s * (0.5 + 0.15 * np.sin(theta)), s * 0.5
                img[(yy - cy) ** 2 + (xx - cx) ** 2 <= (0.25 * s) ** 2] = disc
                img[int(0.7 * s):int(0.8 * s), int(0.3 * s):int(0.7 * s)] = bar
                Image.fromarray(img).save(d / "image" / f"{v:04d}.png")
                Image.fromarray(((img != 255).any(-1) * 255).astype(np.uint8)).save(
                    d / "mask" / f"{v:04d}.png")
                eye = [2.0 * np.sin(theta), 0.5, 2.0 * np.cos(theta)]
                pose = _look_at(np, eye).astype(np.float64)
                # the loader computes tw @ world_mat_inv @ tc: store its pre-image
                cams[f"world_mat_inv_{v}"] = np.linalg.inv(tw) @ pose @ np.linalg.inv(tc)
                cams[f"camera_mat_{v}"] = np.diag([1.5, 1.5, 1.0, 1.0])
            np.savez(d / "cameras.npz", **cams)
            names.append(d.name)
        (cat / f"softras_{stage}.lst").write_text("\n".join(names) + "\n")
    return str(Path(root) / "nmr")


def run_dtu(torch, np, dev, root, card):
    """dtu.conf uncut (bf16, ResNet-34, two 5-block 512-wide heads pooling
    3 views at block 3, 64 + 16 + 16 samples) on a DTU-layout dataset at
    300x400: the training CLI (-V 3) from a seeded init checkpoint whose
    heads `shape_heads` made visible, 2 epochs and a resume; then
    eval_approx -P "25 22 28" and gen_video on its DTU spline path on that
    init checkpoint, DTU_HELD_RAYS rays strided over eval_approx's first
    view held against the CPU plain render. Returns each CLI's launches."""
    import tempfile

    from pixelnerf_tpu_torch.data import get_split_dataset
    from pixelnerf_tpu_torch.eval import eval_approx, gen_video
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.utils import checkpoint as ckpt
    from pixelnerf_tpu_torch.utils import hocon

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        datadir = _write_dtu_dataset(np, tmp)
        print(f"dtu: wrote {sum(n for _, n in DTU_SCANS)} scans x {DTU_VIEWS} views of {DTU_H}x{DTU_W} "
              f"in {time.perf_counter() - t0:.1f} s")
        train_set = get_split_dataset("dvr_dtu", datadir, want_split="train")
        t0 = time.perf_counter()
        train_set[0]
        print(f"dtu: one training item ({type(train_set).__name__}: {DTU_VIEWS} views decoded and "
              f"colour-jittered) {time.perf_counter() - t0:.2f} s on the host")
        conf_path = root / "conf" / "exp" / "dtu.conf"
        train_conf, serve_conf = Path(tmp) / "dtu_train.conf", Path(tmp) / "dtu_serve.conf"
        train_conf.write_text(CONFIG_TRAIN_CONF.format(conf=conf_path))
        serve_conf.write_text(CONFIG_SERVE_CONF.format(conf=conf_path))
        conf = hocon.load(str(conf_path))
        init = make_model(conf["model"], device=dev, seed=0)
        if init.dtype != torch.bfloat16 or init.mlp_coarse.combine_layer != 3:
            raise AssertionError("dtu.conf should build a bf16 model pooling at block 3")
        shape_heads(torch, init)
        with torch.no_grad():
            for mlp in (init.mlp_coarse, init.mlp_fine):
                mlp.lin_out.bias[3] = DTU_SIGMA_BIAS
                mlp.lin_out.weight[:3] *= DTU_RGB_GAIN
        ckpt.save_model_weights(init, f"{tmp}/ckpt", "dtu", opt_init=True)
        # the eval CLIs serve these weights too: 4 steps of training turn
        # the black DTU backgrounds into an empty field
        ckpt.save_model_weights(init, f"{tmp}/ckpt", "dtu_init")
        print(f"dtu: dtu.conf bf16, {sum(p.numel() for p in init.parameters())} params")
        del init
        common = ["-n", "dtu", "-D", datadir, "--dataset_format", "dvr_dtu", "--checkpoints_path",
                  f"{tmp}/ckpt", "--visual_path", f"{tmp}/vis"]
        launches["train"] = _train_cli(
            torch, dev, "dtu cli", common + ["-c", str(train_conf), "--logs_path", f"{tmp}/logs"] + DTU_ARGS,
            card, profile=True)["launches"]
        missing = [k for k in DTU_CLI_KERNELS if launches["train"][k] <= 0]
        if missing:
            raise AssertionError(f"dtu cli: never launched {missing}")
        serve = common + ["-c", str(serve_conf), "--split", "test", "-P", DTU_SOURCE]
        serve[serve.index("dtu")] = "dtu_init"
        (psnr, ssim), launches["eval_approx"], first = _eval_cli(
            torch, dev, "dtu eval_approx", eval_approx.main, serve + ["--limit", "1"], card)
        (vid, frames), launches["gen_video"], _ = _eval_cli(
            torch, dev, "dtu gen_video", gen_video.main,
            serve + ["-S", "0", "--num_views", str(DTU_VIDEO_VIEWS)], card)
        for name in ("eval_approx", "gen_video"):
            missing = [k for k in DTU_SERVE_KERNELS if launches[name][k] <= 0]
            if missing:
                raise AssertionError(f"dtu {name}: never launched {missing}")
        frames_n = DTU_VIDEO_VIEWS // 5 * 6
        print(f"dtu: eval_approx psnr {psnr:.4f} ssim {ssim:.4f}; gen_video {Path(vid).name} "
              f"{frames.shape}")
        if not (math.isfinite(psnr) and math.isfinite(ssim)) or frames.shape != (frames_n, DTU_H, DTU_W, 3):
            raise AssertionError(f"dtu: metrics {psnr} {ssim} or frames {frames.shape}")
        model_cpu = make_model(hocon.load(str(serve_conf))["model"], device="cpu")
        ckpt.load_weights_file(model_cpu, f"{tmp}/ckpt/dtu_init/pixel_nerf_latest")
        idx = torch.arange(DTU_HELD_RAYS) * (DTU_H * DTU_W // DTU_HELD_RAYS) + DTU_W // 3
        _held_render(torch, f"dtu eval_approx ({DTU_HELD_RAYS} rays strided over the view)",
                     model_cpu, first, idx, ALPHA_RANGE)
    return launches


def run_sn64(torch, np, dev, root, card):
    """sn64.conf uncut (float32, use_first_pool = False) on an NMR ShapeNet
    layout at 64x64: the training CLI (-V 1), 2 epochs and a resume, then
    eval_approx. The JAX package runs no Pallas kernel on a float32 model
    (they gate on bf16), so neither does the port: every count must stay
    0."""
    import tempfile

    from pixelnerf_tpu_torch.eval import eval_approx

    with tempfile.TemporaryDirectory() as tmp:
        datadir = _write_nmr_dataset(np, tmp)
        conf_path = root / "conf" / "exp" / "sn64.conf"
        train_conf, serve_conf = Path(tmp) / "sn64_train.conf", Path(tmp) / "sn64_serve.conf"
        train_conf.write_text(CONFIG_TRAIN_CONF.format(conf=conf_path))
        serve_conf.write_text(CONFIG_SERVE_CONF.format(conf=conf_path))
        common = ["-n", "sn64", "-D", datadir, "--dataset_format", "dvr", "--checkpoints_path",
                  f"{tmp}/ckpt", "--visual_path", f"{tmp}/vis"]
        got = _train_cli(torch, dev, "sn64 cli",
                         common + ["-c", str(train_conf), "--logs_path", f"{tmp}/logs"] + SN64_ARGS, card,
                         profile=True)["launches"]
        (psnr, ssim), got_eval, _ = _eval_cli(
            torch, dev, "sn64 eval_approx", eval_approx.main,
            common + ["-c", str(serve_conf), "--split", "test", "-P", "0"], card)
        print(f"sn64: eval_approx psnr {psnr:.4f} ssim {ssim:.4f}; the CLI's float32 MLP leaves the "
              "fused kernels, so its step rematerializes the query (remat \"auto\")")
        if any(got.values()) or any(got_eval.values()) or not math.isfinite(psnr):
            raise AssertionError(f"sn64: float32 launched a kernel ({got}, {got_eval}) or psnr {psnr}")


def _config_variant(conf, **edits):
    """A deep copy of `conf` with `model` keys set: "a.b" = value."""
    from pixelnerf_tpu_torch.utils import hocon

    conf = copy.deepcopy(conf)
    for key, value in edits.items():
        node = conf["model"]
        *path, last = key.split(".")
        for p in path:
            node = node[p]
        node[last] = hocon.loads(value) if isinstance(value, str) and "=" in value else value
    return conf


def run_configs(torch, np, dev, root, card, conf):
    """The configs phase: dtu.conf and sn64.conf through the CLIs, then the
    bf16 models off the flagship through run_view and run_train. Returns
    {run: launches} of the counted runs."""
    import traceback

    runs, failed = {}, []

    def attempt(name, fn):
        try:
            fn()
        except Exception:  # every run of the phase runs; the phase fails at its end
            failed.append(name)
            print(f"configs: {name} failed:\n{traceback.format_exc()}")
        torch.cuda.empty_cache()

    glob_conf = _config_variant(conf, use_global_encoder=True,
                                global_encoder="backbone = resnet34\nlatent_size = 128")
    five = _config_variant(conf, **{"encoder.num_layers": 5})
    custom = _config_variant(conf, **{"encoder.backbone": "custom"})
    for key, c, name, view, train, kw in (
        ("global", glob_conf, "srn.conf + a global encoder (d_latent 640)", GLOBAL_VIEW_LAUNCHES,
         (TRAIN_LAUNCHES, EVAL_LAUNCHES), {"cmp_dtypes": tuple(CMP_TOL)}),
        ("five-level", five, "srn.conf with num_layers 5 (d_latent 1024)", VIEW_LAUNCHES,
         (FUSED_TRAIN_LAUNCHES, FUSED_EVAL_LAUNCHES), {"fusion": True}),
        ("custom", custom, "srn.conf with backbone custom at 64x64", NEAREST_VIEW_LAUNCHES,
         (NEAREST_TRAIN_LAUNCHES, NEAREST_EVAL_LAUNCHES), {"size": 64}),
    ):
        size = kw.get("size", VIEW_SIZE)

        def both(key=key, c=c, name=name, view=view, train=train, kw=kw, size=size):
            watching, plain = _plain_watch()
            with watching():
                (runs[f"{key} view"],) = run_view(torch, np, dev, c, card, f"{key} view", view,
                                                  size=size, name=name)
                runs[f"{key} train"], runs[f"{key} eval"] = run_train(
                    torch, np, dev, c, card, f"{key} train", *train, name=name, **kw)
            print(f"{key}: plain versions on the card's tensors {plain}")
            if any(plain.values()):
                raise AssertionError(f"{key}: a plain version ran on the card: {plain}")

        attempt(key, both)
    _five_level_bounds()
    attempt("sn64", lambda: run_sn64(torch, np, dev, root, card))
    attempt("dtu", lambda: runs.update(
        {f"dtu {k}": v for k, v in run_dtu(torch, np, dev, root, card).items()}))
    if failed:
        raise AssertionError(f"configs: {failed} failed")
    return runs


def _five_level_bounds(d_latent: int = 1024):
    """The bounds of the field primal over a view (rows of CHUNK_SAMPLES
    samples of CHUNK_RAYS rays) and of its stash forward over a fused train
    step (FIELD_CALLS over SB x TRAIN_RAYS rays) at the five-level
    encoder's d_latent, from the code's shapes: the operations at the bf16
    peak (`field_flops`), or the bytes of xin, the grid, the weights, the
    output and the stash, whichever is larger (the levels' bf16 maps, under
    2 MB a view, left out)."""
    from pixelnerf_tpu_torch.ops.field import field_flops
    from pixelnerf_tpu_torch.ops.resnetfc_common import stash_layout

    per_point = field_flops(NS, D_IN, d_latent, HIDDEN, D_OUT, N_BLOCKS, COMBINE)
    n_inj = min(COMBINE, N_BLOCKS)
    wbytes = (D_IN * HIDDEN + n_inj * d_latent * HIDDEN + 2 * N_BLOCKS * HIDDEN * HIDDEN
              + HIDDEN * D_OUT) * 2
    io = lambda pts: pts * NS * (D_IN * 2 + 2 * 4) + pts * D_OUT * 4 + wbytes
    k, m = stash_layout(N_BLOCKS, COMBINE, NS)
    view_pts = CHUNK_RAYS * sum(CHUNK_SAMPLES.values())
    step_pts = SB * TRAIN_RAYS * sum(FIELD_CALLS.values())
    stash = step_pts * (NS * d_latent + 2 * k * NS * HIDDEN + (2 * m + 1) * HIDDEN) * 2
    view = _bound(per_point * view_pts, PEAK_BF16_FLOPS, io(view_pts))
    step = _bound(per_point * step_pts, PEAK_BF16_FLOPS, io(step_pts) + stash)
    print(f"five-level: bounds at d_latent {d_latent} from the code's shapes: the field primal "
          f"{view[0]:.3f} ms a view ({view[1]}), its stash forward {step[0]:.3f} ms a fused step "
          f"({step[1]})")
    return view, step


# the sharded step: bench.py's batch (injected rays, perturb 0) over
# (data, rays) meshes of ranks that share the one card through gloo, and a
# world of one on NCCL; each rank takes its block of objects and rays
SHARD_MESHES = (("data:2", 2), ("data:1,rays:2", 2), ("data:2,rays:2", 4))
SHARD_TIMED = 3  # timed steps a rank after its counted one
RANK_TIMEOUT = 300.0  # seconds a spawned world may take, its start included
# the remat phase: the cached and the fused flagship steps with remat on
# and off. A remat step runs each query twice (posenc, the gather, the
# primal, then in the backward the stash forward and the backward)
REMAT_TRAIN_LAUNCHES = _launch_table(
    posenc_concat=4, pyramid_gather=4, pyramid_scatter_add=2, resnetfc_fwd=3,
    resnetfc_fwd_stash=3, resnetfc_bwd=3,
)
REMAT_FUSED_LAUNCHES = _launch_table(
    posenc_concat=4, pyramid_field_fused=2, pyramid_field_fused_fwd_stash=2,
    pyramid_field_fused_bwd=2,
)
REMAT_TIMED = 5
# the mesh CLI: 4 train objects over data:2 (-B 4: 2 a rank, one batch an
# epoch), 2 val and test objects
MESH_CLI_STAGES = (("train", 4), ("val", 2), ("test", 2))


def _shard_setup(torch, np, dev, root, workdir):
    """bench.py's batch with injected rays and the seeded flagship's
    weights, written to `workdir` for the ranks to read."""
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.train.step import sample_rays
    from pixelnerf_tpu_torch.utils import hocon

    conf = hocon.load(str(root / "conf" / "exp" / "srn.conf"))
    batch = {k: v.cpu() for k, v in _train_batch(torch, np, dev, SB).items()}
    rng = np.random.default_rng(9)
    pix = rng.integers(0, NV * TRAIN_SIZE * TRAIN_SIZE, size=(SB, TRAIN_RAYS))
    batch["rays"], batch["rgb_gt"] = sample_rays(
        batch["images"], batch["poses"], batch["focal"], batch["c"], 0.8, 1.8, TRAIN_RAYS,
        draws={"pix": torch.from_numpy(pix)},
    )
    model = make_model(conf["model"], device="cpu", seed=0, train=True)
    model.init_shapes(batch["images"])
    shape_heads(torch, model)
    torch.save(batch, Path(workdir) / "batch.pt")
    torch.save(model.state_dict(), Path(workdir) / "init.pt")


def _sharded_step(torch, dev, root, workdir, mesh, label, objects=None):
    """One counted flagship train step from `workdir`'s weights, on this
    rank's shard with `mesh`, else on `objects` (a slice) of the batch, then
    SHARD_TIMED timed ones. Returns the first step's losses, gradients and
    state (on the host), its launches, the timed steps' ms and the peak
    device memory."""
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.parallel import shard_batch
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.train.step import make_optimizer, make_train_step
    from pixelnerf_tpu_torch.utils import hocon

    conf = hocon.load(str(root / "conf" / "exp" / "srn.conf"))
    batch = torch.load(Path(workdir) / "batch.pt")
    batch = shard_batch(batch, mesh) if mesh is not None else {
        k: v[objects if objects is not None else slice(None)] for k, v in batch.items()}
    batch = {k: v.to(dev) for k, v in batch.items()}
    model = make_model(conf["model"], device=dev, seed=0, train=True)
    model.init_shapes(batch["images"])
    model.load_state_dict(torch.load(Path(workdir) / "init.pt"))
    rcfg = RendererConfig.from_conf(conf["renderer"]).replace(perturb=0.0, noise_std=0.0)
    step = make_train_step(model, rcfg, make_optimizer(model, 1e-4), batch["rays"].shape[1],
                           0.8, 1.8, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(7)
    torch.cuda.reset_peak_memory_stats()
    aux, launches = _counted(torch, lambda: step(batch, gen), TRAIN_LAUNCHES, label)
    out = {
        "aux": {k: v.item() for k, v in aux.items()},
        "grads": {n: p.grad.float().cpu() for n, p in model.named_parameters()},
        "state": {k: v.cpu() for k, v in model.state_dict().items()},
        "launches": launches,
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SHARD_TIMED):
        step(batch, gen)
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) / SHARD_TIMED * 1e3
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def _rank_device(torch, rank):
    """A spawned rank's card: LOCAL_RANK % device_count, so every rank of a
    world on one card shares it."""
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _shard_rank(rank, root, workdir, worlds):
    """A spawned rank of the sharded phase. `worlds`, (label, axes, n)
    triples, run in turn on the first n ranks (a subgroup; the others
    wait at a barrier), so that one start of the processes serves every
    mesh. Returns this rank's result of each world it was in, else None."""
    import torch
    import torch.distributed as dist

    from pixelnerf_tpu_torch.parallel import make_mesh

    dev = _rank_device(torch, rank)
    out = []
    for label, axes, n in worlds:
        group = dist.new_group(list(range(n)))  # every rank makes every group
        out.append(_sharded_step(torch, dev, root, workdir, make_mesh(axes, rank, group),
                                 f"{label} rank {rank}") if rank < n else None)
        dist.barrier()
    return out


def _held_to_reference(label, got, ref, tol):
    """Loss and gradients of a sharded step against the reference's: the
    losses' relative error, each parameter group's worst relative
    Frobenius error (`compare_step`'s groups and CMP_TOL's bf16 bounds)."""
    rel = abs(got["aux"]["t"] - ref["t"]) / abs(ref["t"])
    worst = {}
    for n, g in ref["grads"].items():
        err = ((got["grads"][n] - g).norm() / (g.norm() + 1e-30)).item()
        part = "encoder" if n.startswith("encoder") else "head"
        worst[part] = max(worst.get(part, (-1.0, "")), (err, n))
        if not math.isfinite(err) or err > tol[part]:
            raise AssertionError(f"{label}: gradient {n} relative error {err:.3e} > {tol[part]}")
    if not rel <= tol["loss"]:
        raise AssertionError(f"{label}: loss {got['aux']['t']} vs {ref['t']} (rel {rel:.3e})")
    return rel, worst


def run_sharded(torch, np, dev, root, card):
    """The sharded flagship step: the meshes of SHARD_MESHES in turn on
    subgroups of one world of four spawned ranks sharing the card (gloo, the
    backend rule's choice for ranks on one card), and a world of one on NCCL
    in this process. Every
    rank's state after the step must equal rank 0's bit for bit, and each
    rank launch the train path's kernels as the one-process step does. The
    reference is the one-process step on each data index's objects (all
    rays), its gradients and losses averaged over the data axis: the
    sharded step's math with its per-shard BatchNorm statistics, which
    differ from the whole batch's on the data axis. Its loss and gradients
    are held to CMP_TOL's bf16 bounds. Prints each rank's step time, peak
    memory and launches."""
    import tempfile

    import torch.distributed as dist

    from pixelnerf_tpu_torch.parallel import backend_for, make_mesh, parse_mesh_spec
    from pixelnerf_tpu_torch.parallel.launch import run_ranks

    tol = CMP_TOL["bfloat16"]
    with tempfile.TemporaryDirectory() as tmp:
        _shard_setup(torch, np, dev, root, tmp)
        whole = _sharded_step(torch, dev, root, tmp, None, "sharded: one-process step")
        print(f"sharded: one-process flagship step (SB={SB}, {TRAIN_RAYS} rays an object) "
              f"{whole['ms']:.1f} ms, peak device memory {whole['peak'] / 2**30:.2f} GiB; on {card}")
        refs = {}

        def reference(data):
            if data not in refs:
                n = SB // data
                parts = [whole] if data == 1 else [
                    _sharded_step(torch, dev, root, tmp, None, f"sharded: objects {d * n}:{(d + 1) * n}",
                                  slice(d * n, (d + 1) * n)) for d in range(data)]
                refs[data] = {
                    "t": sum(p["aux"]["t"] for p in parts) / data,
                    "grads": {k: sum(p["grads"][k] for p in parts) / data for k in whole["grads"]},
                }
            return refs[data]

        torch.cuda.empty_cache()  # the card's memory to the ranks
        count = torch.cuda.device_count()
        size = max(n for _, n in SHARD_MESHES)
        backend = backend_for("cuda", size, count)
        worlds = [(f"sharded {spec} ({backend})", parse_mesh_spec(spec, n), n) for spec, n in SHARD_MESHES]
        print(f"sharded: {size} ranks on {count} card(s): backend {backend}; the meshes "
              f"{[spec for spec, _ in SHARD_MESHES]} in turn on subgroups of them")
        t0 = time.perf_counter()
        spawned = run_ranks(_shard_rank, size, f"{tmp}/world", args=(root, tmp, worlds),
                            backend=backend, timeout=RANK_TIMEOUT)
        print(f"sharded: the {size} ranks took {time.perf_counter() - t0:.1f} s with their start")
        results = [(label, axes, [r[i] for r in spawned[:n]]) for i, (label, axes, n) in enumerate(worlds)]
        one = backend_for("cuda", 1, count)
        label = f"sharded world of one ({one})"
        print(f"{label}: 1 rank on {count} card(s), in this process: backend {one}")
        dist.init_process_group(one, init_method=f"file://{tmp}/one", rank=0, world_size=1)
        try:
            axes = parse_mesh_spec("", 1)
            results.append((label, axes, [_sharded_step(torch, dev, root, tmp, make_mesh(axes),
                                                        f"{label} rank 0")]))
        finally:
            dist.destroy_process_group()
        for label, axes, ranks in results:
            n = len(ranks)
            for r, res in enumerate(ranks):
                if not _tree_equal(torch, res["state"], ranks[0]["state"]):
                    raise AssertionError(f"{label}: rank {r}'s state differs from rank 0's")
                print(f"{label} rank {r}: step {res['ms']:.1f} ms (mean of {SHARD_TIMED}), peak "
                      f"device memory {res['peak'] / 2**30:.2f} GiB, launches "
                      f"{ {k: v for k, v in res['launches'].items() if v} }")
            rel, worst = _held_to_reference(label, ranks[0], reference(axes["data"]), tol)
            print(
                f"{label}: {n} ranks' states bit-equal; loss {ranks[0]['aux']['t']:.6f} vs the "
                f"reference {refs[axes['data']]['t']:.6f} (rel {rel:.2e}, tolerance {tol['loss']}); "
                "worst relative gradient errors: " + ", ".join(
                    f"{part} {e:.2e} ({name}, tolerance {tol[part]})"
                    for part, (e, name) in sorted(worst.items()))
                + f"; on {card}"
            )


def _cli_rank(rank, root, argv, card):
    """A spawned rank of the mesh CLI: `_train_cli` on the one card."""
    import torch

    dev = _rank_device(torch, rank)
    res = _train_cli(torch, dev, f"mesh cli rank {rank}", argv, card)
    return {k: res[k] for k in ("launches", "parts", "peak", "wall", "step_s", "resumed")}


def run_mesh_cli(torch, np, root, card):
    """`train_pixelnerf --mesh data:2` on two spawned ranks sharing the
    card (gloo): srn.conf at full width, -B 4 -V 2 -R 1024, 2 epochs then
    --resume to a third, each rank through `_train_cli` (launches from 0,
    plain versions watched, the resume held to the files). Rank 0 writes
    the checkpoint and visuals, rank 1 nothing."""
    import statistics
    import tempfile

    from pixelnerf_tpu_torch.parallel.launch import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        datadir = _write_srn_dataset(np, tmp, name="mesh", stages=MESH_CLI_STAGES)
        conf = Path(tmp) / "cli.conf"
        conf.write_text(CLI_CONF.format(srn=root / "conf" / "exp" / "srn.conf"))
        argv = ["-c", str(conf), "-D", datadir, "-n", "mesh", "--logs_path", f"{tmp}/logs",
                "--checkpoints_path", f"{tmp}/ckpt", "--visual_path", f"{tmp}/vis",
                "--mesh", "data:2"] + CLI_ARGS
        t0 = time.perf_counter()
        ranks = run_ranks(_cli_rank, 2, f"{tmp}/world", args=(root, argv, card), timeout=RANK_TIMEOUT)
        wall = time.perf_counter() - t0
        files = sorted(p.name for p in (Path(tmp) / "ckpt" / "mesh").iterdir())
        vis = sorted(p.name for p in (Path(tmp) / "vis" / "mesh").glob("*_vis.png"))
    for name in ("pixel_nerf_latest", "_optim", "_iter.json"):
        if name not in files:
            raise AssertionError(f"mesh cli: checkpoint file {name} missing ({files})")
    if not vis:
        raise AssertionError("mesh cli: rank 0 wrote no visuals")
    for r, res in enumerate(ranks):
        # rank 0 also renders the vis view (the field primal); rank 1 does not
        want = CLI_KERNELS if r == 0 else tuple(k for k in CLI_KERNELS if k != "pyramid_field_fused")
        missing = [k for k in want if res["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"mesh cli rank {r}: never launched {missing}")
        print(f"mesh cli rank {r}: step median {statistics.median(res['step_s'][1:]) * 1e3:.1f} ms "
              f"(2 objects x {TRAIN_RAYS} rays), peak device memory {res['peak'] / 2**30:.2f} GiB, "
              f"resumed {res['resumed']}")
    print(f"mesh cli: --mesh data:2 on 2 ranks sharing the card (gloo), 2 epochs and a resume in "
          f"{wall:.1f} s with the ranks' start; rank 0 wrote {files} and {len(vis)} vis PNGs; on {card}")


def run_remat(torch, np, dev, root, card):
    """The cached and the fused flagship steps with remat on and off, from
    the same weights on bench.py's batch with injected rays: launches (each
    query twice, the primal first), step time and peak memory. The remat
    step's loss and gradients are held within the spread of two runs of
    the plain step (the scatters' and the products' float32 atomics are
    not bit-reproducible): each group's relative error at most 3x that
    spread, plus 1e-4 (the loss 1e-5)."""
    import tempfile

    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.train.step import make_optimizer, make_train_step
    from pixelnerf_tpu_torch.utils import hocon

    conf = hocon.load(str(root / "conf" / "exp" / "srn.conf"))
    rcfg = RendererConfig.from_conf(conf["renderer"]).replace(perturb=0.0, noise_std=0.0)
    with tempfile.TemporaryDirectory() as tmp:
        _shard_setup(torch, np, dev, root, tmp)
        batch = {k: v.to(dev) for k, v in torch.load(Path(tmp) / "batch.pt").items()}
        init = torch.load(Path(tmp) / "init.pt")
    model = make_model(conf["model"], device=dev, seed=0, train=True)
    model.init_shapes(batch["images"])
    gen = torch.Generator(device=dev).manual_seed(7)
    for fused, expected in ((False, REMAT_TRAIN_LAUNCHES), (True, REMAT_FUSED_LAUNCHES)):
        path = "fused" if fused else "cached"
        stepped = model.with_field_fusion() if fused else model
        runs = {}
        for remat, name in ((False, "plain"), (False, "plain again"), (True, "remat")):
            model.load_state_dict(init)
            step = make_train_step(stepped, rcfg, make_optimizer(model, 1e-4), TRAIN_RAYS, 0.8, 1.8,
                                   remat=remat)
            want = expected if remat else (FUSED_TRAIN_LAUNCHES if fused else TRAIN_LAUNCHES)
            aux, launches = _counted(torch, lambda: step(batch, gen), want, f"remat {path} {name}")
            runs[name] = {"t": aux["t"].item(),
                          "grads": {n: p.grad.float().clone() for n, p in model.named_parameters()}}
            if name == "plain again":
                continue
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(REMAT_TIMED):
                step(batch, gen)
            torch.cuda.synchronize()
            runs[name]["ms"] = (time.perf_counter() - t0) / REMAT_TIMED * 1e3
            runs[name]["peak"] = torch.cuda.max_memory_allocated()
        rel = lambda a, b: ((a - b).norm() / (b.norm() + 1e-30)).item()
        base = runs["plain"]
        spread, diff = {}, {}
        for n, g in base["grads"].items():
            part = "encoder" if n.startswith("encoder") else "head"
            spread[part] = max(spread.get(part, 0.0), rel(runs["plain again"]["grads"][n], g))
            diff[part] = max(diff.get(part, 0.0), rel(runs["remat"]["grads"][n], g))
        loss_spread = abs(runs["plain again"]["t"] - base["t"]) / abs(base["t"])
        loss_diff = abs(runs["remat"]["t"] - base["t"]) / abs(base["t"])
        print(
            f"remat {path}: step {base['ms']:.1f} ms plain, {runs['remat']['ms']:.1f} ms remat "
            f"({runs['remat']['ms'] / base['ms']:.2f}x); peak device memory "
            f"{base['peak'] / 2**30:.2f} GiB plain, {runs['remat']['peak'] / 2**30:.2f} GiB remat; "
            f"loss rel {loss_diff:.2e} (plain run to run {loss_spread:.2e}); worst relative gradient "
            "error remat vs plain " + ", ".join(f"{p} {diff[p]:.2e} (run to run {spread[p]:.2e})"
                                                 for p in sorted(diff)) + f"; on {card}"
        )
        if loss_diff > 3 * loss_spread + 1e-5 or any(diff[p] > 3 * spread[p] + 1e-4 for p in diff):
            raise AssertionError(f"remat {path}: the remat step leaves the plain step's spread")


def run_tools(torch, np, dev, root, card):
    """`tools/profile_step` through its `main` at the flagship's shapes
    (2 profiled train steps after 2 warm ones) and `tools/trace_summary` on
    its trace, `tools/make_synthetic_dataset` (an SRN layout) and
    `tools/pose_sanity_check` on what it wrote, and `tools/export_checkpoint`
    on the trained artifact: import, export (the artifact again, byte for
    byte), import of that, and one 128x128 view of srn600.conf from it
    equal to the view from the artifact itself."""
    import tempfile

    from torch.autograd import DeviceType

    from pixelnerf_tpu_torch.eval.common import encode_views
    from pixelnerf_tpu_torch.eval.render_utils import render_full
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.tools import (
        export_checkpoint, make_synthetic_dataset, pose_sanity_check, profile_step, trace_summary,
    )
    from pixelnerf_tpu_torch.utils import checkpoint as ckpt
    from pixelnerf_tpu_torch.utils import hocon
    from pixelnerf_tpu_torch.utils.rays import gen_rays

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        prof = profile_step.main(["-c", str(root / "conf" / "exp" / "srn.conf"), "--out", tmp,
                                  "--steps", "2"], device=dev)
        trace = Path(tmp) / "trace.json"
        busy = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if not trace.stat().st_size or not busy > 0:
            raise AssertionError("profile_step: no trace or no device time")
        print(f"profile_step: 2 flagship train steps, {busy / 1e3:.1f} ms of kernels, trace "
              f"{trace.stat().st_size / 1e6:.1f} MB in {time.perf_counter() - t0:.1f} s; on {card}")
        where, total_ms, buckets, _ = trace_summary.main(["--logdir", tmp, "--steps", "2", "--top", "8"])
        if where != "cuda" or not total_ms > 0 or not buckets.get("block chains", 0) > 0:
            raise AssertionError("trace_summary: no device time in the chains' bucket")
        print(f"trace_summary: {total_ms:.1f} ms of device time in the trace, "
              f"{buckets['block chains'] / total_ms:.1%} in the block chains; on {card}")

        data = f"{tmp}/synthetic"
        make_synthetic_dataset.main(["--out", data, "--n_objs", "10", "--n_views", "6", "--size", "64"])
        bad = pose_sanity_check.main(["--datadir", f"{data}/shapes", "--num_objects", "3",
                                      "--num_views", "6", "--diagnostics"])
        if bad != 0:
            raise AssertionError(f"pose_sanity_check: {bad} bad poses on make_synthetic_dataset's")
        print(f"make_synthetic_dataset, pose_sanity_check: 10 objects x 6 views written and "
              f"checked without JAX; on {card}")

        artifact = str(root / "artifacts" / "srn600_bf16.ckpt")
        live, again = f"{tmp}/live", f"{tmp}/again"
        export_checkpoint.main(["import", "--artifact", artifact, "--ckpt", live])
        export_checkpoint.main(["export", "--ckpt", live, "--out", f"{tmp}/art"])
        export_checkpoint.main(["import", "--artifact", f"{tmp}/art", "--ckpt", again])
        if Path(f"{tmp}/art").read_bytes() != Path(artifact).read_bytes():
            raise AssertionError("export_checkpoint: export of the import is not the artifact")
        conf = hocon.load(str(root / "conf" / "exp" / "srn600.conf"))
        rcfg = RendererConfig.from_conf(conf["renderer"]).replace(perturb=0.0)
        rng = np.random.default_rng(4)
        images = rng.uniform(-1, 1, size=(2, VIEW_SIZE, VIEW_SIZE, 3)).astype(np.float32)
        poses = np.stack([_look_at(np, [1.3, 0.2, 0.1]), _look_at(np, [0.2, 0.3, 1.3])])
        focal = 131.25 * VIEW_SIZE / 128
        target = torch.from_numpy(_look_at(np, [0.9, 0.4, 0.9])[None]).to(dev)
        rays = gen_rays(target, VIEW_SIZE, VIEW_SIZE, focal, 0.8, 1.8).reshape(-1, 8)
        views = []
        for path in (artifact, again):
            model = make_model(conf["model"], device=dev, seed=0)
            ckpt.load_weights_file(model, path)
            views.append(render_full(model, encode_views(model, images, poses, focal), rays, rcfg))
    rgb = [v["fine"]["rgb"] for v in views]
    if not torch.equal(rgb[0], rgb[1]) or not torch.isfinite(rgb[0]).all():
        raise AssertionError("export_checkpoint: the round trip's view differs from the artifact's")
    print(f"export_checkpoint: import, export (the artifact byte for byte), import; one "
          f"{VIEW_SIZE}x{VIEW_SIZE} srn600.conf view from it equal to the artifact's; on {card}")


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--baseline", metavar="DIR",
        help="an earlier tree of the repository: time its lookup kernels, posenc, field "
        "backward, layered products and train step beside the port's",
    )
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from pixelnerf_tpu_torch.models import pixelnerf
    from pixelnerf_tpu_torch.ops import field, pyramid, scatter
    from pixelnerf_tpu_torch.ops.cuda_build import SOURCES, build_libraries
    from pixelnerf_tpu_torch.utils import hocon

    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    base_builds = None if args.baseline is None else _baseline_build(args.baseline)
    logs = build_libraries(SOURCES)
    print(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for name, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            # C7519: ptxas's note on each wgmma accumulator fence it adds
            elif any(w in line for w in ("Used", "spill", "smem")) and "C7519" not in line:
                print(f"build: {name}: {fn}: {line.strip()}")

    baseline = None
    if base_builds is not None:
        baseline = _baseline_kernels(torch, base_builds)
        baseline["posenc_concat"] = _baseline_posenc(torch, args.baseline, base_builds)

    kernels = [check_field(torch, np, dev)] + check_resnetfc(torch, np, dev)
    torch.cuda.empty_cache()
    wide = check_wide_latent(torch, np, dev)
    for k in kernels:
        k.update(wide.get(k["name"], {}))
    torch.cuda.empty_cache()
    kernels += check_layered(torch, np, dev, baseline)
    torch.cuda.empty_cache()

    # posenc is checked and timed after the counted view, the lookups after
    # the counted train step (and the bilerp gather after the counted
    # nearest view), the field's backward after the counted fused step,
    # whose arguments they are given again
    conf = hocon.load(str(root / "conf" / "exp" / "srn.conf"))
    nearest = _nearest(conf)
    kept = {name: [] for name in ("pyramid_gather", "pyramid_scatter_add", "bilerp_gather",
                                  "bilerp_scatter_add", "posenc_concat", "pyramid_field_fused_bwd")}
    view_calls = []
    runs = run_view(torch, np, dev, conf, card, "slice", VIEW_LAUNCHES,
                    keep=[(pixelnerf, "posenc_concat", kept["posenc_concat"])])
    kernels.append(check_posenc(torch, dev, kept["posenc_concat"], baseline))
    times = {}
    runs += run_train(torch, np, dev, conf, card, "train", TRAIN_LAUNCHES, EVAL_LAUNCHES,
                      cmp_dtypes=tuple(CMP_TOL), times=times,
                      base_step=None if args.baseline is None else _baseline_step(args.baseline),
                      keep=[(pyramid, name, kept[name])
                            for name in ("pyramid_gather", "pyramid_scatter_add")])
    kernels += check_pyramid(torch, np, dev, kept, baseline)
    torch.cuda.empty_cache()
    runs += run_train(torch, np, dev, conf, card, "fused train", FUSED_TRAIN_LAUNCHES,
                      FUSED_EVAL_LAUNCHES, fusion=True,
                      keep=[(field, "pyramid_field_fused_bwd", kept["pyramid_field_fused_bwd"],
                             ("grid", "g"))])
    kernels += check_field_vjp(torch, np, dev, kept["pyramid_field_fused_bwd"], baseline)
    torch.cuda.empty_cache()
    runs += run_view(torch, np, dev, nearest, card, "nearest slice", NEAREST_VIEW_LAUNCHES,
                     keep=[(scatter, "bilerp_gather", view_calls)])
    runs += run_train(torch, np, dev, nearest, card, "nearest train", NEAREST_TRAIN_LAUNCHES,
                      NEAREST_EVAL_LAUNCHES,
                      keep=[(scatter, name, kept[name])
                            for name in ("bilerp_gather", "bilerp_scatter_add")])
    kernels += check_bilerp(torch, np, dev, kept, view_calls, baseline)
    torch.cuda.empty_cache()
    run_cli(torch, np, dev, root, card, times["train"])
    torch.cuda.empty_cache()
    serve = run_serving_clis(torch, np, dev, root, card)
    torch.cuda.empty_cache()
    configs = run_configs(torch, np, dev, root, card, conf)
    torch.cuda.empty_cache()
    run_sharded(torch, np, dev, root, card)
    torch.cuda.empty_cache()
    run_mesh_cli(torch, np, root, card)
    run_remat(torch, np, dev, root, card)
    torch.cuda.empty_cache()
    run_tools(torch, np, dev, root, card)
    torch.cuda.empty_cache()
    runs += run_wide(torch, np, dev, conf, card)
    torch.cuda.empty_cache()
    runs += run_views80(torch, np, dev, conf, card)
    for k in kernels:
        if k["name"] in SERVE_KERNELS:
            k["serve_launches"] = {cli: n[k["name"]] for cli, n in serve.items()}
        k["config_launches"] = {run: n[k["name"]] for run, n in configs.items() if n[k["name"]]}
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
