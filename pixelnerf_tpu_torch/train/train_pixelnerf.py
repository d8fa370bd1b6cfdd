"""PixelNeRF training CLI.

Counterpart of `pixelnerf_tpu/train/train_pixelnerf.py`, the reference's
train/train.py: the same flags (-n/-c/-D/-B/-V/-R/--no_bbox_step/
--freeze_enc/--mesh/--remat/...), the same loss (lambda_coarse *
MSE_coarse + lambda_fine * MSE_fine, train.py:271-283), bbox-sampling
schedule and NS in `nviews` random source-view selection
(train.py:193-241), the sample-count and lr schedules, and the vis_step
grid (source | gt | depth | rgb | alpha rows per head,
train.py:294-437). The host draws (views, batch order, vis choices) come
from the JAX CLI's numpy generators and seeds, so they are the same
arrays; the device draws come from one `torch.Generator` seeded once,
which is not checkpointed (the JAX CLI does not checkpoint its key).

One process trains on one device, CUDA unless `main` is given another.
With `--mesh data:a,rays:b` (or under a launcher that sets WORLD_SIZE >
1, which the empty spec puts all on `rays`) every process is one rank of
a `parallel.Mesh` over `torch.distributed`: the world size must equal
a*b, rank r uses cuda:LOCAL_RANK % device_count, its loader holds the
interleaved shard of the data index (`BatchLoader(num_shards=a,
shard_id=data index)`), it samples R/b rays an object, and the step
averages gradients, BatchNorm statistics and losses over the world.
`-B` stays the global object batch: a rank takes ceil(B/a) objects. Every
shard holds the same number of objects, so the ranks' batches, partial
ones included, are equal in size and need none of the JAX CLI's
wrap-padding. Only rank 0 writes checkpoints, tensorboard scalars and
visuals; `--resume` loads on every rank. The process group is the one
the caller made, else one made from the environment (`torchrun`) with
the backend `parallel.backend_for` names: NCCL when every local rank
has a card of its own, gloo when ranks share one or run on the CPU.

Run:
    python -m pixelnerf_tpu_torch.train.train_pixelnerf -n srn_car -c conf/exp/srn.conf \
        -D /data/cars -V 1 2 -B 4 -R 128
    torchrun --nproc_per_node 4 -m pixelnerf_tpu_torch.train.train_pixelnerf -n srn_car \
        -c conf/exp/srn.conf -D /data/cars -B 8 -R 1024 --mesh data:2,rays:2

or, from Python, `main(argv, device="cpu")` on the CPU.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np


def extra_args(parser):
    parser.add_argument(
        "--batch_size", "-B", type=int, default=4,
        help="Object batch size ('SB'), over all ranks: with --mesh "
        "data:a,rays:b each rank takes ceil(B/a) objects"
    )
    parser.add_argument(
        "--nviews", "-V", type=str, default="2",
        help="Number of source views; multiple (space delim) to pick randomly",
    )
    parser.add_argument(
        "--gamma_delay", type=int, default=0,
        help="Epochs to wait before applying gamma decay",
    )
    parser.add_argument(
        "--freeze_enc", action="store_true", default=None,
        help="Freeze encoder weights and only train MLP",
    )
    parser.add_argument(
        "--no_bbox_step", type=int, default=100000,
        help="Step to stop using bbox sampling",
    )
    parser.add_argument("--fixed_test", action="store_true", default=None)
    parser.add_argument(
        "--vis_chunk", type=int, default=16384,
        help="Ray chunk for full-image visualization renders",
    )
    parser.add_argument(
        "--warmup_epochs", type=int, default=0,
        help="Freeze the encoder for the first N epochs, then unfreeze "
        "(the reference's finetune_resnet.py staged warmup)",
    )
    # --image_size lives on the COMMON parser (utils/config.py) so the
    # eval CLIs share it
    parser.add_argument(
        "--vis_debug", action="store_true",
        help="At each vis interval also write a sigma z=0-slice heatmap "
        "under visuals/<exp>/vis_debug (the fork's per-step debug "
        "figures, reference train/train.py:403-433)",
    )
    parser.add_argument(
        "--cache_images", action="store_true",
        help="Cache decoded per-object images in RAM (uint8) so epochs "
        "after the first skip image decode; ignored (with a warning) when "
        "the dataset applies per-epoch augmentation",
    )
    parser.add_argument(
        "--spmd_mode", choices=("shard_map", "gspmd"), default="shard_map",
        help="The JAX CLI's multi-device mode. Both run the same "
        "torch.distributed path here, each rank running the kernels on its "
        "shard (GSPMD exists in JAX only because it cannot split a "
        "pallas_call)",
    )
    parser.add_argument(
        "--remat", action="store_true", default=False,
        help="Rematerialize the field evaluation in backward (always; by "
        "default only when a field MLP leaves the fused kernels)",
    )
    parser.add_argument(
        "--no_compact_transfer", action="store_true", default=False,
        help="Copy full f32 batches to the device instead of the uint8 "
        "compact batch (bit-exact for composited/resized images, ~5x more "
        "host->device bytes)",
    )
    return parser


def lr_schedule(lr: float, gamma: float, gamma_delay: int, steps_per_epoch: int):
    """The learning rate as a function of the optimizer's update count:
    per-epoch gamma decay after `gamma_delay` epochs, an epoch being
    `steps_per_epoch` updates (the JAX CLI's optax schedule)."""

    def schedule(count: int) -> float:
        if gamma == 1.0:
            return lr
        return lr * gamma ** max(count // steps_per_epoch - gamma_delay, 0)

    return schedule


def _mesh_and_device(args, dev, chosen: bool):
    """(Mesh or None, this rank's device, whether this call made the
    process group). `dev` is the resolved device; unless the caller chose
    it (`chosen`), a rank takes cuda:LOCAL_RANK % device_count."""
    import torch
    import torch.distributed as dist

    from pixelnerf_tpu_torch.parallel import init_distributed, make_mesh, parse_mesh_spec, world_size

    if not args.mesh and world_size() == 1:
        return None, dev, False
    axis_sizes = parse_mesh_spec(args.mesh)  # raises unless the world fits
    if dev.type == "cuda" and not chosen:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    owns_group = not dist.is_initialized()
    if owns_group:
        init_distributed(dev.type)
    mesh = make_mesh(axis_sizes)
    print(f"Using mesh {mesh.shape}: rank {mesh.rank} at data {mesh.data_index}, "
          f"rays {mesh.rays_index} on {dev}")
    return mesh, dev, owns_group


def make_trainer(argv=None, device=None):
    """Parse `argv`, build the datasets, loaders, model and optimizer, load
    the checkpoint the flags ask for and return the trainer, not started.
    With `--mesh`, joins (or makes) the process group first."""
    import torch

    from pixelnerf_tpu_torch.data import (
        BatchLoader, ColorJitterDataset, get_split_dataset, make_step_batch, to_device,
    )
    from pixelnerf_tpu_torch.device import resolve_device
    from pixelnerf_tpu_torch.eval.render_utils import render_full
    from pixelnerf_tpu_torch.models.losses import alpha_loss_from_conf, rgb_loss_from_conf
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.native import imagecodec
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.train.step import (
        MultiSteps, make_eval_step, make_optimizer, make_train_step,
    )
    from pixelnerf_tpu_torch.train.trainer import Trainer
    from pixelnerf_tpu_torch.utils import checkpoint as ckpt_io
    from pixelnerf_tpu_torch.utils import config as util_config
    from pixelnerf_tpu_torch.utils import metrics
    from pixelnerf_tpu_torch.utils.rays import gen_rays
    from pixelnerf_tpu_torch.utils.visualize import cmap, hstack_images, vstack_images, write_png

    dev = resolve_device(device)
    args, conf = util_config.parse_args(
        extra_args, training=True, default_ray_batch_size=128, argv=argv
    )
    mesh, dev, owns_group = _mesh_and_device(args, dev, device is not None)
    is_main = mesh is None or mesh.rank == 0
    data_shards = mesh.data if mesh is not None else 1
    data_index = mesh.data_index if mesh is not None else 0
    local_batch = -(-args.batch_size // data_shards)
    rays_per_shard = max(1, args.ray_batch_size // mesh.rays) if mesh is not None else args.ray_batch_size
    nviews = list(map(int, args.nviews.split()))

    dset_kwargs = {"image_size": tuple(args.image_size)} if args.image_size else {}
    dset, val_dset, _ = get_split_dataset(args.dataset_format, args.datadir, **dset_kwargs)
    print(f"dset z_near {dset.z_near}, z_far {dset.z_far}, lindisp {dset.lindisp}")
    print("image decoder:", imagecodec.decoder())

    model = make_model(conf["model"], device=dev, train=True,
                       stop_encoder_grad=bool(args.freeze_enc))
    if args.freeze_enc:
        print("Encoder frozen")
    # the warmup's steps train a shallow copy that shares every parameter
    # with the encoder's gradient stopped (reference
    # train/finetune_resnet.py:89-157); eval and vis keep `model`
    model_frozen = None
    if args.warmup_epochs > 0:
        model_frozen = copy.copy(model)
        model_frozen.stop_encoder_grad = True

    rcfg0 = RendererConfig.from_conf(conf["renderer"], lindisp=dset.lindisp)

    loss_conf = conf.get_config("loss")
    lambda_coarse = loss_conf.get_float("lambda_coarse", 1.0)
    lambda_fine = loss_conf.get_float("lambda_fine", 1.0)
    rgb_loss = rgb_loss_from_conf(loss_conf.get_config("rgb"), coarse=True)
    rgb_fine_loss = rgb_loss_from_conf(
        loss_conf.get_config("rgb_fine", loss_conf.get_config("rgb")), coarse=False
    )
    # NV2 opacity regularizer on the finest head's alpha from its epoch on
    alpha_loss, alpha_init_epoch = alpha_loss_from_conf(loss_conf.get_config("alpha", None))
    if alpha_loss is not None:
        print(f"Alpha loss active from epoch {alpha_init_epoch}")

    cache_images = args.cache_images
    if cache_images and isinstance(dset, ColorJitterDataset):
        print(
            "WARNING: --cache_images disabled: dataset applies per-epoch "
            "color jitter which a cache would freeze"
        )
        cache_images = False
    train_loader = BatchLoader(dset, local_batch, shuffle=True, seed=0, num_shards=data_shards,
                               shard_id=data_index, cache_images=cache_images)
    test_loader = BatchLoader(val_dset, -(-min(args.batch_size, 16) // data_shards), shuffle=True,
                              seed=1, num_shards=data_shards, shard_id=data_index)

    # the JAX CLI draws one batch to initialize its model; drawing it here
    # too keeps the datasets' own generators (DVR view subsets, colour
    # jitter) in step with it, and makes the parameters whose shapes follow
    # the input before the optimizer takes them
    model.init_shapes(torch.from_numpy(
        next(iter(BatchLoader(dset, args.batch_size, shuffle=False, prefetch=False)))["images"]))
    ckpt_io.load_model_weights(model, args.checkpoints_path, args.name, resume=args.resume)
    if mesh is not None:
        # replicated from the start: rank 0's weights everywhere
        import torch.distributed as dist

        for t in model.state_dict().values():
            dist.broadcast(t, 0, group=mesh.group)

    # ------- optimizer: per-epoch gamma decay expressed per update ---------
    steps_per_epoch = max(len(train_loader), 1) * conf.get_int("train.num_epoch_repeats", 1)
    accu_grad = conf.get_int("train.accu_grad", 1)

    optimizer = MultiSteps(
        make_optimizer(model, args.lr), accu_grad,
        lr_schedule(args.lr, args.gamma, args.gamma_delay, steps_per_epoch),
    )

    def steps(rcfg, use_bbox: bool, frozen: bool, alpha_active: bool):
        t_step = make_train_step(
            model_frozen if frozen else model, rcfg, optimizer, num_rays=rays_per_shard,
            z_near=dset.z_near, z_far=dset.z_far,
            lambda_coarse=lambda_coarse, lambda_fine=lambda_fine,
            rgb_loss_fn=rgb_loss, rgb_fine_loss_fn=rgb_fine_loss, use_bbox=use_bbox,
            alpha_loss_fn=(lambda a: alpha_loss(a, alpha_init_epoch)) if alpha_active else None,
            remat=True if args.remat else "auto", mesh=mesh, nviews=max(nviews),
        )
        e_step = make_eval_step(
            model, rcfg, num_rays=rays_per_shard, z_near=dset.z_near, z_far=dset.z_far,
            lambda_coarse=lambda_coarse, lambda_fine=lambda_fine, mesh=mesh,
        )
        return t_step, e_step

    class PixelNeRFTrainer(Trainer):
        def __init__(self):
            super().__init__(model, optimizer, train_loader, test_loader, args, conf,
                             is_main=is_main)
            self.device = dev
            self.mesh = mesh
            self.owns_group = owns_group
            self.host_rng = np.random.default_rng(42)
            self.generator = torch.Generator(device=dev)
            self.generator.manual_seed(99)
            self.use_bbox = args.no_bbox_step > 0
            self.renderer_state_path = os.path.join(
                args.checkpoints_path, args.name, "_renderer.json"
            )
            self.warmup_steps = args.warmup_epochs * steps_per_epoch
            if self.warmup_steps:
                print(f"Encoder frozen for {self.warmup_steps} steps ({args.warmup_epochs} epochs)")

        def _device_batch(self, data, global_step, train=True):
            if train and self.use_bbox and global_step >= args.no_bbox_step:
                self.use_bbox = False
                print(">>> Stopped using bbox sampling @ iter", global_step)
            batch = make_step_batch(
                data, self.host_rng, nviews,
                use_bbox=self.use_bbox if train else False,
                compact_transfer=not args.no_compact_transfer,
            )
            return to_device(batch, dev)

        def train_step(self, data, global_step):
            if "images" not in data:
                return {}
            rcfg = rcfg0.at_iteration(global_step)
            frozen = bool(self.warmup_steps) and global_step < self.warmup_steps
            if self.warmup_steps and global_step == self.warmup_steps:
                print("Warmup complete: unfreezing encoder")
            alpha_active = (
                alpha_loss is not None and global_step // steps_per_epoch >= alpha_init_epoch
            )
            t_step, _ = steps(rcfg, self.use_bbox and "bbox" in data, frozen, alpha_active)
            batch = self._device_batch(data, global_step, train=True)
            # device scalars: the Trainer converts them at its intervals
            return t_step(batch, self.generator)

        def eval_step(self, data, global_step):
            if "images" not in data:
                return {}
            _, e_step = steps(rcfg0.at_iteration(global_step), False, False, False)
            return e_step(self._device_batch(data, global_step, train=False), self.generator)

        @torch.no_grad()
        def vis_step(self, data, global_step, idx=None):
            if "images" not in data:
                return None, None
            batch_idx = (
                self.host_rng.integers(0, data["images"].shape[0]) if idx is None else idx
            )
            images = data["images"][batch_idx]  # (NV, H, W, 3)
            poses = data["poses"][batch_idx]
            focal = np.asarray(data["focal"][batch_idx]).reshape(-1)[0]
            c = data.get("c")
            c = np.asarray(c[batch_idx]) if c is not None else None
            NV, H, W = images.shape[:3]

            curr_nviews = nviews[self.host_rng.integers(0, len(nviews))]
            views_src = np.sort(self.host_rng.choice(NV, curr_nviews, replace=False))
            view_dest = int(self.host_rng.integers(0, NV - curr_nviews))
            for vs in range(curr_nviews):
                view_dest += view_dest >= views_src[vs]
            if not self.is_main:
                return None, None  # the draws above keep every rank's host_rng in step

            images_0to1 = images * 0.5 + 0.5
            source_views = images_0to1[views_src]
            gt = images_0to1[view_dest]

            t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
            c_t = t(c) if c is not None else None
            cam_rays = gen_rays(
                t(poses[view_dest : view_dest + 1]), W, H, float(focal), dset.z_near, dset.z_far,
                c=c_t,
            ).reshape(-1, 8)

            model.eval()
            enc = model.encode(
                t(images[None, views_src]), t(poses[None, views_src]),
                t(np.reshape(focal, 1)), c_t[None] if c_t is not None else None,
            )
            rcfg = rcfg0.at_iteration(global_step)
            out = render_full(model, enc, cam_rays, rcfg, chunk=args.vis_chunk, seed=global_step)
            out = {h: {k: v.float().cpu().numpy() for k, v in o.items()} for h, o in out.items()}

            def row(head):
                rgb = out[head]["rgb"].reshape(H, W, 3)
                depth = cmap(out[head]["depth"].reshape(H, W)) / 255.0
                alpha = cmap(out[head]["alpha"].reshape(H, W)) / 255.0
                return hstack_images([*source_views, gt, depth, rgb, alpha]), rgb

            vis_coarse, rgb_coarse = row("coarse")
            if "fine" in out:
                vis_fine, rgb_fine = row("fine")
                vis = vstack_images([vis_coarse, vis_fine])
                rgb_psnr = rgb_fine
            else:
                vis = vis_coarse
                rgb_psnr = rgb_coarse

            psnr = metrics.psnr(rgb_psnr, gt)
            print("vis psnr:", psnr)

            if args.vis_debug:
                # sigma z=0 cross-section heatmap (the fork's vis_debug
                # sigma z-slice figure, reference train/train.py:403-433)
                S = 64
                h = (dset.z_far - dset.z_near) / 2.0
                ax = np.linspace(-h, h, S, dtype=np.float32)
                gx, gy = np.meshgrid(ax, ax, indexing="xy")
                pts = t(np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(1, -1, 3))
                vd = torch.zeros_like(pts) if model.use_viewdirs else None
                sl = model.query(enc, pts, vd, coarse=True)[0, :, 3].float().cpu().numpy()
                sl = sl.reshape(S, S) / max(float(sl.max()), 1e-6)
                debug_dir = os.path.join(self.visual_path, "vis_debug")
                os.makedirs(debug_dir, exist_ok=True)
                write_png(os.path.join(debug_dir, f"{global_step:07d}_sigma_z0.png"), cmap(sl))

            return vis, {"psnr": psnr}

        def extra_save_state(self):
            with open(self.renderer_state_path, "w") as f:
                json.dump({"n_coarse": rcfg0.n_coarse, "n_fine": rcfg0.n_fine}, f)

    return PixelNeRFTrainer()


def main(argv=None, device=None):
    """Train as the flags say; returns the trainer after its last epoch
    (with the process group it made, if any, destroyed)."""
    trainer = make_trainer(argv, device)
    trainer.start()
    if trainer.owns_group:
        import torch.distributed as dist

        dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
