"""Training and eval steps: ray sampling on the device, render, loss, Adam.

Counterpart of `pixelnerf_tpu/train/step.py`. A step samples target
pixels and builds their rays on the device (`sample_rays`), encodes the
source views in train mode (batch-statistics BatchNorm), renders coarse
and fine with the query cache, takes lambda_coarse * rgb_loss(coarse) +
lambda_fine * rgb_loss(fine) (+ an optional opacity loss), runs backward
and `torch.optim.Adam` (the `optax.adam` update: b1 0.9, b2 0.999, eps
1e-8, eps_root 0, the same bias correction) through `MultiSteps`, which
gives it optax's gradient accumulation, learning-rate schedule and
gradients of every parameter.

Rematerialization (`remat`, the JAX step's `jax.checkpoint` of the field
query): `remat=True` runs each field query under reentrant
`torch.utils.checkpoint`, in both arities the renderer calls (the 3-arg
no-cache form and the 5-arg `QueryCache` form). The reentrant form runs
the first forward without grad, so the MLP takes its stash-free primal
kernel (`resnetfc_fwd`, or the field primal `pyramid_field_fused`), and
the backward re-runs the query with grad: the stash kernel, then at once
the backward kernels. No stash lives between the passes, which is what
`jax.checkpoint` buys. The non-reentrant form would run the stash kernel
in both forwards and write a stash it throws away. `remat="auto"` is the
JAX rule: remat is off exactly when every field MLP takes the fused
kernels (`ResnetFC.fused_ok` at `nviews` source views, unknown counting as
several), whose bf16 stash is small; a model whose MLP runs the per-layer
chain (float32, softplus, SPADE, max pooling, `type = mlp`) keeps every
activation for the backward and gets remat.

Data and ray parallelism (`mesh`, a `parallel.Mesh`; JAX's `pmean_axes`
under shard_map): the step then sees this rank's SB/data objects and
R/rays rays (`num_rays` is rays per rays shard), draws from a generator
folded with the rank's mesh indices, and averages the gradients, the
BatchNorm running statistics and the losses over the mesh before the
optimizer update, so every rank applies the same update.

Batch (tensors on the model's device):
    images (SB, NV, H, W, 3) in [-1, 1], poses (SB, NV, 4, 4) camera-to-world
    focal (SB, 2), c (SB, 2); bbox (SB, NV, 4) [x0, y0, x1, y1] optional;
    z_bounds (SB, 2) optional per-object [near, far]
    src_images (SB, NS, H, W, 3), src_poses (SB, NS, 4, 4); src_c optional
    or images_u8 (uint8) + image_ord (SB, NS) in place of images and the
    source views; or rays (SB, R, 8) + rgb_gt (SB, R, 3), which bypass the
    sampler. Random draws come from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from pixelnerf_tpu_torch.models.losses import mse_loss
from pixelnerf_tpu_torch.models.pixelnerf import QueryCache
from pixelnerf_tpu_torch.models.resnet import BatchNorm
from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
from pixelnerf_tpu_torch.render.renderer import RendererConfig, render_rays

__all__ = ["MultiSteps", "make_optimizer", "make_train_step", "make_eval_step", "sample_rays"]


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax.adam's constants."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


class MultiSteps:
    """`optax.MultiSteps(optax.adam(lr_fn), every_k)` on a torch optimizer.

    `update()` runs after a backward. A parameter whose `.grad` is None
    (the encoder under `stop_encoder_grad`) gets zeros: JAX differentiates
    every parameter, and optax.adam keeps decaying those moments under one
    global count, where torch.optim.Adam would skip the parameter and leave
    its count behind. The gradients then join the running mean of the
    window, optax's (g + n * acc) / (n + 1); on every `every_k`-th call the
    mean goes to one optimizer step at lr_fn(count), `count` being the
    optimizer steps taken so far (optax's inner count), and a new window
    starts. Between those calls the parameters do not move. Without
    `lr_fn` the optimizer keeps its own learning rate.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int = 1,
                 lr_fn: Optional[Callable[[int], float]] = None):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.optimizer = optimizer
        self.every_k = every_k
        self.lr_fn = lr_fn
        self.count = 0  # optimizer steps taken
        self.mini_step = 0  # calls in the current window
        self._acc: Optional[List[torch.Tensor]] = None

    def _params(self) -> List[torch.Tensor]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def lr(self) -> float:
        """The learning rate of the next optimizer step."""
        if self.lr_fn is None:
            return self.optimizer.param_groups[0]["lr"]
        return float(self.lr_fn(self.count))

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def update(self) -> bool:
        """Apply the gradients in `.grad`; True when the optimizer stepped."""
        params = self._params()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.every_k > 1:
            n = self.mini_step
            if n == 0:
                self._acc = [p.grad.detach().clone() for p in params]
            else:
                for acc, p in zip(self._acc, params):
                    acc.mul_(n).add_(p.grad).div_(n + 1)
            self.mini_step = n + 1
            if self.mini_step < self.every_k:
                return False
            for acc, p in zip(self._acc, params):
                p.grad = acc
            self._acc, self.mini_step = None, 0
        if self.lr_fn is not None:
            lr = self.lr()
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        """The optimizer's state_dict, the step count and the open window."""
        return {
            "optimizer": self.optimizer.state_dict(),
            "count": self.count,
            "mini_step": self.mini_step,
            "acc": self._acc,
        }

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        acc = state["acc"]
        self._acc = None if acc is None else [
            a.to(device=p.device, dtype=p.dtype) for a, p in zip(acc, self._params())
        ]


def _prepare_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Expand a compact batch: uint8 images to [-1, 1] float32, and the
    source views gathered by index."""
    if "images_u8" not in batch:
        return batch
    out = dict(batch)
    u8 = out.pop("images_u8")
    ordv = out.pop("image_ord").long()
    images = u8.float() / 127.5 - 1.0
    sb, ns = ordv.shape
    out["images"] = images
    out["src_images"] = torch.gather(
        images, 1, ordv[:, :, None, None, None].expand(sb, ns, *images.shape[2:])
    )
    out["src_poses"] = torch.gather(out["poses"], 1, ordv[:, :, None, None].expand(sb, ns, 4, 4))
    return out


def sample_rays(
    images: torch.Tensor,
    poses: torch.Tensor,
    focal: torch.Tensor,
    c: torch.Tensor,
    z_near: float,
    z_far: float,
    num_rays: int,
    bbox: Optional[torch.Tensor] = None,
    lindisp_bounds: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
):
    """Sample target pixels across all views and build their rays.

    :param images (SB, NV, H, W, 3) in [-1, 1]
    :param bbox (SB, NV, 4) [x0, y0, x1, y1]; None samples all pixels
    :param draws the random draws, given instead of drawn: `pix` (SB, R)
        in [0, NV*H*W) without bbox; `vid` (SB, R) in [0, NV) and `ux`,
        `uy` (SB, R) in [0, 1) with it
    :return (rays (SB, R, 8), rgb_gt (SB, R, 3) in [0, 1])
    """
    sb, nv, h, w, _ = images.shape
    dev = images.device
    draws = draws or {}
    shape = (sb, num_rays)
    if bbox is not None:
        vid = draws.get("vid")
        if vid is None:
            vid = torch.randint(0, nv, shape, generator=generator, device=dev)
        ux, uy = draws.get("ux"), draws.get("uy")
        if ux is None:
            ux = torch.rand(shape, generator=generator, device=dev)
        if uy is None:
            uy = torch.rand(shape, generator=generator, device=dev)
        boxes = torch.gather(bbox.float(), 1, vid.long()[..., None].expand(sb, num_rays, 4))
        x = (ux * (boxes[..., 2] + 1 - boxes[..., 0]) + boxes[..., 0]).long().clamp(0, w - 1)
        y = (uy * (boxes[..., 3] + 1 - boxes[..., 1]) + boxes[..., 1]).long().clamp(0, h - 1)
        vid = vid.long()
    else:
        pix = draws.get("pix")
        if pix is None:
            pix = torch.randint(0, nv * h * w, shape, generator=generator, device=dev)
        pix = pix.long()
        vid = pix // (h * w)
        rem = pix % (h * w)
        y, x = rem // w, rem % w

    flat = images.reshape(sb, nv * h * w, 3)
    idx = vid * (h * w) + y * w + x
    rgb_gt = torch.gather(flat, 1, idx[..., None].expand(sb, num_rays, 3)) * 0.5 + 0.5

    fx, fy = focal[:, None, 0], focal[:, None, 1]
    cx, cy = c[:, None, 0], c[:, None, 1]
    dx = (x.float() - cx) / fx
    dy = -(y.float() - cy) / fy
    d_cam = torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    pose_sel = torch.gather(poses, 1, vid[..., None, None].expand(sb, num_rays, 4, 4))
    origins = pose_sel[..., :3, 3]
    dirs = torch.einsum("brij,brj->bri", pose_sel[..., :3, :3], d_cam)
    if lindisp_bounds is not None:
        near = lindisp_bounds[:, None, 0:1].expand(sb, num_rays, 1)
        far = lindisp_bounds[:, None, 1:2].expand(sb, num_rays, 1)
    else:
        near = torch.full((sb, num_rays, 1), z_near, device=dev)
        far = torch.full((sb, num_rays, 1), z_far, device=dev)
    return torch.cat([origins, dirs, near, far], dim=-1), rgb_gt


def _rays_for(batch, generator, z_near, z_far, num_rays, use_bbox):
    if "rays" in batch:
        return batch["rays"], batch["rgb_gt"]
    return sample_rays(
        batch["images"], batch["poses"], batch["focal"], batch["c"], z_near, z_far,
        num_rays, bbox=batch.get("bbox") if use_bbox else None,
        lindisp_bounds=batch.get("z_bounds"), generator=generator,
    )


def _model_uses_fused_mlp(model, max_nviews: Optional[int] = None) -> bool:
    """True when every field MLP of `model` takes the fused kernels at up to
    `max_nviews` source views (None: unknown, counted as several, so that
    remat is never turned off for a model that leaves the kernels at run
    time); the JAX step's rule of the same name."""
    mlps = [m for m in (model.mlp_coarse, model.mlp_fine) if m is not None]
    return bool(mlps) and all(
        isinstance(m, ResnetFC) and m.fused_ok((max_nviews, 1)) for m in mlps
    )


def _remat_query(model, enc):
    """model.query on `enc` with the query rematerialized in the backward
    (reentrant checkpoint; see the module docstring). Reentrant checkpoint
    follows only the tensors passed to it, so the encoding's latent levels
    and the cache ride as arguments, and `anchor` (a leaf that wants a
    gradient) keeps the query in the graph when none of them does (a
    frozen encoder), else the MLP's parameters would get no gradient. The
    query draws nothing at random, so no RNG state is kept."""
    levels = list(enc.latent) if isinstance(enc.latent, tuple) else [enc.latent]
    anchor = torch.empty(0, device=model.device, requires_grad=True)

    def query_fn(xyz, viewdirs, coarse, want_cache=0, cache=None):
        def run(_anchor, xyz, viewdirs, global_latent, cz, cx, *levels):
            latent = tuple(levels) if isinstance(enc.latent, tuple) else levels[0]
            e = dataclasses.replace(enc, latent=latent, global_latent=global_latent)
            c = None if cz is None else QueryCache(z=cz, x=cx)
            out = model.query(e, xyz, viewdirs, coarse, want_cache, c)
            return (out[0], out[1].z, out[1].x) if want_cache else out

        out = checkpoint(
            run, anchor, xyz, viewdirs, enc.global_latent,
            None if cache is None else cache.z, None if cache is None else cache.x, *levels,
            use_reentrant=True, preserve_rng_state=False,
        )
        return (out[0], QueryCache(z=out[1], x=out[2])) if want_cache else out

    return query_fn


def _render(model, batch, rays, rcfg, generator, train, want_weights=False, remat=False):
    enc = model.encode(
        batch["src_images"], batch["src_poses"], batch["focal"], batch.get("src_c", batch["c"])
    )

    def query_fn(xyz, viewdirs, coarse, want_cache=0, cache=None):
        return model.query(enc, xyz, viewdirs, coarse, want_cache, cache)

    if remat:
        query_fn = _remat_query(model, enc)

    return render_rays(
        query_fn, rays, rcfg, generator=generator, want_weights=want_weights,
        use_viewdirs=model.use_viewdirs, train=train,
        query_cache=model.supports_query_cache,
    )


def make_train_step(
    model,
    rcfg: RendererConfig,
    optimizer,
    num_rays: int,
    z_near: float,
    z_far: float,
    lambda_coarse: float = 1.0,
    lambda_fine: float = 1.0,
    rgb_loss_fn: Optional[Callable] = None,
    rgb_fine_loss_fn: Optional[Callable] = None,
    use_bbox: bool = False,
    alpha_loss_fn: Optional[Callable] = None,
    remat="auto",
    mesh=None,
    nviews: Optional[int] = None,
) -> Callable:
    """train_step(batch, generator=None) -> aux {'rc', 'rf', ['ra'], 't'}:
    one step that updates `model` (parameters and BatchNorm running
    statistics) and `optimizer` in place. The parameters' `.grad` hold the
    step's gradients afterwards (averaged over the mesh, with one).

    :param optimizer a `MultiSteps` (gradient accumulation and an lr
        schedule; the training CLI shares one between the steps it builds
        as its schedules change), or a torch optimizer, which steps once a
        call at its own lr
    :param alpha_loss_fn fn(alpha (SB, R)) -> scalar opacity loss on the
        finest head's composited alpha, already epoch-gated by the caller
    :param remat True, False or "auto" (module docstring)
    :param mesh a `parallel.Mesh`: the step runs on this rank's shard of
        the batch and reduces over the mesh (module docstring)
    :param nviews the most source views the step will see (the largest
        `-V`), for remat="auto"; None counts as several
    """
    rgb_loss_fn = rgb_loss_fn or mse_loss
    rgb_fine_loss_fn = rgb_fine_loss_fn or rgb_loss_fn
    updater = optimizer if isinstance(optimizer, MultiSteps) else MultiSteps(optimizer)
    if remat == "auto":
        remat = not _model_uses_fused_mlp(model, nviews)
    bn_stats = [b for m in model.modules() if isinstance(m, BatchNorm)
                for b in (m.running_mean, m.running_var)]

    def train_step(batch, generator: Optional[torch.Generator] = None):
        batch = _prepare_batch(batch)
        model.train()
        if mesh is not None:
            generator = mesh.fold(generator, model.device)
        rays, rgb_gt = _rays_for(batch, generator, z_near, z_far, num_rays, use_bbox)
        out = _render(model, batch, rays, rcfg, generator, True, alpha_loss_fn is not None,
                      remat)
        loss_c = rgb_loss_fn(out["coarse"]["rgb"], rgb_gt)
        loss = lambda_coarse * loss_c
        aux = {"rc": lambda_coarse * loss_c}
        if "fine" in out:
            loss_f = rgb_fine_loss_fn(out["fine"]["rgb"], rgb_gt)
            loss = loss + lambda_fine * loss_f
            aux["rf"] = lambda_fine * loss_f
        if alpha_loss_fn is not None:
            head = out.get("fine", out["coarse"])
            loss_a = alpha_loss_fn(head["weights"].sum(dim=-1))
            loss = loss + loss_a
            aux["ra"] = loss_a
        aux["t"] = loss
        updater.zero_grad()
        loss.backward()
        aux = {k: v.detach() for k, v in aux.items()}
        if mesh is not None:
            # JAX's pmean of grads, batch_stats and aux: the global loss is
            # the mean of equal-sized shard means
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            mesh.all_reduce_mean_(grads + bn_stats + list(aux.values()))
        updater.update()
        return aux

    return train_step


def make_eval_step(
    model,
    rcfg: RendererConfig,
    num_rays: int,
    z_near: float,
    z_far: float,
    lambda_coarse: float = 1.0,
    lambda_fine: float = 1.0,
    mesh=None,
) -> Callable:
    """eval_step(batch, generator=None) -> aux {'rc', 'rf', 't'}: the
    losses on held-out data, with eval-mode BatchNorm and no gradient (the
    fused MLP then runs its stash-free forward); with `mesh`, on this
    rank's shard and averaged over the mesh."""

    @torch.no_grad()
    def eval_step(batch, generator: Optional[torch.Generator] = None):
        batch = _prepare_batch(batch)
        model.eval()
        if mesh is not None:
            generator = mesh.fold(generator, model.device)
        rays, rgb_gt = _rays_for(batch, generator, z_near, z_far, num_rays, False)
        out = _render(model, batch, rays, rcfg, generator, False)
        aux = {"rc": lambda_coarse * mse_loss(out["coarse"]["rgb"], rgb_gt)}
        total = aux["rc"]
        if "fine" in out:
            aux["rf"] = lambda_fine * mse_loss(out["fine"]["rgb"], rgb_gt)
            total = total + aux["rf"]
        aux["t"] = total
        if mesh is not None:
            mesh.all_reduce_mean_(list(aux.values()))
        return aux

    return eval_step
