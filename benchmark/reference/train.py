"""The reference's training steps and views, in blocks that fit beside
nothing else on the card.

A step: the sources encoded in train mode (batch statistics), every ray
rendered coarse and fine, lambda_coarse * MSE(coarse) + lambda_fine *
MSE(fine), the gradients of every parameter, then Adam (b1 0.9, b2 0.999,
eps 1e-8, bias-corrected). The rays are rendered a block at a time: each
block's share of the loss is differentiated at once into the parameters
and into the encoder's output, which is differentiated through the
encoder at the end. A view: the sources encoded in eval mode, the rays
rendered in the program's chunks (each chunk's draws from the renderer's
generator, seeded as the program seeds it), a block at a time.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from reference import pixelnerf as ref

BETAS, EPS = (0.9, 0.999), 1e-8
STEP_BLOCK_RAYS = 256  # rays a block of a training step
VIEW_BLOCK_RAYS = 4096  # rays a block of a view


class Adam:
    """Adam on a dict of float32 leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        b1, b2 = BETAS
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n, p in params.items():
            g = grads[n]
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[n].sqrt() / bc2 ** 0.5 + EPS
            p.addcdiv_(self.m[n], denom, value=-self.lr / bc1)


def step_loss_and_grads(P, model_conf, rend, loss_conf, batch, gen_state, num_rays,
                        prec, fault=None) -> tuple:
    """(loss, {name: gradient}) of one step.

    :param batch images_u8 (SB, NV, H, W, 3), image_ord (SB, NS), poses
        (SB, NV, 4, 4), focal (SB, 2), c (SB, 2), near, far
    :param gen_state the step generator's state before the step
    :param fault "half_batch": the second half of the batch's objects left
        out of the loss, the mean taken over the rest (a fault to plant)
    """
    u8 = batch["images_u8"]
    dev = u8.device
    sb, nv, h, w, _ = u8.shape
    images = u8.float() / 127.5 - 1.0
    order = batch["image_ord"].long()
    ns = order.shape[1]
    pick = torch.arange(sb, device=dev)[:, None]
    src = images[pick, order]  # (SB, NS, H, W, 3)
    src_c2w = batch["poses"][pick, order]

    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    pix = torch.randint(0, nv * h * w, (sb, num_rays), generator=gen, device=dev)
    draws = ref.draw_render(gen, sb * num_rays, rend, dev)
    vid, rem = pix // (h * w), pix % (h * w)
    y, x = rem // w, rem % w
    gt = images.reshape(sb, nv * h * w, 3)[pick, pix] * 0.5 + 0.5
    c2w = batch["poses"][pick, vid]  # (SB, R, 4, 4)
    rays = torch.stack([ref.pixel_rays(c2w[b], x[b], y[b], batch["focal"][b], batch["c"][b],
                                       batch["near"], batch["far"]) for b in range(sb)])

    latent = ref.encode(P, src.reshape(sb * ns, h, w, 3), model_conf, True, prec)
    leaf = latent.detach().requires_grad_()
    lc = float(loss_conf.get("lambda_coarse", 1.0))
    lf = float(loss_conf.get("lambda_fine", 1.0))
    used = sb // 2 if fault == "half_batch" else sb
    denom = float(used * num_rays * 3)
    total = torch.zeros((), device=dev)
    for b in range(used):
        cam = ref.camera(src_c2w[b], batch["focal"][b], batch["c"][b], (w, h))
        for r0 in range(0, num_rays, STEP_BLOCK_RAYS):
            r1 = min(num_rays, r0 + STEP_BLOCK_RAYS)
            d = {k: v[b * num_rays + r0:b * num_rays + r1] for k, v in draws.items()}
            res = ref.render(P, model_conf, rend, leaf[b * ns:(b + 1) * ns], cam,
                             rays[b, r0:r1], d, prec)
            err = lambda head: ((res[head][1] - gt[b, r0:r1]) ** 2).sum()
            loss = lc * err("coarse")
            if "fine" in res:
                loss = loss + lf * err("fine")
            loss = loss / denom
            loss.backward()
            total += loss.detach()
    latent.backward(leaf.grad)
    return total, {n: p.grad for n, p in P.items() if p.requires_grad}


@ref.exact_float32()
def run_steps(P0: Dict[str, torch.Tensor], specs, model_conf, rend, loss_conf, batches: List[dict],
              gen_states: List[torch.Tensor], num_rays: int, lr: float, prec: str = "float32",
              fault=None) -> dict:
    """Follow the program's first len(batches) steps from the weights P0.

    :return losses (list of floats), grad1 {name: the first step's gradient},
        params {name: the parameters after the last step}
    """
    stats = {n for n, _, k in specs if ref.is_statistic(k)}
    params = {n: t.detach().clone() for n, t in P0.items() if n not in stats}
    adam = Adam(params, lr)
    losses, grad1 = [], None
    for batch, state in zip(batches, gen_states):
        P = {n: t.requires_grad_() for n, t in params.items()}
        P.update({n: P0[n] for n in stats})
        loss, grads = step_loss_and_grads(P, model_conf, rend, loss_conf, batch, state,
                                          num_rays, prec, fault)
        grads = {n: g.detach() for n, g in grads.items()}
        for t in params.values():
            t.grad = None
            t.requires_grad_(False)
        if grad1 is None:
            grad1 = {n: g.clone() for n, g in grads.items()}
        adam.step(params, grads)
        losses.append(float(loss))
    return {"losses": losses, "grad1": grad1, "params": params}


@ref.exact_float32()
@torch.no_grad()
def render_view(P, model_conf, rend, src_u8, src_c2w, focal, c, rays, seed: int, chunk: int,
                prec: str = "float32") -> Dict[str, Dict[str, torch.Tensor]]:
    """One view of (B, 8) rays from (NS, H, W, 3) uint8 sources:
    {'coarse'|'fine': {'rgb' (B, 3), 'depth' (B,), 'alpha' (B,)}}."""
    dev = rays.device
    ns, h, w, _ = src_u8.shape
    latent = ref.encode(P, src_u8.float() / 127.5 - 1.0, model_conf, False, prec)
    cam = ref.camera(src_c2w, focal, c, (w, h))
    n = rays.shape[0]
    pad = (-n) % chunk
    if pad:
        rays = torch.cat([rays, rays[-1:].expand(pad, 8)], dim=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out: Dict[str, Dict[str, list]] = {}
    for c0 in range(0, rays.shape[0], chunk):
        draws = ref.draw_render(gen, chunk, rend, dev)
        for r0 in range(0, chunk, VIEW_BLOCK_RAYS):
            r1 = min(chunk, r0 + VIEW_BLOCK_RAYS)
            if c0 + r0 >= n:
                break
            d = {k: v[r0:r1] for k, v in draws.items()}
            res = ref.render(P, model_conf, rend, latent, cam, rays[c0 + r0:c0 + r1], d, prec)
            for head, (weights, rgb, depth) in res.items():
                dst = out.setdefault(head, {"rgb": [], "depth": [], "alpha": []})
                dst["rgb"].append(rgb)
                dst["depth"].append(depth)
                dst["alpha"].append(weights.sum(-1))
    return {head: {k: torch.cat(v)[:n] for k, v in vals.items()} for head, vals in out.items()}
