"""Plain pixelNeRF in PyTorch: the judge of every cell.

Written from the pixelNeRF paper (Yu et al., CVPR 2021, arXiv:2012.02190)
and the conventions of its published code: a ResNet trunk whose stem and
first three stages are upsampled to the stem's size (bilinear, aligned
corners) and stacked into one 512-channel map; points projected into each
source view and looked up there (bilinear, border padding, aligned
corners); the positional code of the rotated point beside the rotated view
direction; a ResnetFC whose first `combine_layer` blocks take the latent
and whose views are averaged before the rest; stratified coarse samples,
inverse-CDF and depth-guided fine samples, alpha compositing. Parameters
are a dict named as the program names them (`param_specs`).

It imports nothing of the program. Every product runs in float32 with TF32
off. With `precision="fp8"` the products compute as float8 training does:
every operand of a convolution and of a linear layer is first rounded to
float8 e4m3, and the cotangent that enters each product's backward to
float8 e5m2, each with a per-tensor scale: the control of a bfloat16
configuration, one precision below it (a float32 configuration's is the
program at bfloat16, `calibrate.py`).

Random draws are taken from a `torch.Generator` in the order the program's
renderer documents (pixels, then per ray block: coarse jitter, importance
u, bin jitter, depth noise), so a generator in the same state gives both
sides the same numbers.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
STAGE_CHANNELS = (64, 128, 256, 512)
BN_EPS = 1e-5
FP8_MAX = 448.0  # largest finite float8 e4m3
FP8_GRAD_MAX = 57344.0  # largest finite float8 e5m2


@contextlib.contextmanager
def exact_float32():
    """Float32 products stay float32 on the card (no TF32) inside; the
    settings are given back on the way out, so a program that runs after
    the reference in the same process runs as it would alone."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _to_fp8(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """`t` scaled so its largest magnitude is the format's largest,
    rounded to it, scaled back."""
    scale = t.abs().amax().clamp_min(1e-30) / largest
    return (t / scale).to(dtype).to(t.dtype) * scale


def _check(precision: str) -> None:
    if precision not in ("float32", "fp8"):
        raise ValueError(f"precision is 'float32' or 'fp8', got {precision!r}")


def round_operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    """`t` as the product sees it: unchanged in float32; in fp8 rounded to
    e4m3, with the gradient passed straight through."""
    _check(precision)
    if precision == "float32":
        return t
    return t + (_to_fp8(t.detach(), torch.float8_e4m3fn, FP8_MAX) - t).detach()


class _RoundCotangent(torch.autograd.Function):
    """The identity, whose cotangent is rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2, FP8_GRAD_MAX)


def round_product(y: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's output, whose cotangent the backward's products see in
    the precision: unchanged in float32, e5m2 in fp8."""
    _check(precision)
    return y if precision == "float32" else _RoundCotangent.apply(y)


# ----------------------------------------------------------------- params


def _trunk_specs(backbone: str, num_layers: int) -> List[Tuple[str, tuple, str]]:
    specs = [("encoder.model.conv1.weight", (64, 3, 7, 7), "conv")]
    specs += _bn_specs("encoder.model.bn1", 64)
    cin = 64
    for stage in range(num_layers - 1):
        cout = STAGE_CHANNELS[stage]
        for blk in range(STAGE_BLOCKS[backbone][stage]):
            stride = 2 if (stage > 0 and blk == 0) else 1
            p = f"encoder.model.layer{stage + 1}_{blk}"
            specs.append((f"{p}.conv1.weight", (cout, cin, 3, 3), "conv"))
            specs += _bn_specs(f"{p}.bn1", cout)
            specs.append((f"{p}.conv2.weight", (cout, cout, 3, 3), "conv"))
            specs += _bn_specs(f"{p}.bn2", cout)
            if stride != 1 or cin != cout:
                specs.append((f"{p}.downsample_conv.weight", (cout, cin, 1, 1), "conv"))
                specs += _bn_specs(f"{p}.downsample_bn", cout)
            cin = cout
    return specs


def _bn_specs(prefix: str, c: int):
    return [(f"{prefix}.weight", (c,), "bn_weight"), (f"{prefix}.bias", (c,), "bn_bias"),
            (f"{prefix}.running_mean", (c,), "bn_mean"), (f"{prefix}.running_var", (c,), "bn_var")]


def _mlp_specs(prefix: str, mlp: dict, d_in: int, d_latent: int, d_out: int = 4):
    h, n_blocks = int(mlp["d_hidden"]), int(mlp["n_blocks"])
    n_inj = min(int(mlp["combine_layer"]), n_blocks)
    lin = lambda name, i, o, kind: [(f"{prefix}.{name}.weight", (o, i), kind),
                                    (f"{prefix}.{name}.bias", (o,), kind + "_bias")]
    specs = lin("lin_in", d_in, h, "linear")
    for i in range(n_inj):
        specs += lin(f"lin_z_{i}", d_latent, h, "linear")
    for i in range(n_blocks):
        specs += lin(f"block_{i}.fc_0", h, h, "linear") + lin(f"block_{i}.fc_1", h, h, "linear_res")
    return specs + lin("lin_out", h, d_out, "linear_out")


def dims(model_conf: dict) -> Dict[str, int]:
    """d_in of the MLP input [xyz, code(xyz), viewdirs] and d_latent."""
    code = model_conf["code"]
    d_in = 3 + 2 * int(code["num_freqs"]) * 3 + 3
    d_latent = sum(STAGE_CHANNELS[: int(model_conf["encoder"]["num_layers"]) - 1]) + 64
    return {"d_in": d_in, "d_latent": d_latent}


def param_specs(model_conf: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and BatchNorm statistic of the
    configured model, in the program's names."""
    enc = model_conf["encoder"]
    d = dims(model_conf)
    specs = _trunk_specs(enc["backbone"], int(enc["num_layers"]))
    for head in ("mlp_coarse", "mlp_fine"):
        specs += _mlp_specs(head, model_conf[head], d["d_in"], d["d_latent"])
    return specs


def is_statistic(kind: str) -> bool:
    return kind in ("bn_mean", "bn_var")


# ----------------------------------------------------------------- encoder


def _conv(x, w, stride, pad, prec):
    return round_product(F.conv2d(round_operand(x, prec), round_operand(w, prec), stride=stride,
                                  padding=pad), prec)


def _bn(x, P, name, train):
    w, b = P[name + ".weight"], P[name + ".bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    shape = (1, -1, 1, 1)
    return (x - mean.reshape(shape)) * torch.rsqrt(var + BN_EPS).reshape(shape) * w.reshape(
        shape) + b.reshape(shape)


def encode(P, images: torch.Tensor, model_conf: dict, train: bool, prec: str) -> torch.Tensor:
    """(N, H, W, 3) images in [-1, 1] -> (N, d_latent, Hl, Wl): the stem and
    every stage after it, upsampled to the stem's size and stacked. The
    stem is max-pooled before the first stage unless the encoder sets
    `use_first_pool` false (the NMR configuration's 64x64 images)."""
    enc = model_conf["encoder"]
    blocks = STAGE_BLOCKS[enc["backbone"]]
    x = images.permute(0, 3, 1, 2)
    x = torch.relu(_bn(_conv(x, P["encoder.model.conv1.weight"], 2, 3, prec), P,
                       "encoder.model.bn1", train))
    latents = [x]
    if enc.get("use_first_pool", True):
        x = F.max_pool2d(x, 3, stride=2, padding=1)
    for stage in range(int(enc["num_layers"]) - 1):
        for blk in range(blocks[stage]):
            stride = 2 if (stage > 0 and blk == 0) else 1
            p = f"encoder.model.layer{stage + 1}_{blk}"
            out = torch.relu(_bn(_conv(x, P[p + ".conv1.weight"], stride, 1, prec), P,
                                 p + ".bn1", train))
            out = _bn(_conv(out, P[p + ".conv2.weight"], 1, 1, prec), P, p + ".bn2", train)
            if p + ".downsample_conv.weight" in P:
                x = _bn(_conv(x, P[p + ".downsample_conv.weight"], stride, 0, prec), P,
                        p + ".downsample_bn", train)
            x = torch.relu(out + x)
        latents.append(x)
    size = latents[0].shape[2:]
    ups = [latents[0]] + [F.interpolate(l, size=size, mode="bilinear", align_corners=True)
                          for l in latents[1:]]
    return torch.cat(ups, dim=1)


# ----------------------------------------------------------------- field


def world_to_camera(c2w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    rot = c2w[..., :3, :3].transpose(-1, -2)
    trans = -(rot @ c2w[..., :3, 3:])[..., 0]
    return rot, trans


def posenc(x: torch.Tensor, num_freqs: int, freq_factor: float) -> torch.Tensor:
    """[x, sin(f1 x), cos(f1 x), sin(f2 x), ...], f_k = freq_factor 2^k."""
    parts = [x]
    for k in range(num_freqs):
        f = freq_factor * 2.0 ** k
        parts += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(parts, dim=-1)


def _linear(x, P, name, prec):
    return round_product(F.linear(round_operand(x, prec), round_operand(P[name + ".weight"], prec),
                                  P[name + ".bias"]), prec)


def resnetfc(P, head: str, mlp: dict, z, x, ns: int, prec: str) -> torch.Tensor:
    """(SB, NS, B, d_latent), (SB, NS, B, d_in) -> (SB, B, 4) raw outputs."""
    n_blocks, combine = int(mlp["n_blocks"]), int(mlp["combine_layer"])
    h = _linear(x, P, f"{head}.lin_in", prec)
    for blk in range(n_blocks):
        if blk == combine:
            h = h.mean(dim=1)
        if blk < combine:
            h = h + _linear(z, P, f"{head}.lin_z_{blk}", prec)
        net = _linear(torch.relu(h), P, f"{head}.block_{blk}.fc_0", prec)
        h = h + _linear(torch.relu(net), P, f"{head}.block_{blk}.fc_1", prec)
    if combine >= n_blocks:
        h = h.mean(dim=1)
    return _linear(torch.relu(h), P, f"{head}.lin_out", prec)


def query(P, model_conf, head, latent, cam, points, dirs, prec):
    """Field at world points of one object.

    :param latent (NS, C, Hl, Wl) the object's source views' map
    :param cam dict: rot (NS, 3, 3), trans (NS, 3), focal (2,), c (2,), image_wh (2,)
    :param points (B, 3), dirs (B, 3) world ray directions
    :return (B, 4): sigmoid rgb, relu sigma
    """
    ns = latent.shape[0]
    xyz_rot = torch.einsum("nij,bj->nbi", cam["rot"], points)  # (NS, B, 3)
    xyz_cam = xyz_rot + cam["trans"][:, None, :]
    focal = cam["focal"] * torch.tensor([1.0, -1.0], device=points.device)
    uv = -xyz_cam[..., :2] / xyz_cam[..., 2:] * focal + cam["c"]
    hw = torch.tensor([latent.shape[3], latent.shape[2]], dtype=torch.float32,
                      device=points.device)
    grid = uv * (hw / (hw - 1.0) * 2.0) / cam["image_wh"] - 1.0
    z = F.grid_sample(latent, grid[:, None], mode="bilinear", padding_mode="border",
                      align_corners=True)[:, :, 0].permute(0, 2, 1)  # (NS, B, C)
    code = model_conf["code"]
    vd = torch.einsum("nij,bj->nbi", cam["rot"], dirs)
    x = torch.cat([posenc(xyz_rot, int(code["num_freqs"]), float(code["freq_factor"])), vd], -1)
    out = resnetfc(P, head, model_conf[head], z[None], x[None], ns, prec)[0]
    return torch.cat([torch.sigmoid(out[:, :3]), torch.relu(out[:, 3:4])], dim=-1)


# ----------------------------------------------------------------- renderer


def composite(rgb, sigma, z, far, white_bkgd):
    """(B, K, 3), (B, K), (B, K) sorted, (B, 1) -> weights, rgb, depth."""
    deltas = torch.cat([z[:, 1:] - z[:, :-1], far - z[:, -1:]], dim=-1)
    alpha = 1.0 - torch.exp(-deltas * torch.relu(sigma))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)
    weights = alpha * trans[:, :-1]
    out = (weights[..., None] * rgb).sum(dim=1)
    if white_bkgd:
        out = out + (1.0 - weights.sum(dim=1))[:, None]
    return weights, out, (weights * z).sum(dim=1)


def draw_render(gen: torch.Generator, n_rays: int, rend: dict, device) -> Dict[str, torch.Tensor]:
    """The renderer's draws for `n_rays` rays, in its order."""
    kc, kf, kd = int(rend["n_coarse"]), int(rend["n_fine"]), int(rend["n_fine_depth"])
    d = {"jitter": torch.rand((n_rays, kc), generator=gen, device=device)}
    if kf - kd > 0:
        d["u"] = torch.rand((n_rays, kf - kd), generator=gen, device=device)
        d["bin_jitter"] = torch.rand((n_rays, kf - kd), generator=gen, device=device)
    if kd > 0:
        d["noise"] = torch.randn((n_rays, kd), generator=gen, device=device)
    return d


def render(P, model_conf, rend, latent, cam, rays, draws, prec):
    """Coarse then fine render of one object's rays (B, 8) with its draws
    (rows of `draw_render`'s). -> {'coarse'|'fine': (weights, rgb, depth)}"""
    near, far = rays[:, 6:7], rays[:, 7:8]
    kc = int(rend["n_coarse"])
    white = bool(rend["white_bkgd"])
    t = torch.linspace(0.0, 1.0 - 1.0 / kc, kc, device=rays.device)[None] + draws["jitter"] / kc
    z_coarse = near * (1 - t) + far * t

    def field(head, z):
        b, k = z.shape
        pts = (rays[:, None, :3] + z[..., None] * rays[:, None, 3:6]).reshape(-1, 3)
        dirs = rays[:, None, 3:6].expand(b, k, 3).reshape(-1, 3)
        out = query(P, model_conf, head, latent, cam, pts, dirs, prec).reshape(b, k, 4)
        return composite(out[..., :3], out[..., 3], z, far, white)

    res = {"coarse": field("mlp_coarse", z_coarse)}
    weights_c, _, depth_c = res["coarse"]
    new = [z_coarse]
    if "u" in draws:
        w = weights_c.detach() + 1e-5
        cdf = torch.cumsum(w / w.sum(dim=-1, keepdim=True), dim=-1)
        cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
        inds = ((cdf[:, None, :] <= draws["u"][:, :, None]).float().sum(-1) - 1.0).clamp_min(0.0)
        s = (inds + draws["bin_jitter"]) / kc
        new.append(near * (1 - s) + far * s)
    if "noise" in draws:
        zd = depth_c.detach()[:, None] + draws["noise"] * float(rend["depth_std"])
        new.append(torch.minimum(torch.maximum(zd, near), far))
    if len(new) > 1:
        z_fine = torch.sort(torch.cat(new, dim=-1), dim=-1, stable=True).values
        res["fine"] = field("mlp_fine", z_fine)
    return res


# ----------------------------------------------------------------- cameras


def camera(c2w_src: torch.Tensor, focal, c, image_wh) -> dict:
    """One object's source cameras for `query`."""
    rot, trans = world_to_camera(c2w_src)
    dev = c2w_src.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(-1).expand(2)
    return {"rot": rot, "trans": trans, "focal": f32(focal), "c": f32(c),
            "image_wh": f32(image_wh).clone()}


def pixel_rays(c2w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, focal, c,
               near: float, far: float) -> torch.Tensor:
    """Rays [origin, dir, near, far] through integer pixels (x, y) of
    cameras `c2w` (..., 4, 4) broadcast against x, y."""
    f = torch.as_tensor(focal, dtype=torch.float32).reshape(-1).expand(2)
    cc = torch.as_tensor(c, dtype=torch.float32).reshape(-1).expand(2)
    d = torch.stack([(x.float() - cc[0]) / f[0], -(y.float() - cc[1]) / f[1],
                     -torch.ones_like(x, dtype=torch.float32)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    dirs = (c2w[..., :3, :3] @ d[..., None])[..., 0]
    org = c2w[..., :3, 3].expand_as(dirs)
    nf = torch.tensor([near, far], device=dirs.device).expand(dirs.shape[:-1] + (2,))
    return torch.cat([org, dirs, nf], dim=-1)
