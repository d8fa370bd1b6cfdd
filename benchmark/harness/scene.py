"""Everything a run makes from its seed: weights, objects, cameras and the
order of the traffic.

The same seed gives the same weights, images, cameras and request order,
and every seed the same sizes: only the contents and the order move with
it. Weights and images are made on the device from a `torch.Generator`
in a few large calls; the cameras and the traffic's order on the host from
numpy. The reference is handed the same things, made again from the seed.
A family's weights come from its family file (`harness/family.py`);
pixelNeRF's draw is `make_weights` here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from harness import family, manifest
from reference import pixelnerf as ref

SALTS = {"weights": 1, "images": 2, "rig": 3, "order": 4, "step": 5, "check": 6}


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), SALTS[what]]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def rng(seed: int, what: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, what))


def generator(seed: int, what: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, what))
    return g


# ----------------------------------------------------------------- weights


def make_weights(model_conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """pixelNeRF's weights (`families/pixelnerf.py` binds this): every
    parameter and BatchNorm statistic, float32, from one draw.

    Convolutions kaiming-normal over fan_out, linear layers over fan_in,
    BatchNorm as initialized. The heads are shaped so that a view is
    neither empty nor saturated: each block's second layer is non-zero
    (its zero init would hide the chain), the output layer is scaled down
    and each of its rows loses its mean, and sigma gets an offset of 2."""
    specs = ref.param_specs(model_conf)
    random = [(n, s, k) for n, s, k in specs if k in ("conv", "linear", "linear_res", "linear_out")]
    total = sum(int(np.prod(s)) for _, s, _ in random)
    draw = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for name, shape, kind in specs:
        if kind in ("conv", "linear", "linear_res", "linear_out"):
            n = int(np.prod(shape))
            w = draw[at:at + n].reshape(shape)
            at += n
            if kind == "conv":
                w = w * (2.0 / (shape[0] * shape[2] * shape[3])) ** 0.5
            elif kind == "linear":
                w = w * (2.0 / shape[1]) ** 0.5
            elif kind == "linear_res":
                w = w * 0.5 * shape[1] ** -0.5
            else:
                w = w * (2.0 / shape[1]) ** 0.5 * 0.1
                w = w - w.mean(dim=1, keepdim=True)
            out[name] = w.contiguous()
        elif kind in ("bn_weight", "bn_var"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
            if kind == "linear_out_bias":
                out[name][3] = 2.0
    return out


# ----------------------------------------------------------------- objects


def _look_at(eye: np.ndarray) -> np.ndarray:
    """Camera-to-world pose (OpenGL: the camera looks down -z, y up) of a
    camera at `eye` looking at the origin."""
    back = eye / np.linalg.norm(eye)
    x = np.cross([0.0, 1.0, 0.0], back)
    x /= np.linalg.norm(x)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, np.cross(back, x), back, eye
    return pose


def _eye(radius, azimuth, elevation):
    return radius * np.array([np.cos(elevation) * np.sin(azimuth), np.sin(elevation),
                              np.cos(elevation) * np.cos(azimuth)])


def make_rig(data: dict, objects: int, seed: int) -> np.ndarray:
    """(objects, views, 4, 4) camera-to-world poses, every view distinct.

    `sphere`: each object's views at random directions on a sphere of
    `radius` between the two elevations. `grid`: the same rows x cols
    arc of azimuths and elevations for every object, turned by a random
    azimuth per object. Any other kind: `poses(data, objects, rng)` of
    `benchmark/rigs/<kind>.py`, drawing from the same generator."""
    rig, views = data["rig"], int(data["views_per_object"])
    r = rng(seed, "rig")
    if rig["kind"] not in manifest.BUILT_IN_RIGS:
        poses = np.asarray(family.rig(rig["kind"]).poses(data, objects, r), dtype=np.float32)
        if poses.shape != (objects, views, 4, 4):
            raise ValueError(f"rig {rig['kind']!r} gave poses of shape {poses.shape}, "
                             f"not {(objects, views, 4, 4)}")
        return poses
    el_lo, el_hi = np.radians(rig["elevation_deg"])
    poses = np.empty((objects, views, 4, 4))
    for o in range(objects):
        if rig["kind"] == "sphere":
            az = r.uniform(0, 2 * np.pi, views)
            el = np.arcsin(r.uniform(np.sin(el_lo), np.sin(el_hi), views))
        elif rig["kind"] == "grid":
            az_lo, az_hi = np.radians(rig["azimuth_deg"])
            a, e = np.meshgrid(np.linspace(az_lo, az_hi, rig["cols"]),
                               np.linspace(el_lo, el_hi, rig["rows"]))
            az, el = a.reshape(-1) + r.uniform(-np.pi, np.pi), e.reshape(-1)
        for v in range(views):
            poses[o, v] = _look_at(_eye(rig["radius"], az[v], el[v]))
    return poses.astype(np.float32)


def make_images(data: dict, objects: int, seed: int, device) -> torch.Tensor:
    """(objects, views, H, W, 3) uint8: each object a colour of its own,
    under smooth random colour fields with detail at a few scales,
    different in every view. Objects differ in colour as a dataset's do,
    so a step's loss depends on which objects it holds."""
    h, w = data["image_hw"]
    views = int(data["views_per_object"])
    n = objects * views
    g = generator(seed, "images", device)
    colour = torch.rand((objects, 1, 3, 1, 1), generator=g, device=device) * 1.2 - 0.6
    img = colour.expand(objects, views, 3, 1, 1).reshape(n, 3, 1, 1).repeat(1, 1, h, w)
    for cells, gain in ((4, 0.4), (16, 0.2), (64, 0.08)):
        ch, cw = max(2, h * cells // max(h, w)), max(2, w * cells // max(h, w))
        noise = torch.rand((n, 3, ch, cw), generator=g, device=device) * 2 - 1
        img += gain * F.interpolate(noise, size=(h, w), mode="bilinear", align_corners=True)
    u8 = ((img.clamp(-1, 1) + 1) * 127.5).round().to(torch.uint8)
    return u8.permute(0, 2, 3, 1).reshape(objects, -1, h, w, 3).contiguous()


class Pool:
    """The objects a run draws its batches or requests from, on the device."""

    def __init__(self, data: dict, objects: int, seed: int, device):
        self.objects = objects
        self.views = int(data["views_per_object"])
        self.h, self.w = data["image_hw"]
        self.images_u8 = make_images(data, objects, seed, device)
        self.c2w = torch.from_numpy(make_rig(data, objects, seed)).to(device)
        self.focal = np.asarray(data["focal"], dtype=np.float32).reshape(2)
        self.c = np.asarray(data["c"], dtype=np.float32).reshape(2)
        self.near, self.far = float(data["z_near"]), float(data["z_far"])


def images_float(u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> [-1, 1] float32, as the program's compact batch expands it."""
    return u8.float() / 127.5 - 1.0


def view_rays(pool: Pool, c2w: torch.Tensor) -> torch.Tensor:
    """(H*W, 8) rays of one target camera, every pixel, row-major."""
    dev = c2w.device
    y, x = torch.meshgrid(torch.arange(pool.h, device=dev), torch.arange(pool.w, device=dev),
                          indexing="ij")
    rays = ref.pixel_rays(c2w, x.reshape(-1), y.reshape(-1), torch.from_numpy(pool.focal).to(dev),
                          torch.from_numpy(pool.c).to(dev), pool.near, pool.far)
    return rays.reshape(-1, 8)


# ----------------------------------------------------------------- order


def train_order(pool: Pool, traffic: dict, sources: int, steps: int, seed: int):
    """(steps, SB) objects and (steps, SB, NS) source views of each step."""
    r = rng(seed, "order")
    sb = int(traffic["objects_per_step"])
    objs = np.stack([r.choice(pool.objects, sb, replace=False) for _ in range(steps)])
    srcs = np.stack([[r.choice(pool.views, sources, replace=False) for _ in range(sb)]
                     for _ in range(steps)])
    return objs.astype(np.int64), srcs.astype(np.int64)


def view_order(pool: Pool, sources: int, requests: int, seed: int):
    """(requests,) objects, (requests, NS) source views, (requests,) target
    views (never a source) and (requests,) render seeds."""
    r = rng(seed, "order")
    objs = r.integers(0, pool.objects, requests)
    picks = np.stack([r.choice(pool.views, sources + 1, replace=False) for _ in range(requests)])
    seeds = r.integers(0, 2 ** 31 - 1, requests)
    return objs.astype(np.int64), picks[:, :sources].astype(np.int64), picks[:, sources], seeds
