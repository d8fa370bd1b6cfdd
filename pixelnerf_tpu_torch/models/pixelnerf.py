"""PixelNeRF model: pixel-aligned conditional NeRF.

Counterpart of `pixelnerf_tpu/models/pixelnerf.py`: `encode` returns an
explicit `SceneEncoding` (latents, world-to-camera poses, intrinsics with
fy negated), `query` predicts (r, g, b, sigma) at world points, and
`make_model` builds the model from a `model` config subtree. The fused
field path (`use_field_fusion`, turned on by eval/render_utils.py, never
in train mode) hands the native pyramid to the field kernel
(ops/field.py); otherwise the latent is gathered by `index_features` and
the MLP runs on the (z, x) pair. bf16 models build the MLP input with the
posenc kernel (ops/posenc.py). `QueryCache` carries the coarse pass's MLP
inputs to the fine pass, so each sample is projected, gathered and
encoded once a step. With `use_global_encoder` the `ImageEncoder`'s
latent of each source view is prepended to the gathered one (d_latent
grows by its size), and the dual lookup and the field path are off, as in
the JAX model. The MLP is a `ResnetFC` or, for `type = mlp`, an
`ImplicitNet` on the concatenated (z, x).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from pixelnerf_tpu_torch.device import resolve_device
from pixelnerf_tpu_torch.models.code import PositionalEncoding
from pixelnerf_tpu_torch.models.encoder import (
    ImageEncoder, SpatialEncoder, compose_pyramid, index_features, pyramid_fused_ok,
)
from pixelnerf_tpu_torch.models.mlp import ImplicitNet
from pixelnerf_tpu_torch.models.resnetfc import FieldInput, ResnetFC
from pixelnerf_tpu_torch.ops.posenc import posenc_concat, posenc_supported
from pixelnerf_tpu_torch.utils.rays import repeat_interleave
from pixelnerf_tpu_torch.utils.spans import span

__all__ = ["PixelNeRFNet", "SceneEncoding", "QueryCache", "make_model"]


@dataclasses.dataclass
class QueryCache:
    """The coarse pass's per-sample MLP inputs, per ray, for the fine pass.

    z: (SB*NS, R, Kc, d_latent) gathered latent (after stop_encoder_grad,
    with the global latent prepended); x: (SB*NS, R, Kc, d_in) positional
    code.
    """

    z: torch.Tensor
    x: torch.Tensor


@dataclasses.dataclass
class SceneEncoding:
    """Per-scene conditioning state; arrays lead with the SB*NS views."""

    latent: object  # (SB*NS, Hl, Wl, C) map, or tuple of native levels
    latent_scaling: torch.Tensor  # (2,)
    poses: torch.Tensor  # (SB*NS, 3, 4) world-to-camera [R|t]
    focal: torch.Tensor  # (1 or SB, 2), fy negated
    c: torch.Tensor  # (1 or SB, 2)
    image_size: torch.Tensor  # (2,) [W, H]
    global_latent: Optional[torch.Tensor] = None  # (SB*NS, Lg)
    num_views: int = 1

    def to(self, device) -> "SceneEncoding":
        move = lambda t: None if t is None else t.to(device)
        latent = (
            tuple(move(l) for l in self.latent)
            if isinstance(self.latent, tuple)
            else move(self.latent)
        )
        return dataclasses.replace(
            self, latent=latent, latent_scaling=move(self.latent_scaling),
            poses=move(self.poses), focal=move(self.focal), c=move(self.c),
            image_size=move(self.image_size), global_latent=move(self.global_latent),
        )


def _norm_focal_or_c(v, flip_y: bool, device) -> torch.Tensor:
    """scalar -> (1, 2); (N,) -> (N, 2); (N, 2) kept; fy negated on flip."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if v.ndim == 0:
        v = v.reshape(1, 1).expand(1, 2)
    elif v.ndim == 1:
        v = v[:, None].expand(v.shape[0], 2)
    if flip_y:
        v = v * torch.tensor([1.0, -1.0], device=device)
    return v


class PixelNeRFNet(nn.Module):
    """Flags mirror the JAX model; `make_model` builds the submodules."""

    def __init__(
        self,
        encoder: SpatialEncoder,
        code: Optional[PositionalEncoding],
        mlp_coarse: nn.Module,
        mlp_fine: Optional[nn.Module],
        d_in: int,
        d_latent: int,
        d_out: int = 4,
        use_xyz: bool = False,
        normalize_z: bool = True,
        use_code: bool = False,
        use_code_viewdirs: bool = True,
        use_viewdirs: bool = False,
        stop_encoder_grad: bool = False,
        global_encoder: Optional[ImageEncoder] = None,
        dtype: torch.dtype = torch.float32,
        use_fused_gather: bool = True,
    ):
        super().__init__()
        self.encoder = encoder
        self.global_encoder = global_encoder
        self.use_global_encoder = global_encoder is not None
        self.code = code
        self.mlp_coarse = mlp_coarse
        self.mlp_fine = mlp_fine
        self.d_in = d_in
        self.d_latent = d_latent
        self.d_out = d_out
        self.use_xyz = use_xyz
        self.normalize_z = normalize_z
        self.use_code = use_code
        self.use_code_viewdirs = use_code_viewdirs
        self.use_viewdirs = use_viewdirs
        self.stop_encoder_grad = stop_encoder_grad
        self.dtype = dtype
        # make_model(use_pallas=False) turns it off: the composed lookup and
        # plain posenc (the MLPs' own use_pallas keeps them per-layer)
        self.use_fused_gather = use_fused_gather
        # run the fused gather+field kernel in query(); eval renders turn
        # it on (eval/render_utils.py:make_chunk_renderer), and a train step
        # of `with_field_fusion()` trains through it
        self.use_field_fusion = False

    def with_field_fusion(self) -> "PixelNeRFNet":
        """A shallow copy sharing every parameter, with the fused field
        path on."""
        model = copy.copy(self)
        model.use_field_fusion = True
        return model

    def init_shapes(self, images: torch.Tensor) -> "PixelNeRFNet":
        """Make the parameters whose shapes follow the input (the custom
        encoder's global-code convolution), as Flax's init does from an
        example batch: the encoder runs once on the first of `images`
        (..., H, W, 3). Nothing for a model that has none. The first encode
        makes them too; an optimizer or a count of the parameters needs
        them before."""
        if any(nn.parameter.is_lazy(p) for p in self.parameters()):
            with torch.no_grad():
                self.encoder(images.reshape((-1,) + tuple(images.shape[-3:]))[:1].to(self.device))
        return self

    @property
    def device(self) -> torch.device:
        return next(self.mlp_coarse.parameters()).device

    def encode(self, images: torch.Tensor, poses: torch.Tensor, focal, c=None) -> SceneEncoding:
        """:param images (SB, NS, H, W, 3) or (SB, H, W, 3), NHWC, in [-1, 1]
        :param poses camera-to-world (SB, NS, 4, 4) or (SB, 4, 4)
        :param focal () | (2,) | (SB,) | (SB, 2) [fx, fy]
        :param c principal point, same formats; None = image center
        """
        with span("pnt.encode"):
            return self._encode(images, poses, focal, c)

    def _encode(self, images, poses, focal, c) -> SceneEncoding:
        device = self.device
        images = images.to(device)
        poses = poses.to(device=device, dtype=torch.float32)
        if images.ndim == 5:
            num_views = images.shape[1]
            images = images.reshape((-1,) + tuple(images.shape[2:]))
            poses = poses.reshape(-1, 4, 4)
        else:
            num_views = 1
        H, W = images.shape[1:3]
        image_size = torch.tensor([W, H], dtype=torch.float32, device=device)

        latent, latent_scaling = self.encoder(images)
        if isinstance(latent, tuple) and not pyramid_fused_ok(
            latent, self.encoder.index_interp, self.encoder.index_padding,
            self.encoder.upsample_interp, self.use_fused_gather,
        ):
            latent = compose_pyramid(
                latent, self.encoder.upsample_interp, self.encoder.index_interp
            )

        rot = poses[:, :3, :3].transpose(1, 2)
        trans = -torch.einsum("bij,bj->bi", rot, poses[:, :3, 3])
        w2c = torch.cat([rot, trans[..., None]], dim=-1)

        focal = _norm_focal_or_c(focal, True, device)
        c = (image_size * 0.5)[None] if c is None else _norm_focal_or_c(c, False, device)
        global_latent = self.global_encoder(images) if self.use_global_encoder else None
        return SceneEncoding(
            latent=latent, latent_scaling=latent_scaling, poses=w2c,
            focal=focal, c=c, image_size=image_size, global_latent=global_latent,
            num_views=num_views,
        )

    def _posenc_fused_ok(self) -> bool:
        """The [xyz, code(xyz), viewdirs] layout of the posenc kernel, in a
        bf16 model (float32 models keep the plain chain, as in the JAX
        package), unless `use_fused_gather` is off."""
        return (
            self.use_fused_gather
            and self.d_in > 0
            and self.use_xyz
            and self.use_code
            and not self.use_code_viewdirs
            and self.use_viewdirs
            and self.dtype == torch.bfloat16
            and posenc_supported(3, self.code.num_freqs, self.code.include_input)
            and self.code.d_out + 3 == self.d_in
        )

    @property
    def supports_query_cache(self) -> bool:
        """The coarse-to-fine dedup path needs a gathered latent to cache,
        which the fused field path never forms."""
        return not self.use_field_fusion

    def _field_fused_ok(self, enc: SceneEncoding, mlp, ns: int) -> bool:
        # stop_encoder_grad: the fused backward always computes the level
        # gradients, so the lookup path detaches the latent instead
        return (
            self.use_field_fusion
            and not self.stop_encoder_grad
            and not self.use_global_encoder
            and isinstance(enc.latent, tuple)
            and isinstance(mlp, ResnetFC)
            and self.d_in > 0
            and mlp.field_path_ok(ns)
        )

    def query(
        self, enc: SceneEncoding, xyz: torch.Tensor,
        viewdirs: Optional[torch.Tensor] = None, coarse: bool = True,
        want_cache: int = 0, cache: Optional[QueryCache] = None,
    ):
        """:param xyz (SB, B, 3) world points
        :param viewdirs (SB, B, 3) world ray directions
        :param want_cache when > 0 (the samples per ray), also return a
            QueryCache of the MLP inputs (requires supports_query_cache)
        :param cache a coarse pass's QueryCache: `xyz` then holds only the
            new fine samples (R * Kf, ray-major), and the MLP evaluates the
            cached and the new samples in two calls, ordered [cached (Kc) |
            new (Kf)] along each ray's sample axis
        :return (SB, B, 4) [sigmoid(rgb), relu(sigma)], float32; with
            want_cache, (out, QueryCache)
        """
        with span("pnt.query.coarse" if coarse else "pnt.query.fine"):
            return self._query(enc, xyz, viewdirs, coarse, want_cache, cache)

    def _query(self, enc, xyz, viewdirs, coarse, want_cache, cache):
        SB, B, _ = xyz.shape
        NS = enc.num_views
        xyz_rep = repeat_interleave(xyz, NS)  # (SB*NS, B, 3)
        rot = enc.poses[:, :3, :3]
        # rotation as broadcast multiply + 3-term sum, as the JAX model
        xyz_rot = (rot[:, None] * xyz_rep[:, :, None, :]).sum(dim=-1)
        xyz_cam = xyz_rot + enc.poses[:, None, :3, 3]

        if self._posenc_fused_ok():
            base = (xyz_rot if self.normalize_z else xyz_cam).reshape(-1, 3)
            vd = repeat_interleave(viewdirs.reshape(SB, B, 3), NS)
            vd = (rot[:, None] * vd[:, :, None, :]).sum(dim=-1)
            mlp_input = posenc_concat(
                base, vd.reshape(-1, 3), self.code.num_freqs,
                self.code.freq_factor, out_dtype=self.dtype,
            )
        else:
            if self.use_xyz:
                z_feature = (xyz_rot if self.normalize_z else xyz_cam).reshape(-1, 3)
            else:
                z_feature = -(
                    xyz_rot[..., 2] if self.normalize_z else xyz_cam[..., 2]
                ).reshape(-1, 1)
            if self.use_code and not self.use_code_viewdirs:
                z_feature = self.code(z_feature)
            if self.use_viewdirs:
                vd = repeat_interleave(viewdirs.reshape(SB, B, 3), NS)
                vd = (rot[:, None] * vd[:, :, None, :]).sum(dim=-1)
                z_feature = torch.cat([z_feature, vd.reshape(-1, 3)], dim=1)
            if self.use_code and self.use_code_viewdirs:
                z_feature = self.code(z_feature)
            mlp_input = z_feature

        mlp = self.mlp_coarse if (coarse or self.mlp_fine is None) else self.mlp_fine

        # perspective projection into each source view
        uv = -xyz_cam[:, :, :2] / xyz_cam[:, :, 2:]
        focal, cc = enc.focal, enc.c
        if focal.shape[0] > 1:
            focal = repeat_interleave(focal, NS)
        if cc.shape[0] > 1:
            cc = repeat_interleave(cc, NS)
        uv = uv * focal[:, None, :] + cc[:, None, :]

        if self._field_fused_ok(enc, mlp, NS):
            if want_cache or cache is not None:
                raise ValueError("the fused field path forms no latent to cache")
            grid = uv * (enc.latent_scaling / enc.image_size) - 1.0
            fi = FieldInput(
                feats=tuple(enc.latent), grid=grid,
                x=mlp_input.to(enc.latent[0].dtype),
            )
            with span("pnt.mlp.fwd"):
                out = mlp(fi, combine_inner_dims=(NS, B))
            return self._head(out, SB, B)

        # the coarse pass's latent has two consumers, the coarse MLP and the
        # fine pass's cache: a dual lookup hands the scatter both cotangents
        # (not with a global latent, which is prepended before either)
        want_dual = bool(want_cache) and not self.use_global_encoder
        with span("pnt.lookup"):
            latent = index_features(
                enc.latent, enc.latent_scaling, uv, enc.image_size,
                index_interp=self.encoder.index_interp,
                index_padding=self.encoder.index_padding,
                upsample_interp=self.encoder.upsample_interp,
                dual=want_dual,
                allow_fused=self.use_fused_gather,
            )
        latent, latent_cache = latent if want_dual else (latent, None)
        if self.stop_encoder_grad:
            latent = latent.detach()
            latent_cache = None if latent_cache is None else latent_cache.detach()
        latent = latent.reshape(-1, latent.shape[-1])
        if self.use_global_encoder:
            gl = repeat_interleave(enc.global_latent, latent.shape[0] // enc.global_latent.shape[0])
            latent = torch.cat([gl.to(latent.dtype), latent], dim=-1)
        if want_cache and latent_cache is None:
            latent_cache = latent
        C = latent.shape[-1]
        x = mlp_input.to(latent.dtype)
        if cache is not None:
            # two MLP calls over the disjoint [cached | new] rows, then a
            # per-ray concat of the (R, K, 4) outputs
            r_rays, kc = cache.z.shape[1], cache.z.shape[2]
            kf = B // r_rays
            with span("pnt.mlp.fwd"):
                out_c = mlp(
                    (cache.z.reshape(-1, C), cache.x.reshape(-1, cache.x.shape[-1])),
                    combine_inner_dims=(NS, r_rays * kc),
                )
            with span("pnt.mlp.fwd"):
                out_n = mlp((latent, x), combine_inner_dims=(NS, B))
            mlp_output = torch.cat(
                [out_c.reshape(SB, r_rays, kc, -1), out_n.reshape(SB, r_rays, kf, -1)], dim=2
            )
            return self._head(mlp_output, SB, r_rays * (kc + kf))
        with span("pnt.mlp.fwd"):
            out = mlp((latent, x), combine_inner_dims=(NS, B))
        out = self._head(out, SB, B)
        if not want_cache:
            return out
        per_ray = lambda a: a.reshape(SB * NS, -1, want_cache, a.shape[-1])
        return out, QueryCache(z=per_ray(latent_cache.reshape(-1, C)), x=per_ray(x))

    def _head(self, mlp_output: torch.Tensor, SB: int, B: int) -> torch.Tensor:
        """rgb sigmoid and sigma relu heads in float32."""
        mlp_output = mlp_output.reshape(-1, B, self.d_out).float()
        rgb = torch.sigmoid(mlp_output[..., :3])
        sigma = torch.relu(mlp_output[..., 3:4])
        return torch.cat([rgb, sigma], dim=-1).reshape(SB, B, -1)


def _make_mlp(conf, d_in: int, d_latent: int, d_out: int, dtype, allow_empty=False,
              use_pallas="auto"):
    mlp_type = conf.get_string("type", "mlp") if conf else "empty"
    if mlp_type == "resnet":
        return ResnetFC.from_conf(conf, d_in, d_latent=d_latent, d_out=d_out, dtype=dtype,
                                  use_pallas=use_pallas)
    if mlp_type == "mlp":
        return ImplicitNet.from_conf(conf, d_in + d_latent, d_out=d_out, dtype=dtype)
    if mlp_type == "empty" and allow_empty:
        return None
    raise NotImplementedError(f"unsupported MLP type {mlp_type}")


def make_model(
    conf, dtype=None, device=None, seed: int = 0, train: bool = False,
    stop_encoder_grad: bool = False, use_pallas="auto",
) -> PixelNeRFNet:
    """Build a PixelNeRFNet from a 'model' config subtree, in eval mode (or
    train mode with `train`), on `device` (CUDA unless the caller passes
    one; see device.resolve_device).

    `dtype` is the compute dtype (parameters stay float32): conf key
    `dtype` ('float32' | 'bfloat16'), overridable by the argument. `seed`
    seeds the random initialization without touching the global generator
    (`backbone = custom` makes one convolution at its first input:
    `PixelNeRFNet.init_shapes`).

    `use_pallas` ("auto" | True | False) is the JAX `make_model`'s switch
    of its Pallas kernels, read for the port's kernels. "auto" (the
    default, the CLIs' too): on the card the ResnetFC kernels take every
    config the JAX package's kernels take on its TPU, bf16 and float32
    alike; off the card bf16 models take the kernels' plain versions and
    float32 models the exact per-layer chain. True: the ResnetFC kernel
    route on every device (the plain versions on the CPU, the counterpart
    of JAX's interpret mode). False: no kernel anywhere, the per-layer
    MLP, the composed lookup and plain posenc, as the JAX package with
    use_pallas=False. The lookups, posenc and the field take bf16 models
    only, under "auto" and True alike (ResnetFC.fused_ok).
    """
    device = resolve_device(device)
    if dtype is None:
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            conf.get_string("dtype", "float32")
        ]
    if not conf.get_bool("use_encoder", True):
        # the JAX model's encode() calls its encoder unconditionally
        raise NotImplementedError("use_encoder = False: encode needs the pixel-aligned encoder")
    use_global_encoder = conf.get_bool("use_global_encoder", False)
    use_xyz = conf.get_bool("use_xyz", False)
    use_viewdirs = conf.get_bool("use_viewdirs", False)
    use_code = conf.get_bool("use_code", False)
    use_code_viewdirs = conf.get_bool("use_code_viewdirs", True)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        encoder = SpatialEncoder.from_conf(conf.get_config("encoder"), dtype=dtype)
        d_latent = encoder.latent_size
        d_in = 3 if use_xyz else 1
        if use_viewdirs and use_code_viewdirs:
            d_in += 3
        code = None
        if use_code and d_in > 0:
            code = PositionalEncoding.from_conf(conf.get_config("code"), d_in=d_in)
            d_in = code.d_out
        if use_viewdirs and not use_code_viewdirs:
            d_in += 3
        global_encoder = None
        if use_global_encoder:
            global_encoder = ImageEncoder.from_conf(conf.get_config("global_encoder"), dtype=dtype)
            d_latent += global_encoder.latent_size
        mlp_coarse = _make_mlp(conf.get_config("mlp_coarse"), d_in, d_latent, 4, dtype,
                               use_pallas=use_pallas)
        mlp_fine = _make_mlp(
            conf.get_config("mlp_fine"), d_in, d_latent, 4, dtype, allow_empty=True,
            use_pallas=use_pallas,
        )
    model = PixelNeRFNet(
        encoder=encoder, code=code, mlp_coarse=mlp_coarse, mlp_fine=mlp_fine,
        d_in=d_in, d_latent=d_latent, use_xyz=use_xyz,
        normalize_z=conf.get_bool("normalize_z", True), use_code=use_code,
        use_code_viewdirs=use_code_viewdirs, use_viewdirs=use_viewdirs,
        stop_encoder_grad=stop_encoder_grad, global_encoder=global_encoder, dtype=dtype,
        use_fused_gather=use_pallas is not False,
    )
    return model.to(device).train(train)

