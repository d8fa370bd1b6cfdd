"""Image encoders and the feature lookup.

Counterpart of `pixelnerf_tpu/models/encoder.py`: `SpatialEncoder` (on the
ResNet trunk, or the experimental `ConvEncoder` for `backbone = custom`),
the global `ImageEncoder`, `latent_scaling_for`, `pack_pyramid_levels`,
`compose_pyramid` and `index_features`, which looks native levels up with
the pyramid kernels (ops/pyramid.py) and a single bf16 map with the bilerp
kernels (ops/scatter.py) under the JAX package's predicates, or on the card
at any size, and composes the upsampled map for every other lookup. Layout
is NHWC.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.lazy import LazyModuleMixin

from pixelnerf_tpu_torch.models.resnet import ResNetTrunk, make_norm
from pixelnerf_tpu_torch.ops.grid_sample import grid_sample_2d
from pixelnerf_tpu_torch.ops.interpolate import resize_area, resize_bilinear, resize_nearest
from pixelnerf_tpu_torch.ops.pyramid import (
    pyramid_index_train, pyramid_index_train_dual, pyramid_supported,
)
from pixelnerf_tpu_torch.ops.scatter import fused_supported, grid_sample_border_train

__all__ = [
    "SpatialEncoder",
    "ImageEncoder",
    "ConvEncoder",
    "latent_scaling_for",
    "pack_pyramid_levels",
    "compose_pyramid",
    "index_features",
    "pyramid_fused_ok",
]

# latent channel count by num_layers for resnet18/34
_LATENT_SIZES = [0, 64, 128, 256, 512, 1024]


def latent_scaling_for(latent_hw: Tuple[int, int], device=None) -> torch.Tensor:
    """(2,) [sx, sy] pixel-to-grid scaling s/(s-1)*2 of a (H, W) latent."""
    Hl, Wl = latent_hw
    s = np.array([Wl, Hl], dtype=np.float32)
    return torch.from_numpy(s / (s - 1.0) * 2.0).to(device)


def pyramid_fused_ok(
    levels, index_interp: str, index_padding: str, upsample_interp: str = "bilinear",
    allow_fused: bool = True,
) -> bool:
    """True when the native levels feed the pyramid kernels (ops/pyramid.py)
    and the fused field kernel (ops/field.py): `allow_fused`
    (make_model(use_pallas=False) clears it), bilinear upsample and lookup
    with border padding, bf16 levels, a fine grid of at most 8192 pixels.
    Otherwise `encode` composes the upsampled pyramid once."""
    return (
        allow_fused
        and index_interp == "bilinear"
        and index_padding == "border"
        and upsample_interp == "bilinear"
        and all(l.dtype == torch.bfloat16 for l in levels)
        and pyramid_supported(tuple(levels[0].shape[1:3]))
    )


def _resize_levels(levels, target_hw, upsample_interp, index_interp):
    """Resize levels to `target_hw` with `upsample_interp`. The bilinear
    align_corners choice keys on index_interp == "nearest " WITH the
    trailing space, as the reference compares it."""
    if upsample_interp.startswith("nearest"):
        return [resize_nearest(l, target_hw) for l in levels]
    align = None if index_interp == "nearest " else True
    return [resize_bilinear(l, target_hw, align_corners=bool(align)) for l in levels]


def compose_pyramid(
    levels, upsample_interp: str = "bilinear", index_interp: str = "bilinear"
) -> torch.Tensor:
    """The upsampled feature pyramid: every level resized to level 0's
    resolution, then channel-concatenated."""
    return torch.cat(
        _resize_levels(levels, levels[0].shape[1:3], upsample_interp, index_interp),
        dim=-1,
    )


def pack_pyramid_levels(
    levels: Sequence[torch.Tensor],
    upsample_interp: str = "bilinear",
    index_interp: str = "bilinear",
    lane_width: int = 128,
):
    """Merge adjacent levels, left to right, while a group's channel total
    stays <= `lane_width`: each group's coarser members are upsampled to
    its finest resolution and channel-concatenated. The concatenated
    channel order is unchanged."""
    levels = list(levels)
    groups = [[levels[0]]]
    for l in levels[1:]:
        if sum(g.shape[-1] for g in groups[-1]) + l.shape[-1] <= lane_width:
            groups[-1].append(l)
        else:
            groups.append([l])
    if all(len(g) == 1 for g in groups):
        return tuple(levels)
    out = []
    for g in groups:
        if len(g) == 1:
            out.append(g[0])
            continue
        ups = [g[0]] + _resize_levels(
            g[1:], g[0].shape[1:3], upsample_interp, index_interp
        )
        out.append(torch.cat(ups, dim=-1))
    return tuple(out)


def index_features(
    latent,
    latent_scaling: torch.Tensor,
    uv: torch.Tensor,
    image_size: torch.Tensor,
    index_interp: str = "bilinear",
    index_padding: str = "border",
    upsample_interp: str = "bilinear",
    dual: bool = False,
    allow_fused: bool = True,
):
    """Pixel-aligned lookup of (B, N, 2) image points (x, y) in input-pixel
    coordinates in a (B, Hl, Wl, C) map, or in a tuple of native levels.

    Native levels that `pyramid_fused_ok` accepts go through the pyramid
    kernels (gradient for the levels, none for uv); other levels are
    composed first. A bf16 map under a bilinear, border lookup goes through
    the bilerp kernels (`grid_sample_border_train`: gradient for the map,
    none for uv) if it has at most 8192 pixels (`fused_supported`, the JAX
    package's route) or is on the card, where a larger map takes the
    kernels with `grid_sample_2d`'s float32 tap weights; any other map goes
    through `grid_sample_2d`.

    :param allow_fused False: no kernel (the composed pyramid and
        `grid_sample_2d`), as make_model(use_pallas=False) asks
    :param dual return the latent twice, for two consumers (the coarse MLP
        and the fine pass's query cache); on the pyramid path the two
        cotangents are summed inside the scatter kernel, elsewhere autograd
        adds them
    :return (B, N, C); with dual, a pair of (B, N, C)
    """
    grid = uv * (latent_scaling / image_size) - 1.0
    if isinstance(latent, (tuple, list)):
        levels = tuple(latent)
        if pyramid_fused_ok(levels, index_interp, index_padding, upsample_interp, allow_fused):
            if dual:
                return pyramid_index_train_dual(levels, grid)
            return pyramid_index_train(levels, grid)
        latent = compose_pyramid(levels, upsample_interp, index_interp)
    if (
        allow_fused
        and index_interp == "bilinear"
        and index_padding == "border"
        and latent.dtype == torch.bfloat16
        and (latent.is_cuda or fused_supported(latent.shape[1], latent.shape[2]))
    ):
        out = grid_sample_border_train(latent, grid)
        return (out, out) if dual else out
    out = grid_sample_2d(
        latent, grid, padding_mode=index_padding, align_corners=True,
        mode=index_interp,
    )
    return (out, out) if dual else out


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) padding of XLA's SAME for a strided convolution."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_same(conv: nn.Conv2d, x: torch.Tensor, stride: int) -> torch.Tensor:
    """NCHW convolution with Flax's `padding="SAME"`, no bias, in x's dtype."""
    k = conv.weight.shape[-1]
    (t, b), (l, r) = _same_pads(x.shape[2], k, stride), _same_pads(x.shape[3], k, stride)
    return F.conv2d(F.pad(x, (l, r, t, b)), conv.weight.to(x.dtype), stride=stride)


def _conv_transpose_same(conv: nn.Conv2d, x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Flax `nn.ConvTranspose(strides=2, padding="SAME")` on NCHW: the input
    dilated by the stride, padded as `lax.conv_transpose` pads SAME, and
    convolved with the kernel unflipped (`transpose_kernel=False`); the
    bias, if any, added in x's dtype after the product, as Flax adds it."""
    k = conv.weight.shape[-1]
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    pad_b = pad_len - pad_a
    n, c, h, w = x.shape
    xd = x.new_zeros((n, c, (h - 1) * stride + 1, (w - 1) * stride + 1))
    xd[:, :, ::stride, ::stride] = x
    y = F.conv2d(F.pad(xd, (pad_a, pad_b, pad_a, pad_b)), conv.weight.to(x.dtype))
    if conv.bias is not None:
        y = y + conv.bias.to(x.dtype).reshape(1, -1, 1, 1)
    return y


def _plain_conv(cin: int, cout: int, k: int, bias: bool = False, fan_out: bool = True) -> nn.Conv2d:
    """An NCHW convolution's parameters, initialized as the Flax modules:
    kaiming-normal over fan_out (`_conv_init`), or LeCun-normal over fan_in
    (Flax's default, for `deconv_last`), zero bias."""
    conv = nn.Conv2d(cin, cout, k, bias=bias)
    fan = cout * k * k if fan_out else cin * k * k
    nn.init.normal_(conv.weight, std=float(np.sqrt((2.0 if fan_out else 1.0) / fan)))
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class _CodeDeconv(LazyModuleMixin, nn.Module):
    """`ConvEncoder`'s first transposed convolution, whose input is the
    global code beside the coarsest skip: 128 * ceil(H / 64) * ceil(W / 64)
    + 512 channels for an H x W input. Its weight is made at the first
    call from the input's width, as Flax infers it at init (or takes the
    width of the weight a state dict loads), and drawn from a generator
    seeded when the module was built, so one seed makes one set of
    weights."""

    def __init__(self, cout: int, k: int):
        super().__init__()
        self.weight = nn.parameter.UninitializedParameter()
        self.bias = None
        self.cout, self.k = cout, k
        self.seed = int(torch.randint(0, 2**62, ()))

    def initialize_parameters(self, x: torch.Tensor) -> None:
        if not self.has_uninitialized_params():  # a state dict made it
            return
        g = torch.Generator().manual_seed(self.seed)
        std = float(np.sqrt(2.0 / (self.cout * self.k * self.k)))  # kaiming over fan_out
        w = torch.randn((self.cout, x.shape[1], self.k, self.k), generator=g) * std
        self.weight.materialize(w.shape)
        with torch.no_grad():
            self.weight.copy_(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_transpose_same(self, x)


class ConvEncoder(nn.Module):
    """The experimental down/up conv net of `backbone = custom`
    (`pixelnerf_tpu/models/encoder.py:ConvEncoder` with the defaults
    `SpatialEncoder` builds it with): a 7x7/2 stem and three 3x3/2
    convolutions (SAME padding, group norm, leaky relu), a 4x4/4
    convolution flattened to a global code and broadcast back over the
    coarsest map, then 3x3/2 transposed convolutions over the skip
    concatenations, each cropped to its skip's shape, and a last transposed
    convolution to 128 channels. NHWC at its boundary: (B, H, W, 3) ->
    (B, H', W', 128), H' = 2 * the stem's height. The global code's width
    follows the input's size, so the first transposed convolution is made
    at the first call (`_CodeDeconv`)."""

    FIRST, MID, LAST, N_DOWN = 64, 128, 128, 3

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        first, mid, n_down = self.FIRST, self.MID, self.N_DOWN

        def down(name, cin, cout, k):
            self.add_module(name, _plain_conv(cin, cout, k))
            self.add_module(name + "_norm", make_norm("group", cout))

        down("conv_in", 3, first, 7)
        ch = first
        for i in range(n_down):
            down(f"conv{i}", ch, 2 * ch, 3)
            ch *= 2
        down("conv_mid", ch, mid, 4)
        ch = first * 2 ** (n_down - 1)
        self.add_module(f"deconv{n_down - 1}", _CodeDeconv(ch, 3))
        self.add_module(f"deconv{n_down - 1}_norm", make_norm("group", ch))
        cin, ch = ch, ch // 2
        for i in reversed(range(n_down - 1)):
            down(f"deconv{i}", cin + first * 2 ** (i + 1), ch, 3)  # + conv{i}'s channels
            cin, ch = ch, ch // 2
        self.deconv_last = _plain_conv(cin, self.LAST, 3, bias=True, fan_out=False)

    def _norm_act(self, name, x):
        return F.leaky_relu(getattr(self, name + "_norm")(x), 0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self._norm_act("conv_in", _conv_same(self.conv_in, x, 2))
        inters = []
        for i in range(self.N_DOWN):
            x = self._norm_act(f"conv{i}", _conv_same(getattr(self, f"conv{i}"), x, 2))
            inters.append(x)
        x = self._norm_act("conv_mid", _conv_same(self.conv_mid, x, 4))
        code = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten, as the JAX reshape
        h, w = inters[-1].shape[2:]
        x = code[:, :, None, None].expand(code.shape[0], code.shape[1], h, w)
        for i in reversed(range(self.N_DOWN)):
            x = torch.cat([x, inters[i]], dim=1)
            th, tw = inters[i - 1].shape[2:] if i > 0 else (
                inters[0].shape[2] * 2, inters[0].shape[3] * 2)
            conv = getattr(self, f"deconv{i}")
            if i == self.N_DOWN - 1 and not nn.parameter.is_lazy(conv.weight) \
                    and conv.weight.shape[1] != x.shape[1]:
                raise ValueError(
                    f"this ConvEncoder was built for a {conv.weight.shape[1] - inters[i].shape[1]}"
                    f"-channel global code, got {code.shape[1]} from a {tuple(inters[-1].shape[2:])} "
                    "coarsest map: the input is of another size than the one it was built on")
            x = (conv(x) if i == self.N_DOWN - 1 else _conv_transpose_same(conv, x))[:, :, :th, :tw]
            x = self._norm_act(f"deconv{i}", x)
        x = _conv_transpose_same(self.deconv_last, x)
        return x.permute(0, 2, 3, 1)


class SpatialEncoder(nn.Module):
    """Pixel-aligned feature encoder: a ResNet trunk's channel-packed
    native levels, finest first, or for `backbone = custom` the single map
    of `ConvEncoder`; with the pixel-to-grid scaling of level 0. The
    input is first resized by `feature_scale` (area below 1, bilinear with
    aligned corners above), as the JAX encoder does.
    """

    def __init__(
        self,
        backbone: str = "resnet34",
        num_layers: int = 4,
        index_interp: str = "bilinear",
        index_padding: str = "border",
        upsample_interp: str = "bilinear",
        feature_scale: float = 1.0,
        use_first_pool: bool = True,
        norm_type: str = "batch",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if backbone not in ("resnet18", "resnet34", "custom"):
            raise NotImplementedError(f"backbone {backbone} is not supported")
        self.backbone = backbone
        self.num_layers = num_layers
        self.index_interp = index_interp
        self.index_padding = index_padding
        self.upsample_interp = upsample_interp
        self.feature_scale = feature_scale
        if backbone == "custom":
            self.model = ConvEncoder(dtype=dtype)
        else:
            self.model = ResNetTrunk(
                backbone=backbone, num_stages=num_layers - 1,
                use_first_pool=use_first_pool, norm_type=norm_type, dtype=dtype,
            )

    @property
    def latent_size(self) -> int:
        return ConvEncoder.LAST if self.backbone == "custom" else _LATENT_SIZES[self.num_layers]

    def forward(self, x: torch.Tensor):
        """:param x images (B, H, W, 3) in [-1, 1]
        :return (levels tuple of (B, H_l, W_l, C_l), latent_scaling (2,));
            for `backbone = custom` one (B, H_l, W_l, 128) map in place of
            the tuple"""
        if self.feature_scale != 1.0:
            hw = (int(round(x.shape[1] * self.feature_scale)),
                  int(round(x.shape[2] * self.feature_scale)))
            x = (resize_area(x, hw) if self.feature_scale < 1.0
                 else resize_bilinear(x, hw, align_corners=True))
        if self.backbone == "custom":
            latent = self.model(x).contiguous()
            return latent, latent_scaling_for(latent.shape[1:3], x.device)
        latents = pack_pyramid_levels(
            self.model(x), self.upsample_interp, self.index_interp
        )
        latents = tuple(l.contiguous() for l in latents)
        return latents, latent_scaling_for(latents[0].shape[1:3], x.device)

    @classmethod
    def from_conf(cls, conf, **kwargs) -> "SpatialEncoder":
        return cls(
            backbone=conf.get_string("backbone"),
            num_layers=conf.get_int("num_layers", 4),
            index_interp=conf.get_string("index_interp", "bilinear"),
            index_padding=conf.get_string("index_padding", "border"),
            upsample_interp=conf.get_string("upsample_interp", "bilinear"),
            feature_scale=conf.get_float("feature_scale", 1.0),
            use_first_pool=conf.get_bool("use_first_pool", True),
            **kwargs,
        )


class ImageEncoder(nn.Module):
    """Global image encoder (`pixelnerf_tpu/models/encoder.py:ImageEncoder`):
    the whole ResNet trunk (four stages, first pool on), a global average
    pool, and a `fc` projection to `latent_size` unless that is 512.
    (B, H, W, 3) -> (B, latent_size) in the compute dtype."""

    def __init__(self, backbone: str = "resnet34", latent_size: int = 128,
                 norm_type: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.latent_size = latent_size
        self.dtype = dtype
        self.model = ResNetTrunk(backbone=backbone, num_stages=4, use_first_pool=True,
                                 norm_type=norm_type, dtype=dtype)
        self.fc = None
        if latent_size != 512:
            self.fc = nn.Linear(512, latent_size)
            # Flax Dense's default init: LeCun-normal over fan_in, zero bias
            nn.init.normal_(self.fc.weight, std=512 ** -0.5)
            nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.model(x)[-1].float().mean(dim=(1, 2)).to(self.dtype)
        if self.fc is not None:
            x = F.linear(x, self.fc.weight.to(self.dtype), self.fc.bias.to(self.dtype))
        return x

    @classmethod
    def from_conf(cls, conf, **kwargs) -> "ImageEncoder":
        return cls(
            backbone=conf.get_string("backbone"),
            latent_size=conf.get_int("latent_size", 128),
            **kwargs,
        )
