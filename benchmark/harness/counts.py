"""Operations and bytes of the work a step or a view needs, by function.

Counted from the shapes alone, so any implementation is held to the same
work: each input read once and each output written once, whatever a
kernel reads again; matrix products at 2 operations a multiply-add. The
ResnetFC counts are the products of the configured MLP at the rows that
call sees: before the pooling every view's rows, after it one row a
sample. Recomputation (remat), gathers, posenc, the renderer and
BatchNorm are not counted as operations. Unlike the TPU count kept in the
repository's PERFORMANCE.md, there are no one-hot expander products: the
program gathers.

Peaks: one NVIDIA H100 SXM, dense, from NVIDIA's data sheet (700 W).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BF16, F32 = 2, 4


def least_seconds(flops: float, nbytes: float, flop_rate: float = PEAK_BF16_FLOPS) -> float:
    """The roofline: the larger of the operations' and the bytes' time."""
    return max(flops / flop_rate, nbytes / PEAK_BYTES)


# ----------------------------------------------------------------- ResnetFC


def mlp_params(mlp: dict, d_in: int, d_latent: int, d_out: int = 4) -> int:
    h, n_blocks = int(mlp["d_hidden"]), int(mlp["n_blocks"])
    n_inj = min(int(mlp["combine_layer"]), n_blocks)
    return (d_in + 1) * h + n_inj * (d_latent + 1) * h + n_blocks * 2 * (h + 1) * h + (h + 1) * d_out


def mlp_forward_flops(mlp: dict, d_in: int, d_latent: int, rows: int, views: int,
                      d_out: int = 4) -> float:
    """Products of one ResnetFC forward over `rows` pre-pool rows (every
    view's), `rows / views` after the pooling."""
    h, n_blocks = int(mlp["d_hidden"]), int(mlp["n_blocks"])
    combine = min(int(mlp["combine_layer"]), n_blocks)
    post = rows // views
    macs = rows * (d_in * h + combine * d_latent * h + combine * 2 * h * h)
    macs += post * ((n_blocks - combine) * 2 * h * h + h * d_out)
    return 2.0 * macs


def mlp_stash_forward(mlp, d_in, d_latent, rows, views, d_out=4) -> Tuple[float, float]:
    """(operations, bytes) of the forward that keeps what the backward
    needs: reads z and x (bf16) and the weights (float32), writes the
    outputs (float32)."""
    flops = mlp_forward_flops(mlp, d_in, d_latent, rows, views, d_out)
    nbytes = rows * (d_latent + d_in) * BF16 + mlp_params(mlp, d_in, d_latent, d_out) * F32
    return flops, nbytes + rows // views * d_out * F32


def mlp_backward(mlp, d_in, d_latent, rows, views, d_out=4) -> Tuple[float, float]:
    """(operations, bytes) of the backward: the cotangent and the weight
    gradients of every product, twice the forward's operations; reads z,
    x, the output cotangent and the weights, writes dz and the weight
    gradients."""
    flops = 2.0 * mlp_forward_flops(mlp, d_in, d_latent, rows, views, d_out)
    p = mlp_params(mlp, d_in, d_latent, d_out)
    nbytes = rows * (d_latent + d_in) * BF16 + rows // views * d_out * F32 + p * F32
    return flops, nbytes + rows * d_latent * BF16 + p * F32


# ----------------------------------------------------------------- lookup


def level_bytes(levels: Iterable[Tuple[int, int, int]], maps: int, item: int = BF16) -> int:
    return maps * sum(h * w * c for h, w, c in levels) * item


def field_primal(mlp, d_in, d_latent, rows, views, levels, maps, d_out=4) -> Tuple[float, float]:
    """(operations, bytes) of the fused lookup-and-field forward: the
    MLP's products (the lookup's interpolation is not counted); reads the
    feature levels, the sample grid (float32 pairs), x and the weights,
    writes the outputs."""
    flops = mlp_forward_flops(mlp, d_in, d_latent, rows, views, d_out)
    nbytes = level_bytes(levels, maps) + rows * (2 * F32 + d_in * BF16)
    nbytes += mlp_params(mlp, d_in, d_latent, d_out) * F32 + rows // views * d_out * F32
    return flops, nbytes


def pyramid_gather(rows: int, levels, maps: int, d_latent: int) -> Tuple[float, float]:
    """(operations, bytes): reads the levels and the grid, writes z."""
    return 0.0, level_bytes(levels, maps) + rows * 2 * F32 + rows * d_latent * BF16


def pyramid_scatter(rows: int, levels, maps: int, d_latent: int) -> Tuple[float, float]:
    """(operations, bytes): reads dz and the grid, writes the levels'
    float32 gradients."""
    return 0.0, rows * d_latent * BF16 + rows * 2 * F32 + level_bytes(levels, maps, F32)


# ----------------------------------------------------------------- encoder


def trunk_convs(encoder: dict, h: int, w: int, arch) -> List[Tuple[int, int, int, int, int, int]]:
    """(cin, cout, k, stride, h_out, w_out) of every convolution of the
    trunk on an h x w image, with the stages of `arch` (`STAGE_BLOCKS`,
    `STAGE_CHANNELS`: `reference/pixelnerf.py`, as
    `families/pixelnerf.py` hands it); the stem's max-pool halves the size
    before the first stage unless `use_first_pool` is false."""
    out_hw = lambda n, k, s, p: (n + 2 * p - k) // s + 1
    h, w = out_hw(h, 7, 2, 3), out_hw(w, 7, 2, 3)
    convs = [(3, 64, 7, 2, h, w)]
    if encoder.get("use_first_pool", True):
        h, w = out_hw(h, 3, 2, 1), out_hw(w, 3, 2, 1)
    cin = 64
    for stage in range(int(encoder["num_layers"]) - 1):
        cout = arch.STAGE_CHANNELS[stage]
        for blk in range(arch.STAGE_BLOCKS[encoder["backbone"]][stage]):
            stride = 2 if (stage > 0 and blk == 0) else 1
            ho, wo = out_hw(h, 3, stride, 1), out_hw(w, 3, stride, 1)
            convs += [(cin, cout, 3, stride, ho, wo), (cout, cout, 3, 1, ho, wo)]
            if stride != 1 or cin != cout:
                convs.append((cin, cout, 1, stride, ho, wo))
            h, w, cin = ho, wo, cout
    return convs


def encoder_flops(encoder: dict, images: int, h: int, w: int, train: bool, arch) -> float:
    """The trunk's convolutions: forward; in training also the weight
    gradient of each and the input gradient of all but the stem's."""
    total = 0.0
    for i, (cin, cout, k, _, ho, wo) in enumerate(trunk_convs(encoder, h, w, arch)):
        fwd = 2.0 * images * ho * wo * cout * cin * k * k
        total += fwd * ((2 if i == 0 else 3) if train else 1)
    return total


# ----------------------------------------------------------------- a cell


def latent_levels(h: int, w: int, use_first_pool: bool = True) -> List[Tuple[int, int, int]]:
    """The native levels the program packs for an h x w image (stem and
    layer1 at the stem's size, then layer2 and layer3); layer1 runs at
    half the stem's size after the max-pool, at the stem's without it."""
    s = lambda n, k: (n + 2 * (k // 2) - k) // 2 + 1
    h1, w1 = s(h, 7), s(w, 7)
    h2, w2 = (s(h1, 3), s(w1, 3)) if use_first_pool else (h1, w1)
    h3, w3 = s(h2, 3), s(w2, 3)
    return [(h1, w1, 128), (h3, w3, 128), (s(h3, 3), s(w3, 3), 256)]


def cell_work(config: dict, traffic: dict, arch) -> Dict[str, float]:
    """Operations and bytes of one step (train) or one view, by function;
    `arch` gives the sizes (`dims`) and the trunk's stages."""
    conf, data = config["conf"], config["data"]
    model, rend = conf["model"], conf["renderer"]
    d = arch.dims(model)
    ns = int(data["source_views"])
    h, w = data["image_hw"]
    kc = int(rend["n_coarse"])
    kall = kc + int(rend["n_fine"])
    mc, mf = model["mlp_coarse"], model["mlp_fine"]
    args = (d["d_in"], d["d_latent"])
    if traffic["kind"] == "train":
        rays = int(traffic["objects_per_step"]) * int(traffic["rays_per_object"])
        images = int(traffic["objects_per_step"]) * ns
        calls = [(mc, rays * kc), (mf, rays * kall)]
        fwd = [mlp_stash_forward(m, *args, r * ns, ns) for m, r in calls]
        bwd = [mlp_backward(m, *args, r * ns, ns) for m, r in calls]
        enc = encoder_flops(model["encoder"], images, h, w, train=True, arch=arch)
        return {
            "mlp_flops": sum(f for f, _ in fwd + bwd),
            "mlp_least_s": sum(least_seconds(f, b) for f, b in fwd + bwd),
            "encoder_flops": enc,
            "model_flops": sum(f for f, _ in fwd + bwd) + enc,
            "rays": float(rays),
        }
    rays = h * w
    chunk = int(traffic["chunk_rays"])
    padded = -(-rays // chunk) * chunk
    levels = latent_levels(h, w, model["encoder"].get("use_first_pool", True))
    # the field's calls see the padded chunks; the model needs the view's rays
    field = [field_primal(m, *args, padded * k * ns, ns, levels, ns)
             for m, k in ((mc, kc), (mf, kall))]
    enc = encoder_flops(model["encoder"], ns, h, w, train=False, arch=arch)
    mlp = sum(mlp_forward_flops(m, *args, rays * k * ns, ns) for m, k in ((mc, kc), (mf, kall)))
    return {
        "field_least_s": sum(least_seconds(f, b) for f, b in field),
        "mlp_flops": mlp,
        "encoder_flops": enc,
        "model_flops": mlp + enc,
        "rays": float(rays),
    }
