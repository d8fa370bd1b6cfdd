"""The ResnetFC backward split as the program runs it: the cotangent chain
and the weight-gradient products (`wgrad`), each counted as
`harness/counts.py` counts a function (each input read once, each output
written once). Their operations sum to `counts.mlp_backward`'s: the chain
takes each product's input cotangent, `wgrad` its weight gradient, one
forward's operations each.
"""

from __future__ import annotations

from typing import Dict, Tuple

from harness.counts import (
    BF16, F32, least_seconds, mlp_forward_flops, mlp_params, mlp_stash_forward,
)


def mlp_backward_chain(mlp, d_in, d_latent, rows, views, d_out=4) -> Tuple[float, float]:
    """(operations, bytes): reads z, x, the output cotangent and the
    weights, writes dz."""
    flops = mlp_forward_flops(mlp, d_in, d_latent, rows, views, d_out)
    nbytes = rows * (d_latent + d_in) * BF16 + rows // views * d_out * F32
    nbytes += mlp_params(mlp, d_in, d_latent, d_out) * F32 + rows * d_latent * BF16
    return flops, nbytes


def mlp_wgrad(mlp, d_in, d_latent, rows, views, d_out=4) -> Tuple[float, float]:
    """(operations, bytes): reads z and x, writes the weight gradients."""
    flops = mlp_forward_flops(mlp, d_in, d_latent, rows, views, d_out)
    nbytes = rows * (d_latent + d_in) * BF16 + mlp_params(mlp, d_in, d_latent, d_out) * F32
    return flops, nbytes


def train_parts(config: dict, traffic: dict, arch) -> Dict[str, float]:
    """Least seconds of one training step's stash forwards, backward
    chains and weight-gradient products, at the rows `counts.cell_work`
    counts with the same `arch`."""
    conf, data = config["conf"], config["data"]
    model, rend = conf["model"], conf["renderer"]
    d = arch.dims(model)
    ns = int(data["source_views"])
    rays = int(traffic["objects_per_step"]) * int(traffic["rays_per_object"])
    kc = int(rend["n_coarse"])
    calls = [(model["mlp_coarse"], rays * kc), (model["mlp_fine"], rays * (kc + int(rend["n_fine"])))]
    least = lambda fn: sum(least_seconds(*fn(m, d["d_in"], d["d_latent"], r * ns, ns))
                           for m, r in calls)
    return {"mlp_fwd_least_s": least(mlp_stash_forward),
            "mlp_chain_least_s": least(mlp_backward_chain),
            "mlp_wgrad_least_s": least(mlp_wgrad)}
