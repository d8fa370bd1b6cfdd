"""Weight bridge from the JAX package's variables to the port's state_dict.

Takes the `{"params": ..., "batch_stats": ...}` tree of a JAX
`PixelNeRFNet` (nested dicts of numpy arrays, e.g. a checkpoint read with
`flax.serialization.msgpack_restore`) and returns the port's
`state_dict`. The port's module paths equal the Flax scopes with `/`
written as `.`, so each leaf maps by its kind:

- Dense `kernel` (in, out) -> `nn.Linear.weight` (out, in), `bias` kept;
- Conv `kernel` HWIO -> `nn.Conv2d.weight` OIHW;
- BatchNorm `scale`/`bias` + `batch_stats` `mean`/`var` ->
  `weight`/`bias`/`running_mean`/`running_var`; a GroupNorm's `scale`
  (no batch statistics) -> `weight`;
- ConvTranspose `kernel` HWIO -> OIHW, the port's transposed convolutions
  applying it unflipped to the dilated input, as `lax.conv_transpose`.

bf16 leaves are cast up to float32. Any leaf left unused, and any
parameter of the model that received no leaf, raises. The BatchNorm
buffers take the batch statistics, the running averages that a train
step updates.

`params_from_jax` maps a tree shaped like `params` alone, a gradient tree
of `jax.grad` for instance, onto the port's parameter names, so that two
trees compare by name. `jax_from_state_dict` is the inverse of
`state_dict_from_jax`: the JAX variables of a port state_dict, as float32
numpy arrays, which the JAX package's checkpoint files hold.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "params_from_jax", "jax_from_state_dict"]


def _f32(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))


def _flatten(tree, prefix=()) -> Dict[tuple, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _param_leaf(path, leaf):
    """(port name, float32 tensor) of one `params` leaf."""
    scope, name = path[:-1], path[-1]
    key = ".".join(scope)
    arr = np.asarray(leaf)
    if name == "kernel" and arr.ndim == 4:
        return f"{key}.weight", _f32(arr).permute(3, 2, 0, 1).contiguous()
    if name == "kernel" and arr.ndim == 2:
        return f"{key}.weight", _f32(arr).t().contiguous()
    if name == "scale":
        return f"{key}.weight", _f32(arr)
    if name == "bias":
        return f"{key}.bias", _f32(arr)
    raise ValueError(f"unrecognized leaf {'/'.join(path)} of shape {arr.shape}")


def params_from_jax(
    params: dict, model: Optional[torch.nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """{port parameter name: float32 tensor} for a JAX `params`-shaped tree
    (parameters or their gradients), in the port's orientation. With
    `model`, also checks that the names are exactly the model's parameters,
    with matching shapes."""
    out = dict(_param_leaf(path, leaf) for path, leaf in _flatten(params).items())
    if model is not None:
        want = dict(model.named_parameters())
        if set(out) != set(want):
            raise ValueError(
                f"missing {sorted(set(want) - set(out))}; unused {sorted(set(out) - set(want))}"
            )
        for k, v in out.items():
            if tuple(v.shape) != tuple(want[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != {tuple(want[k].shape)}")
    return out


def state_dict_from_jax(
    variables: dict, model: Optional[torch.nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """The port's state_dict for JAX `variables`.

    With `model`, also checks that the result covers exactly the model's
    state_dict keys, with matching shapes.
    """
    params = _flatten(variables.get("params", {}))
    stats = _flatten(variables.get("batch_stats", {}))
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unused top-level collections: {sorted(unknown)}")
    used = set()
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in params.items():
        name, tensor = _param_leaf(path, leaf)
        sd[name] = tensor
        key, scope = ".".join(path[:-1]), path[:-1]
        if path[-1] == "scale" and scope + ("mean",) in stats:  # a BatchNorm; else a GroupNorm
            for jax_name, torch_name in (("mean", "running_mean"), ("var", "running_var")):
                stat = scope + (jax_name,)
                if stat not in stats:
                    raise ValueError(f"batch_stats missing for {'/'.join(scope)}")
                sd[f"{key}.{torch_name}"] = _f32(stats[stat])
                used.add(("batch_stats",) + stat)
        used.add(("params",) + path)
    unused = [
        "batch_stats/" + "/".join(p) for p in stats if ("batch_stats",) + p not in used
    ]
    if unused:
        raise ValueError(f"unused leaves: {unused}")
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(sd))
        extra = sorted(set(sd) - set(want))
        if missing or extra:
            raise ValueError(f"missing keys {missing}; unused keys {extra}")
        for k, v in sd.items():
            # a parameter still to be made at the first input takes the leaf's shape
            if not torch.nn.parameter.is_lazy(want[k]) and tuple(v.shape) != tuple(want[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != {tuple(want[k].shape)}")
    return sd


def jax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> dict:
    """`{"params": ..., "batch_stats": ...}` of nested dicts of float32
    numpy arrays for a port state_dict: weights back to Flax's (in, out)
    and HWIO kernels, a 1-D weight to a norm's `scale`, the BatchNorm
    buffers to the batch statistics."""
    out: dict = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        *scope, leaf = name.split(".")
        a = t.detach().cpu().float().numpy()
        if leaf == "weight" and a.ndim == 4:
            coll, key, a = "params", "kernel", a.transpose(2, 3, 1, 0)
        elif leaf == "weight" and a.ndim == 2:
            coll, key, a = "params", "kernel", a.T
        elif leaf == "weight" and a.ndim == 1:
            coll, key = "params", "scale"
        elif leaf == "bias":
            coll, key = "params", "bias"
        elif leaf in ("running_mean", "running_var"):
            coll, key = "batch_stats", leaf[len("running_"):]
        else:
            raise ValueError(f"unrecognized state_dict entry {name} of shape {tuple(a.shape)}")
        node = out[coll]
        for part in scope:
            node = node.setdefault(part, {})
        node[key] = np.ascontiguousarray(a)
    if not out["batch_stats"]:
        del out["batch_stats"]  # group norms only
    return out
