"""Weight bridge from the JAX package's variables to the port's state_dict.

Takes the `{"params": ..., "batch_stats": ...}` tree of a JAX
`PixelNeRFNet` (nested dicts of numpy arrays, e.g. a checkpoint read with
`flax.serialization.msgpack_restore`) and returns the port's
`state_dict`. The port's module paths equal the Flax scopes with `/`
written as `.`, so each leaf maps by its kind:

- Dense `kernel` (in, out) -> `nn.Linear.weight` (out, in), `bias` kept;
- Conv `kernel` HWIO -> `nn.Conv2d.weight` OIHW;
- BatchNorm `scale`/`bias` + `batch_stats` `mean`/`var` ->
  `weight`/`bias`/`running_mean`/`running_var`.

bf16 leaves are cast up to float32. Any leaf left unused, and any
parameter of the model that received no leaf, raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["state_dict_from_jax"]


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
        scope, name = path[:-1], path[-1]
        key = ".".join(scope)
        arr = np.asarray(leaf)
        if name == "kernel" and arr.ndim == 4:
            sd[f"{key}.weight"] = _f32(arr).permute(3, 2, 0, 1).contiguous()
        elif name == "kernel" and arr.ndim == 2:
            sd[f"{key}.weight"] = _f32(arr).t().contiguous()
        elif name == "scale":
            sd[f"{key}.weight"] = _f32(arr)
            for jax_name, torch_name in (("mean", "running_mean"), ("var", "running_var")):
                stat = scope + (jax_name,)
                if stat not in stats:
                    raise ValueError(f"batch_stats missing for {'/'.join(scope)}")
                sd[f"{key}.{torch_name}"] = _f32(stats[stat])
                used.add(("batch_stats",) + stat)
        elif name == "bias":
            sd[f"{key}.bias"] = _f32(arr)
        else:
            raise ValueError(f"unrecognized leaf {'/'.join(path)} of shape {arr.shape}")
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
            if tuple(v.shape) != tuple(want[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != {tuple(want[k].shape)}")
    return sd
