"""Export / import compact bf16 model checkpoints for in-repo archival.

Counterpart of `pixelnerf_tpu/tools/export_checkpoint.py`. `export` casts
every float leaf except the batch statistics to bfloat16 (round to nearest
even) and writes the flax msgpack layout of `artifacts/srn600_bf16.ckpt`;
`import` casts back up to float32 and writes a live `pixel_nerf_latest`
in the same layout, which either package's CLIs load. The source of
`export` is a flax msgpack checkpoint (the JAX package's, or an artifact)
or the port's own torch checkpoint, whose state_dict goes to the JAX
variables through `convert.jax_from_state_dict`. The files are read and
written by the port's own msgpack code (`utils/checkpoint.py`), bytes for
bytes as flax writes them, so either package's `import` reads the other's
`export`.

    python -m pixelnerf_tpu_torch.tools.export_checkpoint export \\
        --ckpt checkpoints/srn600/pixel_nerf_latest --out checkpoints/srn600_bf16.ckpt
    python -m pixelnerf_tpu_torch.tools.export_checkpoint import \\
        --artifact checkpoints/srn600_bf16.ckpt --ckpt /tmp/ck/srn600/pixel_nerf_latest
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pixelnerf_tpu_torch.utils import checkpoint as ckpt


def _map_leaves(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _cast_down(path, leaf):
    arr = np.asarray(leaf)
    if arr.dtype == np.float32 and "batch_stats" not in path:
        return ckpt.Bfloat16.from_float32(arr)
    return arr


def _read_tree(path: str):
    """A checkpoint's JAX variables tree: a flax msgpack file as it is
    (bf16 leaves read as float32, exactly), a port torch checkpoint
    through `convert.jax_from_state_dict`."""
    if ckpt.is_flax_checkpoint(path):
        return ckpt.read_flax_msgpack(path)
    from pixelnerf_tpu_torch.convert import jax_from_state_dict

    return jax_from_state_dict(ckpt.load_state(path, "cpu"))


def export(ckpt_path: str, out_path: str) -> None:
    ckpt.write_flax_msgpack(out_path, _map_leaves(_read_tree(ckpt_path), _cast_down))
    print(
        f"Wrote {out_path}: {os.path.getsize(out_path) / 1e6:.1f} MB "
        f"(from {os.path.getsize(ckpt_path) / 1e6:.1f} MB)"
    )


def import_(artifact_path: str, ckpt_path: str) -> None:
    os.makedirs(os.path.dirname(ckpt_path) or ".", exist_ok=True)
    ckpt.write_flax_msgpack(ckpt_path, ckpt.read_flax_msgpack(artifact_path))
    print(f"Wrote {ckpt_path}: {os.path.getsize(ckpt_path) / 1e6:.1f} MB")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=("export", "import"))
    parser.add_argument("--ckpt", type=str, required=True,
                        help="live pixel_nerf_latest path (source for "
                        "export, destination for import)")
    parser.add_argument("--out", type=str, default=None,
                        help="export: artifact output path")
    parser.add_argument("--artifact", type=str, default=None,
                        help="import: bf16 artifact path")
    args = parser.parse_args(argv)
    if args.mode == "export":
        if not args.out:
            parser.error("export requires --out")
        export(args.ckpt, args.out)
    else:
        if not args.artifact:
            parser.error("import requires --artifact")
        import_(args.artifact, args.ckpt)


if __name__ == "__main__":
    main()
