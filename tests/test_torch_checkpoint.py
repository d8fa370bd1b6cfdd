"""The port's flax msgpack reader (`utils/checkpoint.py:read_flax_msgpack`)
against `flax.serialization`: the trained bf16 artifact gives the tree
`msgpack_restore` gives, with the same keys and shapes and every value
bit for bit as float32 (bfloat16 widened exactly); the record kinds flax
writes (ndarrays of each dtype, numpy scalars, Python scalars, strings,
nested maps, chunked arrays); and the reader needs neither flax nor
msgpack. The live f32 checkpoint that the JAX training CLI writes, and a
resume from it, are held in tests/test_torch_eval_cli.py.
"""

import sys
from pathlib import Path

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.utils import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[1]
ARTIFACT = ROOT / "artifacts" / "srn600_bf16.ckpt"


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _same_tree(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (np.ndarray, np.generic)) or hasattr(w, "dtype"):
            w = np.asarray(w)
            if w.dtype.name == "bfloat16":
                w = w.astype(np.float32)
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert np.asarray(g).tobytes() == w.tobytes(), k
        else:
            assert type(g) is type(w) and g == w, k


def test_artifact_reads_as_flax_restores_it_bit_for_bit():
    got = ckpt.read_flax_msgpack(str(ARTIFACT))
    want = flax.serialization.msgpack_restore(ARTIFACT.read_bytes())
    kinds = {str(np.asarray(v).dtype) for _, v in _flat(want)}
    assert kinds == {"bfloat16", "float32"}  # bf16 parameters, f32 BatchNorm statistics
    _same_tree(got, want)
    assert ckpt.is_flax_checkpoint(str(ARTIFACT))
    assert ckpt.load_state(str(ARTIFACT)).keys() == {"params", "batch_stats"}


def test_reader_takes_every_record_kind_flax_writes(tmp_path, monkeypatch):
    import flax.serialization as fs

    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "bf16": jnp.asarray(rng.normal(size=(7,)), jnp.bfloat16),
        "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
        "u8": np.arange(300, dtype=np.uint8)[:4],
        "f64": np.float64(2.5),
        "i32s": np.int32(-7),
        "scalars": {"int": 3, "neg": -40000, "big": 2**40, "float": 0.125, "str": "abc",
                    "true": True, "none": None},
        "empty": {},
        "zero_d": np.asarray(1.5, np.float32),
        "long_name_" * 4: np.ones((0, 3), np.float32),
    }
    path = tmp_path / "tree"
    path.write_bytes(fs.to_bytes(tree))
    _same_tree(ckpt.read_flax_msgpack(str(path)), fs.msgpack_restore(path.read_bytes()))
    # flax's chunked form of an array past its chunk size
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    big = {"w": rng.normal(size=(5, 11)).astype(np.float32)}
    path.write_bytes(fs.msgpack_serialize(big))
    _same_tree(ckpt.read_flax_msgpack(str(path)), {"w": big["w"]})


def test_reader_needs_no_msgpack_and_no_flax(monkeypatch):
    for name in ("msgpack", "flax", "flax.serialization", "ml_dtypes"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import msgpack  # noqa: F401
    tree = ckpt.read_flax_msgpack(str(ARTIFACT))
    w = tree["params"]["mlp_coarse"]["lin_out"]["kernel"]
    assert w.dtype == np.float32 and w.shape == (512, 4)


def test_the_artifact_loads_into_the_flagship_model():
    """`load_model_weights` takes the bf16 artifact directly: every
    parameter and BatchNorm statistic as the JAX tree widened to float32."""
    from pixelnerf_tpu_torch.convert import state_dict_from_jax
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.utils.hocon import load

    model = make_model(load(str(ROOT / "conf" / "exp" / "srn600.conf"))["model"], device="cpu")
    ckpt.load_weights_file(model, str(ARTIFACT))
    tree = flax.serialization.msgpack_restore(ARTIFACT.read_bytes())
    widened = {c: {k: v for k, v in tree[c].items()} for c in ("params", "batch_stats")}

    def up(t):
        return {k: up(v) if isinstance(v, dict) else np.asarray(v).astype(np.float32)
                for k, v in t.items()}

    want = state_dict_from_jax(up(widened), model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
