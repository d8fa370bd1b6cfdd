"""Port parity: the posenc kernel module's plain version.

`pixelnerf_tpu_torch.ops.posenc.posenc_concat` on CPU tensors runs its
plain version; it is held against the Pallas kernel
(`posenc_concat(..., interpret=True)`) and against the JAX
`PositionalEncoding` + concat chain, on inputs made with numpy from a
seed. Tolerances: float32 output 3e-5 absolute (the same sin of a float32
argument that FMA contraction may move by one ulp, ~1.5e-5 at the largest
arguments |x| * 1.5 * 2^5 of these inputs); bf16 output — the
bf16 rounding of float32 values that may differ by an ulp — at most one
bf16 ulp (rtol 2^-7) on a small fraction of entries, as the JAX
package's own posenc test bounds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.models.code import PositionalEncoding as JPositionalEncoding
from pixelnerf_tpu.ops.posenc_pallas import posenc_concat as j_posenc
from pixelnerf_tpu_torch.models.code import PositionalEncoding
from pixelnerf_tpu_torch.ops.posenc import posenc_concat, posenc_supported

F32_ATOL = 3e-5


def _inputs(m, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(m, 3)).astype(np.float32)
    vd = rng.normal(size=(m, 3)).astype(np.float32)
    return base, vd


def _jax_chain(base, vd, num_freqs, freq_factor, dtype):
    code = JPositionalEncoding(num_freqs=num_freqs, d_in=3, freq_factor=freq_factor)
    z = code.apply({}, jnp.asarray(base))
    return jnp.concatenate([z, jnp.asarray(vd)], axis=1).astype(dtype)


def _assert_bf16_close(got, want):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert (np.abs(got - want) > 0).mean() < 1e-3
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-4)


@pytest.mark.parametrize("num_freqs,freq_factor", [(6, 1.5), (4, float(np.pi))])
def test_posenc_plain_matches_pallas_f32(num_freqs, freq_factor):
    base, vd = _inputs(1000, 0)
    want = j_posenc(
        jnp.asarray(base), jnp.asarray(vd), num_freqs, freq_factor,
        out_dtype=jnp.float32, interpret=True,
    )
    got = posenc_concat(
        torch.from_numpy(base), torch.from_numpy(vd), num_freqs, freq_factor,
        out_dtype=torch.float32,
    )
    assert got.shape == (1000, 3 + 6 * num_freqs + 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_ATOL)


def test_posenc_plain_matches_pallas_bf16():
    base, vd = _inputs(3000, 1)
    want = j_posenc(jnp.asarray(base), jnp.asarray(vd), 6, 1.5, interpret=True)
    got = posenc_concat(torch.from_numpy(base), torch.from_numpy(vd), 6, 1.5)
    assert got.dtype == torch.bfloat16 and got.shape == (3000, 42)
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_posenc_plain_matches_positional_encoding_chain(dtype):
    base, vd = _inputs(500, 2)
    want = _jax_chain(base, vd, 6, 1.5, getattr(jnp, dtype))
    got = posenc_concat(
        torch.from_numpy(base), torch.from_numpy(vd), 6, 1.5,
        out_dtype=getattr(torch, dtype),
    )
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_ATOL)
    else:
        _assert_bf16_close(got, want)


def test_positional_encoding_module_matches_jax():
    base, _ = _inputs(200, 3)
    for include_input in (True, False):
        want = JPositionalEncoding(
            num_freqs=5, d_in=3, freq_factor=2.0, include_input=include_input
        ).apply({}, jnp.asarray(base))
        mod = PositionalEncoding(5, 3, 2.0, include_input)
        got = mod(torch.from_numpy(base))
        assert mod.d_out == want.shape[-1]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_ATOL)


def test_posenc_supported_gate_and_bad_shapes():
    assert posenc_supported(3, 6, True)
    assert not posenc_supported(3, 6, False)
    assert not posenc_supported(1, 6, True)
    with pytest.raises(ValueError):
        posenc_concat(torch.zeros(4, 2), torch.zeros(4, 2), 6, 1.5)
