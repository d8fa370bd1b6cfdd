"""Port parity: the field kernel module's plain version and ResnetFC.

`pixelnerf_tpu_torch.ops.field.pyramid_field_fused` on CPU tensors runs
its plain version (`pyramid_gather_plain` + `resnetfc_fwd_plain`, with
the kernel's cast points: each composed tap weight rounded to the feature
dtype as the TPU kernel's one-hot matrices, z cast to the feature dtype,
bf16 matmul operands, float32 sums). It is held against the Pallas kernel
`pyramid_field_fused(..., interpret=True)` at small sizes (hidden 64,
levels 16x16x32 / 8x8x32 / 4x4x64, 5 blocks, pooling at block 3), with
inputs made by numpy from a seed and non-zero fc_1 weights.

Tolerances. Both sides round the same tap weights, cast z and every
matmul operand to bf16 and accumulate in float32, in other orders; where a
float32 value lands within an ulp of a bf16 rounding boundary the two
round apart, and that bf16 ulp (2^-8 relative) propagates through the
blocks. So outputs of O(1) agree to 1e-2 at worst and 1e-4 on average,
with float32 and with bf16 feature maps alike (measured over the test's
seeds: 3.2e-3 and 3.6e-5 at worst with float32 maps, 4.8e-7 and 1.4e-8
with bf16 ones). The float32 per-layer ResnetFC is held to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelnerf_tpu.models.resnetfc import FieldInput as JFieldInput
from pixelnerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from pixelnerf_tpu.ops.field_pallas import pyramid_field_fused as j_field
from pixelnerf_tpu.ops.resnetfc_pallas import ResnetFCWeights
from pixelnerf_tpu_torch.convert import state_dict_from_jax
from pixelnerf_tpu_torch.models.resnetfc import FieldInput, ResnetFC
from pixelnerf_tpu_torch.ops.field import (
    FieldWeights, field_flops, field_supported, pack_field_weights, pyramid_field_fused,
)

SHAPES = [(16, 16, 32), (8, 8, 32), (4, 4, 64)]
D_IN, HIDDEN, D_OUT, N_BLOCKS, COMBINE = 42, 64, 4, 5, 3
# (max abs, max rel, mean abs) by feature dtype, see the docstring
TOL = {"float32": (1e-2, 0.0, 1e-4), "bfloat16": (1e-2, 0.0, 1e-4)}


def _assert_close(got, want, dtype):
    atol, rtol, mean = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert np.abs(got - want).mean() < mean


def _inputs(rng, sb, ns, b):
    feats = [
        rng.normal(size=(sb * ns, h, w, c)).astype(np.float32) for (h, w, c) in SHAPES
    ]
    grid = rng.uniform(-1.1, 1.1, size=(sb, ns, b, 2)).astype(np.float32)
    xin = rng.normal(size=(sb, ns, b, D_IN)).astype(np.float32)
    return feats, grid, xin


def _weights(rng, n_inj):
    d_latent = sum(c for (_, _, c) in SHAPES)

    def m(shape, fan_in):
        return rng.normal(size=shape, scale=1.0 / np.sqrt(fan_in)).astype(np.float32)

    return dict(
        w_in=m((D_IN, HIDDEN), D_IN), b_in=m((HIDDEN,), 10),
        wz=m((n_inj, d_latent, HIDDEN), d_latent), bz=m((n_inj, HIDDEN), 10),
        w0=m((N_BLOCKS, HIDDEN, HIDDEN), HIDDEN), b0=m((N_BLOCKS, HIDDEN), 10),
        w1=m((N_BLOCKS, HIDDEN, HIDDEN), HIDDEN), b1=m((N_BLOCKS, HIDDEN), 10),
        w_out=m((HIDDEN, D_OUT), HIDDEN), b_out=m((D_OUT,), 10),
    )


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _jbf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns,sb", [(1, 2), (2, 1), (2, 2), (3, 1)])
def test_field_plain_matches_pallas(ns, sb, feat_dtype):
    rng = np.random.default_rng(ns * 10 + sb)
    b = 32
    feats, grid, xin = _inputs(rng, sb, ns, b)
    jfeats = tuple(jnp.asarray(f).astype(feat_dtype) for f in feats)
    tfeats = [torch.from_numpy(f).to(getattr(torch, feat_dtype)) for f in feats]
    w = _weights(rng, min(COMBINE, N_BLOCKS))
    jw = ResnetFCWeights(
        **{k: jnp.asarray(v[None] if k in ("b_in", "b_out") else v) for k, v in w.items()}
    )
    want = j_field(
        jfeats, jnp.asarray(grid), _jbf16(xin), jw, N_BLOCKS, COMBINE, ns, True,
    )
    before = pyramid_field_fused.launches
    got = pyramid_field_fused(
        tfeats, torch.from_numpy(grid), _bf16(xin),
        FieldWeights(**{k: torch.from_numpy(v) for k, v in w.items()}),
        N_BLOCKS, COMBINE, ns,
    )
    assert pyramid_field_fused.launches == before  # CPU tensors: no kernel
    assert got.shape == (sb, b, D_OUT) and got.dtype == torch.float32
    want = np.asarray(want)
    assert np.abs(want).mean() > 0.5  # the block chain is not trivial
    _assert_close(got.numpy(), want, feat_dtype)


def _jax_resnetfc(use_pallas, d_latent, dtype=jnp.float32):
    return JResnetFC(
        d_in=D_IN, d_out=D_OUT, n_blocks=N_BLOCKS, d_latent=d_latent,
        d_hidden=HIDDEN, combine_layer=COMBINE, use_pallas=use_pallas, dtype=dtype,
    )


def _port_resnetfc(params, d_latent, dtype=torch.float32):
    mod = ResnetFC(
        D_IN, D_OUT, N_BLOCKS, d_latent=d_latent, d_hidden=HIDDEN,
        combine_layer=COMBINE, dtype=dtype,
    )
    mod.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), mod))
    return mod


def _randomize(params, seed):
    """Non-zero fc_1 and biases: the zero init would hide the block chain."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [
        jnp.asarray(rng.normal(size=l.shape, scale=1.0 / np.sqrt(l.shape[0])).astype(np.float32))
        for l in leaves
    ]
    return jax.tree_util.tree_unflatten(tree, leaves)


def test_resnetfc_per_layer_matches_flax_f32():
    rng = np.random.default_rng(5)
    ns, b, d_latent = 2, 24, 40
    z = rng.normal(size=(ns * b, d_latent)).astype(np.float32)
    x = rng.normal(size=(ns * b, D_IN)).astype(np.float32)
    jmod = _jax_resnetfc(False, d_latent)
    params = _randomize(jmod.init(jax.random.PRNGKey(0), (jnp.asarray(z), jnp.asarray(x)), (ns, b)), 6)
    want = jmod.apply(params, (jnp.asarray(z), jnp.asarray(x)), (ns, b))
    got = _port_resnetfc(params, d_latent)((torch.from_numpy(z), torch.from_numpy(x)), (ns, b))
    assert got.shape == (1, b, D_OUT)
    np.testing.assert_allclose(
        got.detach().numpy().reshape(want.shape), np.asarray(want), rtol=1e-5, atol=1e-5
    )


def test_resnetfc_field_input_matches_pallas_field_path():
    """The module's FieldInput path (CPU: the plain field) against the JAX
    module's FieldInput path (Pallas field kernel in interpret mode)."""
    rng = np.random.default_rng(7)
    sb, ns, b = 1, 2, 24
    d_latent = sum(c for (_, _, c) in SHAPES)
    feats, grid, xin = _inputs(rng, sb, ns, b)
    jfi = JFieldInput(
        feats=tuple(_jbf16(f) for f in feats),
        grid=jnp.asarray(grid).reshape(sb * ns, b, 2),
        x=_jbf16(xin).reshape(sb * ns * b, D_IN),
    )
    jmod = _jax_resnetfc(True, d_latent)
    params = _randomize(jmod.init(jax.random.PRNGKey(0), jfi, (ns, b)), 8)
    want = jmod.apply(params, jfi, (ns, b))
    mod = _port_resnetfc(params, d_latent, torch.bfloat16)
    assert mod.field_path_ok(ns)
    fi = FieldInput(
        feats=tuple(_bf16(f) for f in feats),
        grid=torch.from_numpy(grid).reshape(sb * ns, b, 2),
        x=_bf16(xin).reshape(sb * ns * b, D_IN),
    )
    with torch.no_grad():
        got = mod(fi, (ns, b))
    _assert_close(got.numpy(), np.asarray(want), "bfloat16")


def test_field_supported_and_flops():
    assert field_supported(2, 5, 3) and field_supported(1, 5, 1000)
    assert field_supported(3, 5, 3) and field_supported(32, 5, 3)
    assert not field_supported(2, 5, 5)
    assert not field_supported(2, 5, 0)
    # flagship head at NS=2: 2 views x (42*512 + 3*512^2 injection
    # + 3*2*512^2) MACs pre-pool, 2*2*512^2 post-pool, 512*4 out
    macs = 2 * (42 * 512 + 3 * 512**2 + 6 * 512**2) + 4 * 512**2 + 512 * 4
    assert field_flops(2, 42, 512, 512, 4, 5, 3) == 2 * macs


def test_packed_weights_give_the_same_field():
    """pack_field_weights (bf16 matrices, w_in padded to 48 rows) changes
    no result of the plain field: its matmuls cast to bf16 anyway and the
    padded rows meet no input column. Packing packed weights copies
    nothing."""
    rng = np.random.default_rng(11)
    sb, ns, b = 1, 3, 20
    feats, grid, xin = _inputs(rng, sb, ns, b)
    tfeats = [_bf16(f) for f in feats]
    w = FieldWeights(**{k: torch.from_numpy(v) for k, v in _weights(rng, COMBINE).items()})
    packed = pack_field_weights(w)
    assert packed.w_in.shape == (48, HIDDEN) and packed.w_in.dtype == torch.bfloat16
    assert not packed.w_in[D_IN:].any() and packed.b_in.dtype == torch.float32
    again = pack_field_weights(packed)
    assert all(a.data_ptr() == p.data_ptr() for a, p in zip(again, packed))
    args = (tfeats, torch.from_numpy(grid), _bf16(xin))
    want = pyramid_field_fused(*args, w, N_BLOCKS, COMBINE, ns)
    got = pyramid_field_fused(*args, packed, N_BLOCKS, COMBINE, ns)
    assert torch.equal(got, want)


def test_resnetfc_field_weights_packed_once():
    """The module packs its weights for the kernel once, and again only
    when a parameter changes."""
    mod = ResnetFC(D_IN, D_OUT, N_BLOCKS, d_latent=128, d_hidden=HIDDEN, combine_layer=COMBINE)
    first = mod.field_weights()
    assert mod.field_weights() is first
    assert first.w0.dtype == torch.bfloat16 and not first.w0.requires_grad
    with torch.no_grad():
        mod.block_1.fc_1.weight.add_(1.0)
    second = mod.field_weights()
    assert second is not first
    want = mod.block_1.fc_1.weight.detach().t().to(torch.bfloat16)
    assert torch.equal(second.w1[1], want)
