"""The widths the Hopper forward chain (`csrc/fwd_chain.cuh`) is built for,
as the ResnetFC and field wrappers check them before a launch, and the
plain forward at the narrow width the card tests use, against itself with
its stash (the same rows, the stash's own layout)."""

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.ops.field import FieldWeights
from pixelnerf_tpu_torch.ops.resnetfc import (
    check_chain_widths, resnetfc_fwd, resnetfc_fwd_plain, resnetfc_fwd_stash, stash_layout,
)


@pytest.mark.parametrize(
    "hidden,d_latent,d_in,d_out",
    [(512, 512, 42, 4), (64, 128, 42, 4), (64, 64, 42, 4), (64, 512, 64, 16)],
)
def test_chain_takes_its_widths(hidden, d_latent, d_in, d_out):
    check_chain_widths(hidden, d_latent, d_in, d_out)


@pytest.mark.parametrize(
    "hidden,d_latent,d_in,d_out,what",
    [
        (256, 512, 42, 4, "d_hidden"),
        (128, 128, 42, 4, "d_hidden"),
        (512, 96, 42, 4, "d_latent"),
        (64, 64, 66, 4, "d_in"),
        (512, 512, 41, 4, "d_in"),
        (512, 512, 42, 17, "d_out"),
    ],
)
def test_chain_refuses_other_widths(hidden, d_latent, d_in, d_out, what):
    with pytest.raises(ValueError, match=what):
        check_chain_widths(hidden, d_latent, d_in, d_out)


@pytest.mark.parametrize("ns,b", [(1, 70), (2, 33), (3, 22), (5, 13)])
def test_cpu_forward_and_stash_forward_agree(ns, b):
    """On CPU tensors both wrappers take the plain version: the same output,
    and a stash of the configuration's shape, relu'd (no negative value)."""
    rng = np.random.default_rng(ns * 10 + b)
    hidden, d_latent, n_blocks = 64, 64, 5
    combine = 3 if ns > 1 else 1000
    t = lambda *shape, scale=0.3: torch.from_numpy(rng.normal(size=shape, scale=scale).astype(np.float32))
    n_inj = min(combine, n_blocks)
    w = FieldWeights(
        w_in=t(42, hidden), b_in=t(hidden), wz=t(n_inj, d_latent, hidden), bz=t(n_inj, hidden),
        w0=t(n_blocks, hidden, hidden), b0=t(n_blocks, hidden), w1=t(n_blocks, hidden, hidden),
        b1=t(n_blocks, hidden), w_out=t(hidden, 4), b_out=t(4),
    )
    z = t(2, ns, b, d_latent, scale=1.0).to(torch.bfloat16)
    xin = t(2, ns, b, 42, scale=1.0).to(torch.bfloat16)
    out = resnetfc_fwd(z, xin, w, n_blocks, combine, ns)
    out_s, spre, spost = resnetfc_fwd_stash(z, xin, w, n_blocks, combine, ns)
    assert torch.equal(out, out_s)
    assert torch.equal(out, resnetfc_fwd_plain(z, xin, w, n_blocks, combine, ns))
    k, m = stash_layout(n_blocks, combine, ns)
    assert spost.shape == (2 * m + 1, 2, b, hidden) and spost.dtype == torch.bfloat16
    assert (spre is None) == (k == 0)
    if spre is not None:
        assert spre.shape == (2 * k, 2, ns, b, hidden) and (spre >= 0).all()
    assert (spost >= 0).all()
