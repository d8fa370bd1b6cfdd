"""The widths the Hopper block chains (`csrc/fwd_chain.cuh`,
`csrc/bwd_chain.cuh`) are built for, as the ResnetFC and field wrappers
check them before a launch, forward and backward alike, and the plain
forward at the narrow width the card tests use, against itself with its
stash (the same rows, the stash's own layout)."""

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.ops import resnetfc as ops_resnetfc
from pixelnerf_tpu_torch.ops.field import FieldWeights
from pixelnerf_tpu_torch.ops.resnetfc import (
    check_chain_widths, resnetfc_fwd, resnetfc_fwd_plain, resnetfc_fwd_stash, stash_layout,
)


@pytest.mark.parametrize(
    "hidden,d_latent,d_in,d_out",
    [
        (512, 512, 42, 4), (64, 128, 42, 4), (64, 64, 42, 4), (64, 512, 64, 16),
        (256, 512, 42, 4), (128, 128, 42, 4),
    ],
)
def test_chain_takes_its_widths(hidden, d_latent, d_in, d_out):
    check_chain_widths(hidden, d_latent, d_in, d_out)


@pytest.mark.parametrize(
    "hidden,d_latent,d_in,d_out,what",
    [
        (384, 512, 42, 4, "d_hidden"),
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


class _Reached(Exception):
    """Raised in place of building the kernels: the wrapper's own checks
    passed."""


def _reach(name):
    raise _Reached(name)


@pytest.mark.parametrize(
    "hidden,d_latent,d_in,d_out,ns",
    [
        (512, 512, 42, 4, 2), (256, 512, 42, 4, 3), (128, 128, 42, 4, 1), (64, 64, 64, 16, 5),
        (64, 64, 42, 4, 65), (384, 512, 42, 4, 2), (512, 96, 42, 4, 2), (64, 64, 66, 4, 2),
        (512, 512, 42, 17, 2), (16, 64, 42, 4, 2), (576, 512, 42, 4, 2), (64, 64, 514, 4, 2),
    ],
)
def test_backward_checks_widths_and_views_as_the_forward(monkeypatch, hidden, d_latent, d_in,
                                                        d_out, ns):
    """The backward wrapper refuses exactly the widths and view counts the
    forward wrapper refuses, with the same error, before either touches
    its kernel: after the wrappers' zero padding (`chain_plan`: any hidden
    and padded d_in up to 512, any d_latent, d_out in groups of 16) only a
    hidden width or d_in past 512 and more than 64 views (a tile needs
    more than one 64-row product) are left to refuse."""
    monkeypatch.setattr(ops_resnetfc, "_library", _reach)
    n_blocks, combine = 5, 3 if ns > 1 else 1000
    n_inj = min(combine, n_blocks)
    t = lambda *shape: torch.zeros(shape)
    w = FieldWeights(
        w_in=t(d_in, hidden), b_in=t(hidden), wz=t(n_inj, d_latent, hidden), bz=t(n_inj, hidden),
        w0=t(n_blocks, hidden, hidden), b0=t(n_blocks, hidden), w1=t(n_blocks, hidden, hidden),
        b1=t(n_blocks, hidden), w_out=t(hidden, d_out), b_out=t(d_out),
    )
    z = t(1, ns, 3, d_latent).to(torch.bfloat16)
    xin = t(1, ns, 3, d_in).to(torch.bfloat16)
    k, m = stash_layout(n_blocks, combine, ns)
    spre = t(2 * k, 1, ns, 3, hidden).to(torch.bfloat16) if k else None
    spost = t(2 * m + 1, 1, 3, hidden).to(torch.bfloat16)

    def outcome(fn):
        try:
            fn()
        except (ValueError, _Reached) as e:
            return type(e), str(e) if isinstance(e, ValueError) else None
        raise AssertionError("the wrapper neither raised nor reached its kernel")

    fwd = outcome(lambda: ops_resnetfc._launch_fwd(z, xin, w, n_blocks, combine, ns, stash=True))
    bwd = outcome(lambda: ops_resnetfc.launch_bwd(
        z, xin, t(1, 3, d_out), spre, spost, w, n_blocks, combine, ns))
    assert fwd == bwd
    accepted = hidden <= 512 and d_in <= 512 and ns <= 64
    assert fwd[0] is (_Reached if accepted else ValueError)
