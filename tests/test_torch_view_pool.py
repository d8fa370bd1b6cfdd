"""The layered pooling's host side, on the CPU: what the two pooling
wrappers hand the kernels' library on the card's route, and what they
refuse before any launch, through a stand-in library that records each
call. The kernels themselves run on the card
(`tests/test_torch_cuda_kernels.py`)."""

import types

import pytest
import torch

from pixelnerf_tpu_torch.ops import layer_chain
from pixelnerf_tpu_torch.ops.layer_chain import view_pool_bwd, view_pool_fwd

_BF = torch.bfloat16


class _Lib:
    """A stand-in for the layered kernels' library: records each call's
    arguments; the pooling's workspace is 3 floats a column."""

    def __init__(self):
        self.calls = []

    def pnt_view_pool_fwd(self, *args):
        self.calls.append(("fwd", args))
        return 0

    def pnt_view_pool_bwd_workspace(self, sb, b, c):
        return 3 * c

    def pnt_view_pool_bwd(self, *args):
        self.calls.append(("bwd", args))
        return 0


@pytest.fixture
def card_route(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(layer_chain, "_device_of", lambda t, what: "cuda")
    monkeypatch.setattr(layer_chain, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("sb,ns,b,h,with_y", [(4, 2, 64, 1024, True), (2, 80, 5, 64, False),
                                              (1, 3, 1, 20, True)])
def test_view_pool_fwd_launches_once(card_route, sb, ns, b, h, with_y):
    """One launch a call with the shape as (SB, NS, B, H), and y's pointer
    null where no y is given."""
    x = torch.zeros(sb, ns, b, h)
    out = torch.zeros(sb * b, h)
    y = torch.zeros(sb * b, h, dtype=_BF) if with_y else None
    before = view_pool_fwd.launches
    view_pool_fwd(x, out, y)
    assert view_pool_fwd.launches == before + 1
    (kind, args), = card_route.calls
    assert kind == "fwd" and args[3:7] == (sb, ns, b, h) and len(args) == 8
    assert args[:3] == (x.data_ptr(), out.data_ptr(), y.data_ptr() if with_y else 0)


# (what is wrong, x, out, y) for x (2, 3, 5, 16): each refused before a launch
FWD_REFUSED = {
    "x float16": (torch.zeros(2, 3, 5, 16, dtype=torch.float16), torch.zeros(10, 16), None),
    "out strided": (torch.zeros(2, 3, 5, 16), torch.zeros(16, 10).t(), None),
    "out short": (torch.zeros(2, 3, 5, 16), torch.zeros(9, 16), None),
    "y short": (torch.zeros(2, 3, 5, 16), torch.zeros(10, 16), torch.zeros(10, 8, dtype=_BF)),
    "y float32": (torch.zeros(2, 3, 5, 16), torch.zeros(10, 16), torch.zeros(10, 16)),
}


@pytest.mark.parametrize("x,out,y", FWD_REFUSED.values(), ids=FWD_REFUSED.keys())
def test_view_pool_fwd_refuses_before_a_launch(card_route, x, out, y):
    before = view_pool_fwd.launches
    with pytest.raises(ValueError):
        view_pool_fwd(x, out, y)
    assert view_pool_fwd.launches == before and not card_route.calls


# (what is wrong, gx, y, colsum) for g (2, 5, 20) over 3 views: each refused
BWD_REFUSED = {
    "gx short": (torch.zeros(29, 20), None, None),
    "y narrower than C": (None, torch.zeros(30, 16, dtype=_BF), None),
    "y float32": (None, torch.zeros(30, 32), None),
    "colsum float64": (None, None, torch.zeros(20, dtype=torch.float64)),
}


@pytest.mark.parametrize("gx,y,colsum", BWD_REFUSED.values(), ids=BWD_REFUSED.keys())
def test_view_pool_bwd_refuses_before_a_launch(card_route, gx, y, colsum):
    before = view_pool_bwd.launches
    with pytest.raises(ValueError):
        view_pool_bwd(torch.zeros(2, 5, 20), 3, gx=gx, y=y, colsum=colsum)
    assert view_pool_bwd.launches == before and not card_route.calls


def test_view_pool_bwd_of_no_rows_sums_nothing(card_route):
    """With no rows there is nothing to reduce: one launch counted, no
    workspace (a null pointer) handed over."""
    before = view_pool_bwd.launches
    view_pool_bwd(torch.zeros(0, 5, 20), 3, gx=torch.zeros(0, 20), colsum=torch.zeros(20))
    assert view_pool_bwd.launches == before + 1
    (kind, args), = card_route.calls
    assert kind == "bwd" and args[3] != 0 and args[4] == 0


@pytest.mark.parametrize("with_sums", [True, False])
def test_view_pool_bwd_counts_its_column_sums(card_route, with_sums):
    """With column sums the wrapper hands the library a workspace of the
    size the library reports and counts the reduction's launch too."""
    sb, ns, b, c = 2, 3, 5, 20
    g = torch.zeros(sb, b, c)
    gx = torch.zeros(sb * ns * b, c)
    y = torch.zeros(sb * ns * b, 32, dtype=_BF)
    colsum = torch.zeros(c) if with_sums else None
    before = view_pool_bwd.launches
    view_pool_bwd(g, ns, gx=gx, y=y, colsum=colsum)
    assert view_pool_bwd.launches == before + 1 + with_sums
    (kind, args), = card_route.calls
    assert kind == "bwd" and args[5:10] == (sb, ns, b, c, 32)
    assert (args[3] != 0, args[4] != 0) == (with_sums, with_sums)
