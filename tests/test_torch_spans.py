"""The port's `pnt.*` spans (`utils/spans.py`) and `render_full`'s chunk
counters, on the CPU.

- Under `torch.profiler` one train step of a tiny bf16 model (the kernels'
  plain versions, so the MLP's and the lookup's autograd Functions run)
  and one `render_full` over 3 chunks record the span tree: each span
  nested in the one the layer sits in, one coarse and one fine query a
  render, one `pnt.chunk` a chunk.
- With no profiler recording, `span` hands back one shared no-op context.
- The step's losses, gradients, parameters and the rendered view are bit
  for bit the same with the profiler on and off.
- `render_full.rays` and `.padded_rays` count the rays asked for and the
  rays rendered past them to fill the last chunk.
"""

import copy
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pixelnerf_tpu_torch.eval.common import encode_views
from pixelnerf_tpu_torch.eval.render_utils import make_chunk_renderer, render_full
from pixelnerf_tpu_torch.models.pixelnerf import make_model
from pixelnerf_tpu_torch.render.renderer import RendererConfig
from pixelnerf_tpu_torch.train.step import make_optimizer, make_train_step
from pixelnerf_tpu_torch.utils import spans
from pixelnerf_tpu_torch.utils.hocon import loads

CONF = loads("""
model {
    use_encoder = True
    use_xyz = True
    use_code = True
    code {
        num_freqs = 2
        freq_factor = 1.5
        include_input = True
    }
    use_viewdirs = True
    use_code_viewdirs = False
    mlp_coarse {
        type = resnet
        n_blocks = 3
        d_hidden = 32
        combine_layer = 2
    }
    mlp_fine {
        type = resnet
        n_blocks = 3
        d_hidden = 32
        combine_layer = 2
    }
    encoder {
        backbone = resnet18
        num_layers = 3
    }
    dtype = bfloat16
}
renderer {
    n_coarse = 6
    n_fine = 6
    n_fine_depth = 2
    depth_std = 0.05
    white_bkgd = True
}
""")
SB, NV, NS, H, R = 2, 3, 2, 32, 8
RCFG = RendererConfig.from_conf(CONF["renderer"])


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.default_rng(0)
    poses = torch.eye(4).repeat(SB, NV, 1, 1)
    poses[..., 2, 3] = 1.3
    poses[:, 1, 0, 3] = 0.2
    return {
        "images_u8": torch.from_numpy(rng.integers(0, 256, (SB, NV, H, H, 3), dtype=np.uint8)),
        "image_ord": torch.tensor([[0, 1]] * SB), "poses": poses,
        "focal": torch.full((SB, 2), 35.0), "c": torch.full((SB, 2), H / 2.0),
    }


def _model(train):
    return make_model(CONF["model"], device="cpu", seed=3, train=train)


def _tree(prof):
    """(name, parent name) of every `pnt.*` span: the parent is the
    innermost `pnt.*` span around it on its thread."""
    ev = sorted((e for e in prof.profiler.kineto_results.events() if e.name().startswith("pnt.")),
                key=lambda e: (e.start_ns(), -e.end_ns()))
    out = []
    for i, e in enumerate(ev):
        around = [p for p in ev[:i] if p.start_thread_id() == e.start_thread_id()
                  and p.end_ns() >= e.end_ns()]
        out.append((e.name(), around[-1].name() if around else None))
    return out


def _step(model, profiled):
    step = make_train_step(model, RCFG, make_optimizer(model, 1e-3), R, 0.8, 1.8)
    gen = torch.Generator().manual_seed(5)
    if not profiled:
        return step(_batch(), gen), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        aux = step(_batch(), gen)
    return aux, prof


def test_span_is_a_shared_noop_without_a_profiler():
    assert spans.span("pnt.step", 3) is spans._NOOP
    assert spans.span("pnt.lookup") is spans.span("pnt.encode")
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("pnt.step", 3) is not spans._NOOP
    assert spans.span("pnt.step") is spans._NOOP


def test_train_step_records_the_span_tree_and_computes_the_same():
    model = _model(True)
    twin = copy.deepcopy(model)
    aux, prof = _step(model, True)
    aux0, _ = _step(twin, False)
    tree = _tree(prof)
    names = Counter(n for n, _ in tree)
    assert names["pnt.step"] == names["pnt.render"] == names["pnt.encode"] == 1
    assert names["pnt.query.coarse"] == names["pnt.query.fine"] == 1
    # the coarse call, and the fine pass's cached and new rows
    assert names["pnt.mlp.fwd"] == 3 and names["pnt.mlp.bwd"] == 3
    assert names["pnt.lookup"] == 2 and names["pnt.lookup.bwd"] == 2
    parents = {n: {p for m, p in tree if m == n} for n in names}
    assert parents["pnt.step"] == {None}
    for child in ("pnt.batch", "pnt.encode", "pnt.render", "pnt.loss", "pnt.backward", "pnt.adam"):
        assert parents[child] == {"pnt.step"}, child
    for child in ("pnt.sample", "pnt.query.coarse", "pnt.query.fine", "pnt.composite"):
        assert parents[child] == {"pnt.render"}, child
    assert parents["pnt.lookup"] == {"pnt.query.coarse", "pnt.query.fine"}
    assert parents["pnt.mlp.fwd"] == {"pnt.query.coarse", "pnt.query.fine"}
    # on the CPU autograd runs the backward on the calling thread
    assert parents["pnt.mlp.bwd"] == parents["pnt.lookup.bwd"] == {"pnt.backward"}
    for k in aux0:
        assert torch.equal(aux[k], aux0[k]), k
    for (n, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q) and torch.equal(p.grad, q.grad), n


def test_render_full_records_a_chunk_span_per_chunk_and_counts_its_rays():
    model = _model(False)
    b = _batch()
    images = b["images_u8"][0, :NS].float() / 127.5 - 1.0
    enc = encode_views(model, images, b["poses"][0, :NS], [35.0], c=[H / 2.0, H / 2.0])
    rays = torch.cat([torch.zeros(50, 3), torch.tensor([0.0, 0.0, -1.0]).expand(50, 3)
                      + 0.01 * torch.randn(50, 3, generator=torch.Generator().manual_seed(1)),
                      torch.full((50, 1), 0.8), torch.full((50, 1), 1.8)], dim=-1)
    renderer = make_chunk_renderer(model, RCFG)
    rays0, pad0 = render_full.rays, render_full.padded_rays
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = render_full(model, enc, rays, RCFG, chunk=20, seed=4, renderer=renderer)
    assert (render_full.rays - rays0, render_full.padded_rays - pad0) == (50, 10)
    again = render_full(model, enc, rays[:40], RCFG, chunk=20, seed=4, renderer=renderer)
    assert (render_full.rays - rays0, render_full.padded_rays - pad0) == (90, 10)
    plain = render_full(model, enc, rays, RCFG, chunk=20, seed=4, renderer=renderer)
    for head in out:
        for k in out[head]:
            assert torch.equal(out[head][k], plain[head][k]), (head, k)
            assert torch.equal(again[head][k], plain[head][k][:40]), (head, k)
    tree = _tree(prof)
    names = Counter(n for n, _ in tree)
    assert names["pnt.render_full"] == 1 and names["pnt.chunk"] == names["pnt.render"] == 3
    assert names["pnt.query.coarse"] == names["pnt.query.fine"] == 3
    parents = {n: {p for m, p in tree if m == n} for n in names}
    assert parents["pnt.chunk"] == {"pnt.render_full"}
    assert parents["pnt.render"] == {"pnt.chunk"}
    # the fused field path: the lookup runs inside the field kernel
    assert parents["pnt.mlp.fwd"] == {"pnt.query.coarse", "pnt.query.fine"}
    assert "pnt.lookup" not in names
