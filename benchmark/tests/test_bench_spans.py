"""The program's spans as the benchmark reads them (`harness/spans.py`,
`harness/mlp_parts.py`, `metrics/chunk_fill_pct.view.py`,
`span_readings.py`).

On the CPU: a train step of the tiny cell under the profiler, whose
encoder backward's host operations are put down to `pnt.encode` through
the profiler's forward link (on the CPU autograd runs them inside
`pnt.backward`, on the card on its own thread); the chain's and `wgrad`'s
operations sum to the backward's; the readings are None on a window
without spans, and the chunk counter's metric None without its counters;
the tiny cells' traced runs report the same metrics with the program's
spans on and off. On the card (`-m cuda`): every reading is a number in
each cell it is for.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bench_tiny import tiny_cell
import run
import span_readings
from harness import counts, family, manifest, spans, train_cell
from harness.mlp_parts import mlp_backward_chain, mlp_wgrad
from harness.runrec import Run
from harness.scene import generator

SEED = 2 ** 33 + 5
MLP = {"d_hidden": 4, "n_blocks": 3, "combine_layer": 2}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_encoder_backward_is_put_down_to_the_encode_span():
    cell = tiny_cell("train")
    prog = train_cell.Program(cell, SEED, "cpu")
    pool = train_cell.scene.Pool(cell.config["data"], 3, SEED, "cpu")
    batches = train_cell.Batches(pool, cell.traffic, 2, SEED, "cpu")
    gen = generator(SEED, "step", "cpu")
    prog.step(batches(0), gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            prog.step(batches(1), gen)
    host = list(prof.profiler.kineto_results.events())
    index = spans._Index(host)
    got = {}
    for e in host:
        # BatchNorm in train mode is elementwise work: its rsqrt's node
        if e.name() in ("aten::convolution_backward", "RsqrtBackward0",
                        "aten::max_pool2d_with_indices_backward", "Optimizer.step#Adam.step"):
            got.setdefault(e.name(), set()).add(index.span_of(e.start_ns(), e.start_thread_id()))
    assert got["aten::convolution_backward"] == {"pnt.encode"}
    assert got["RsqrtBackward0"] == {"pnt.encode"}
    assert got["aten::max_pool2d_with_indices_backward"] == {"pnt.encode"}
    assert got["Optimizer.step#Adam.step"] == {"pnt.adam"}
    # no device here: no operation, no gap, every span still counted
    sp = spans.read_spans(prof)
    assert sp.ops == [] and sp.gaps == []
    assert sp.opened["pnt.step"] == 1 and sp.opened["pnt.mlp.bwd"] == 3


def test_chain_and_wgrad_split_the_backwards_operations():
    for rows, views in ((6, 2), (9, 3)):
        f_chain, _ = mlp_backward_chain(MLP, 3, 5, rows, views)
        f_wgrad, b_wgrad = mlp_wgrad(MLP, 3, 5, rows, views)
        f_all, _ = counts.mlp_backward(MLP, 3, 5, rows, views)
        assert f_chain + f_wgrad == f_all
        assert f_chain == f_wgrad == counts.mlp_forward_flops(MLP, 3, 5, rows, views)
        assert b_wgrad == rows * 8 * 2 + counts.mlp_params(MLP, 3, 5) * 4
    for name in ("srn.train", "dtu.train"):
        cell = manifest.Cell(manifest.load_manifest(), name)
        fam = family.load(cell.family)
        parts = fam.train_parts(cell.config, cell.traffic)
        # every part bound by its operations at these sizes: each a third
        # of the forward-and-backward's least time
        work = fam.cell_work(cell.config, cell.traffic)
        assert sum(parts.values()) == pytest.approx(work["mlp_least_s"])
        assert parts["mlp_chain_least_s"] == pytest.approx(parts["mlp_wgrad_least_s"])


def _op(name, start, end, span, bench="bench.step"):
    return spans.SpanOp(name, start, end, bench, span)


def test_readings_are_none_without_spans():
    parts = {"mlp_fwd_least_s": 1e-3, "mlp_chain_least_s": 1e-3, "mlp_wgrad_least_s": 1e-3}
    bare_ops = [_op("resnetfc_fwd_kernel<512>", 0, 10, None), _op("wgrad_products", 20, 30, None)]
    bare = spans.Spans(bare_ops, [(1e-8, bare_ops[1])], {})
    assert set(spans.readings(bare, "train", 2, parts).values()) == {None}
    assert spans.readings(bare, "view", 2) == {"lookup_ms.view": None}
    assert bare.coverage("bench.step") == 0.0
    ops = [
        _op("resnetfc_fwd_kernel<512>", 0, 2_000_000, "pnt.mlp.fwd"),
        _op("resnetfc_bwd_chain_kernel<512, false>", 3_000_000, 7_000_000, "pnt.mlp.bwd"),
        _op("wgrad_products", 7_000_000, 8_000_000, "pnt.mlp.bwd"),
        _op("void at::native::vectorized_elementwise_kernel", 9_000_000, 9_500_000, "pnt.adam"),
        _op("cudnn_fprop", 9_500_000, 10_000_000, "pnt.encode"),
        _op("Memset (Device)", 10_000_000, 10_100_000, None),
    ]
    ops[4].linked = True
    spanned = spans.Spans(ops, [(1e-3, ops[2]), (1e-3, ops[3])], {"pnt.step": 2})
    got = spans.readings(spanned, "train", 2, parts)
    assert got == pytest.approx({
        "mlp_fwd_roofline.train": 100.0, "mlp_chain_roofline.train": 50.0,
        "wgrad_roofline.train": 200.0, "encode_ms.train": 0.25, "adam_ms.train": 0.25,
        "adam_idle_ms.train": 0.5})
    assert spanned.coverage("bench.step") == pytest.approx(8.0 / 8.1)
    assert spanned.by_span(linked=True) == pytest.approx({
        "pnt.mlp.fwd": 2e-3, "pnt.mlp.bwd": 5e-3, "pnt.adam": 5e-4,
        "pnt.encode (backward)": 5e-4, "None": 1e-4})
    assert spanned.idle_by_span() == pytest.approx({"pnt.mlp.bwd": 1e-3, "pnt.adam": 1e-3})


def test_chunk_fill_reads_the_programs_counters(monkeypatch):
    from harness.manifest import load_reader
    from pixelnerf_tpu_torch.eval.render_utils import render_full

    read = load_reader("chunk_fill_pct.view")
    view = Run(kind="view", work={}, units=1, trace=None)
    monkeypatch.setattr(render_full, "rays", 120_000)
    monkeypatch.setattr(render_full, "padded_rays", 11_072)
    assert read(view) == pytest.approx(91.552734375)
    assert read(Run(kind="train", work={}, units=1, trace=None)) is None
    monkeypatch.delattr(render_full, "rays")
    monkeypatch.delattr(render_full, "padded_rays")
    assert read(view) is None


@pytest.mark.parametrize("kind", ["train", "view"])
def test_spans_leave_the_traced_runs_metrics_as_they_were(kind, monkeypatch):
    from pixelnerf_tpu_torch.utils import spans as program_spans

    with_spans = span_readings.measure(tiny_cell(kind), SEED, 0.1, "cpu")
    assert with_spans["opened"]["pnt.render"] >= 2 and with_spans["correct"]
    monkeypatch.setattr(program_spans, "_recording", lambda: False)
    plain = run.run_cell(tiny_cell(kind), SEED, 0.1, True, "cpu")
    assert plain["correct"] and plain["check"] == with_spans["check"]
    assert set(plain["metrics"]) == set(with_spans["metrics"])
    if kind == "view":
        fill = 100.0 * 1024 / 1152  # 32x32 rays in chunks of 384
        assert with_spans["metrics"]["chunk_fill_pct.view"]["value"] == pytest.approx(fill)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the span readings are device times")
    return "cuda"


SPAN_CELLS = ["srn.train", "dtu.train", "srn.view", "dtu.view"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", SPAN_CELLS)
def test_every_span_reading_is_a_number_on_the_card(card, workload):
    cell = manifest.Cell(manifest.load_manifest(), workload)
    out = span_readings.measure(cell, 3_141_592_653, 5.0, card)
    assert out["correct"]
    wanted = dict(out["spans"])
    if workload == "srn.view":  # the fused field does the lookup in its kernel
        assert wanted.pop("lookup_ms.view") is None
    assert all(isinstance(v, float) and v > 0 for v in wanted.values()), wanted
    if cell.kind == "view":
        assert out["metrics"]["chunk_fill_pct.view"]["value"] > 0
    for bench, share in out["coverage"].items():
        assert share >= 0.99, (bench, share)
