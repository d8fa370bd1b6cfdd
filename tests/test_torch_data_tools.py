"""The port's data tools against the JAX package's, file for file.

Each tool of `pixelnerf_tpu_torch/tools/` that the JAX package has in
numpy runs beside it on the same arguments into its own directory, and
every file the two write must be equal byte for byte: `camera_gen`'s
writers, `make_synthetic_dataset` in its four layouts, `eval_view_list_gen`,
`dtu_resize` and `flatten_alpha` (each on its own copy of one dataset),
`make_pollen_meshes` and `stl_render_dataset` on its meshes,
`pose_sanity_check` (its printout, its result and its plot), and
`port_lpips_weights` on a random state dict. `trace_summary`, the
counterpart of the TPU trace reader `xprof_summary`, sums a small written
Chrome trace into the port's kernel buckets. One subprocess imports every
module of the port and runs `make_synthetic_dataset.main` with `jax`,
`jaxlib`, `flax`, `optax` and `pixelnerf_tpu` blocked, as on a machine
without them.
"""

import importlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(pkg, name):
    return importlib.import_module(f"{pkg}.tools.{name}")


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert ta and sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k] == tb[k], k


def _both(tmp_path, name, argv_of, capsys=None):
    """Run the JAX tool and the port's with argv_of(out_dir) each; return
    the two output directories (and printouts)."""
    outs, printed = [], []
    for pkg in ("pixelnerf_tpu", "pixelnerf_tpu_torch"):
        out = tmp_path / pkg
        out.mkdir()
        _tool(pkg, name).main(argv_of(str(out)))
        outs.append(str(out))
        if capsys is not None:
            printed.append(capsys.readouterr().out.replace(str(out), "OUT"))
    return outs, printed


@pytest.mark.parametrize("fmt", ["srn", "multi_obj", "dvr", "dtu"])
def test_make_synthetic_dataset_writes_the_jax_tools_files(fmt, tmp_path, capsys):
    argv = lambda out: ["--out", out, "--format", fmt, "--n_objs", "3", "--n_views", "4",
                        "--size", "24", "--seed", "3", "--near_far"]
    (a, b), (pa, pb) = _both(tmp_path, "make_synthetic_dataset", argv, capsys)
    _assert_same_tree(a, b)
    assert pa == pb


def test_camera_gen_writes_the_jax_tools_files(tmp_path):
    for pkg in ("pixelnerf_tpu", "pixelnerf_tpu_torch"):
        cg = _tool(pkg, "camera_gen")
        out = tmp_path / pkg
        out.mkdir()
        rng = np.random.default_rng(0)
        poses = cg.hemisphere_poses(5, 2.0, rng)
        spiral = cg.archimedes_spiral_poses(4, 2.0)
        cg.write_transforms_json(str(out), poses, 0.7, [f"v{i}" for i in range(5)], model_ids=["m"])
        cg.write_dvr_cameras(str(out), poses, 30.0, 32)
        (out / "dtu").mkdir()
        cg.write_dtu_cameras(str(out / "dtu"), spiral, 30.0, 32)
        cg.write_srn_intrinsics(str(out), 30.0, 32)
        np.save(out / "fib.npy", cg.fibonacci_sphere(7, 1.3))
        np.save(out / "spiral.npy", spiral)
    _assert_same_tree(tmp_path / "pixelnerf_tpu", tmp_path / "pixelnerf_tpu_torch")


def test_eval_view_list_gen_writes_the_jax_tools_file(tmp_path):
    argv = lambda out: ["--num_views", "40", "--tolerance", "10", "--out", f"{out}/list.txt"]
    _assert_same_tree(*_both(tmp_path, "eval_view_list_gen", argv)[0])


def test_dtu_resize_and_flatten_alpha_match_on_copies_of_one_dataset(tmp_path):
    from pixelnerf_tpu.tools import make_synthetic_dataset

    make_synthetic_dataset.main(["--out", str(tmp_path / "src"), "--format", "dtu", "--n_objs", "2",
                                 "--n_views", "3", "--size", "32"])
    make_synthetic_dataset.main(["--out", str(tmp_path / "src"), "--name", "objs", "--format",
                                 "multi_obj", "--n_objs", "2", "--n_views", "3", "--size", "16"])
    copies = []
    for pkg in ("pixelnerf_tpu", "pixelnerf_tpu_torch"):
        dst = tmp_path / pkg
        shutil.copytree(tmp_path / "src", dst)
        _tool(pkg, "dtu_resize").main(["--data_dir", str(dst / "shapes" / "synth"), "--scale", "2"])
        # flatten_alpha's --root takes */rgb/*.png: lay the RGBA views out so
        for png in sorted((dst / "objs").rglob("*_obj.png")):
            (png.parent / "rgb").mkdir(exist_ok=True)
            png.rename(png.parent / "rgb" / png.name)
        assert _tool(pkg, "flatten_alpha").main(["--root", str(dst / "objs")]) == 6
        copies.append(dst)
    _assert_same_tree(*copies)


def test_pollen_meshes_and_their_render_match(tmp_path):
    outs = []
    for pkg in ("pixelnerf_tpu", "pixelnerf_tpu_torch"):
        out = tmp_path / pkg
        _tool(pkg, "make_pollen_meshes").main(["--out", str(out / "meshes"), "--n_meshes", "2",
                                               "--subdiv", "1", "--seed", "4"])
        stls = sorted(str(p) for p in (out / "meshes").glob("*.stl"))
        assert len(stls) == 2
        _tool(pkg, "stl_render_dataset").main(["--stl", *stls, "--out", str(out / "data"),
                                               "--n_views", "3", "--size", "16"])
        outs.append(out)
    _assert_same_tree(*outs)


def test_pose_sanity_check_matches(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    from pixelnerf_tpu.tools import make_synthetic_dataset

    make_synthetic_dataset.main(["--out", str(tmp_path / "d"), "--n_objs", "10", "--n_views", "4",
                                 "--size", "16"])
    capsys.readouterr()
    results, printed = [], []
    for pkg in ("pixelnerf_tpu", "pixelnerf_tpu_torch"):
        (tmp_path / pkg).mkdir()
        results.append(_tool(pkg, "pose_sanity_check").main([
            "--datadir", str(tmp_path / "d" / "shapes"), "--num_objects", "2", "--num_views", "3",
            "--diagnostics", "--plot", str(tmp_path / pkg / "cams.png")]))
        printed.append(capsys.readouterr().out.replace(pkg, "PKG"))
    assert results[0] == results[1] == 0
    assert printed[0] == printed[1] and "OK: all poses valid" in printed[1]
    _assert_same_tree(tmp_path / "pixelnerf_tpu", tmp_path / "pixelnerf_tpu_torch")


def test_port_lpips_weights_writes_the_jax_tools_file(tmp_path):
    from pixelnerf_tpu.utils import lpips_jax
    from tests.test_torch_lpips import _sd

    vgg, lins = _sd(lpips_jax.random_params(2), False)
    torch.save(vgg, tmp_path / "vgg.pth")
    torch.save(lins, tmp_path / "lins.pth")
    argv = lambda out: ["--vgg", str(tmp_path / "vgg.pth"), "--lins", str(tmp_path / "lins.pth"),
                        "--out", f"{out}/lpips_vgg.npz"]
    a, b = _both(tmp_path, "port_lpips_weights", argv)[0]
    _assert_same_tree(a, b)


def _event(name, cat, dur, ts=0):
    return {"ph": "X", "name": name, "cat": cat, "dur": dur, "ts": ts, "pid": 0, "tid": 0}


def test_trace_summary_buckets_the_ports_kernels(tmp_path, capsys):
    from pixelnerf_tpu_torch.tools import trace_summary

    events = [
        _event("void field_fwd_kernel<512, 3>(ChainParams, ChainMaps, FieldLevels)", "kernel", 400),
        _event("void resnetfc_bwd_chain_kernel<512, true>(BwdParams, BwdMaps)", "kernel", 300),
        _event("void resnetfc_bwd_chain_kernel<512, false>(BwdParams, BwdMaps)", "kernel", 250),
        _event("void resnetfc_fwd_kernel<512>(ChainParams, ChainMaps, __nv_bfloat16 const*)",
               "kernel", 200),
        _event("layer_fwd_kernel(LayerParams)", "kernel", 120),
        _event("void layer_kernel<128, 1>(LayerParams)", "kernel", 40),
        _event("layer_colsum(float const*, float*, int, int)", "kernel", 6),
        _event("view_pool_colsum(float const*, float*, int, int)", "kernel", 4),
        _event("view_pool_bwd_kernel(float const*, float*, __nv_bfloat16*, float*, int, int, int, "
               "int, int)", "kernel", 30),
        _event("wgrad_products(WgradParams)", "kernel", 100),
        _event("void pyramid_gather_kernel<3, 8>(GatherParams)", "kernel", 50),
        _event("void at::native::(anonymous namespace)::grid_sampler_2d_kernel<float, int>(...)",
               "kernel", 25),
        _event("void posenc_kernel<__nv_bfloat16>(float const*, float const*, ...)", "kernel", 20),
        _event("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "kernel", 80),
        _event("void at::native::vectorized_elementwise_kernel<4, ...>", "kernel", 10),
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 5),
        _event("aten::mm", "cpu_op", 999),
    ]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    where, total, buckets, per_op = trace_summary.main(["--logdir", str(tmp_path), "--steps", "2"])
    assert where == "cuda" and total == pytest.approx(1.64)
    assert buckets == pytest.approx({
        "fused field kernels": 0.7, "block chains": 0.45, "layered path": 0.2,
        "weight-gradient products": 0.1, "lookup kernels": 0.075, "posenc kernel": 0.02,
        "cuDNN convolutions": 0.08, "elementwise (sampling, compositing, Adam)": 0.01,
        "host/device transfers": 0.005,
    })
    out = capsys.readouterr().out
    assert "per step (2): 0.820 ms" in out and "fused field kernels" in out
    cpu = [_event("aten::mm", "cpu_op", 700), _event("aten::add", "cpu_op", 300)]
    (tmp_path / "cpu.json").write_text(json.dumps({"traceEvents": cpu}))
    where, total, _, per_op = trace_summary.main(["--logdir", str(tmp_path / "cpu.json")])
    assert where == "cpu" and total == pytest.approx(1.0) and per_op["aten::mm"] == pytest.approx(0.7)



def _at(name, cat, ts, dur, tid, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid,
            "args": args}


def _flow(cat, fid, ph, ts, tid):
    return {"ph": ph, "cat": cat, "name": cat, "id": fid, "ts": ts, "pid": 0, "tid": tid}


def test_trace_summary_puts_device_time_down_to_the_programs_spans(tmp_path, capsys):
    """Launch-to-kernel flows give each kernel's launch; a launch inside
    an autograd node outside any span follows the node's forward flow to
    the forward operation's span; an unlinked launch on autograd's thread
    takes the span the step's thread holds; a kernel without a flow, none."""
    from pixelnerf_tpu_torch.tools import trace_summary

    main, grad = 1, 2
    events = [
        _at("pnt.step", "user_annotation", 0, 100, main),
        _at("pnt.encode", "user_annotation", 1, 9, main),
        _at("aten::convolution", "cpu_op", 2, 3, main), _flow("fwdbwd", 7, "s", 2, main),
        _at("cudaLaunchKernel", "cuda_runtime", 3, 1, main, correlation=99),
        _flow("ac2g", 99, "s", 3, main),
        _at("pnt.backward", "user_annotation", 50, 40, main),
        _at("ConvolutionBackward0", "cpu_op", 60, 5, grad), _flow("fwdbwd", 7, "f", 60, grad),
        _at("cudaLaunchKernel", "cuda_runtime", 61, 1, grad, correlation=100),
        _flow("ac2g", 100, "s", 61, grad),
        _at("pnt.mlp.bwd", "user_annotation", 70, 10, grad),
        _at("cuLaunchKernelEx", "cuda_driver", 71, 1, grad, correlation=101),
        _flow("ac2g", 101, "s", 71, grad),
        _at("torch::autograd::AccumulateGrad", "cpu_op", 84, 3, grad),
        _at("cudaLaunchKernel", "cuda_runtime", 85, 1, grad, correlation=102),
        _flow("ac2g", 102, "s", 85, grad),
        _at("cudnn_fprop_kernel", "kernel", 4, 10, 7, correlation=99),
        _at("cudnn_dgrad_kernel", "kernel", 62, 3, 7, correlation=100),
        _at("resnetfc_bwd_chain_kernel<512, false>", "kernel", 72, 2, 7, correlation=101),
        _at("vectorized_elementwise_kernel", "kernel", 86, 4, 7, correlation=102),
        _at("Memset (Device)", "gpu_memset", 95, 1, 7, correlation=103),
    ]
    spans = trace_summary.by_span({"traceEvents": events})
    assert spans == pytest.approx({"pnt.encode": 0.013, "pnt.mlp.bwd": 0.002,
                                   "pnt.backward": 0.004, None: 0.001})
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    trace_summary.main(["--logdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "by innermost pnt.* span" in out and "pnt.encode" in out and "(none)" in out

BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "pixelnerf_tpu"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
import pixelnerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pixelnerf_tpu_torch.__path__, "pixelnerf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from pixelnerf_tpu_torch.tools import make_synthetic_dataset
make_synthetic_dataset.main(["--out", sys.argv[1], "--n_objs", "2", "--n_views", "2", "--size", "8"])
print("imported", len(names))
"""


def test_every_module_imports_and_the_tools_run_without_jax(tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT, str(tmp_path / "out")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    n = int(res.stdout.strip().splitlines()[-1].split()[1])
    assert n >= 60 and "pixelnerf_tpu_torch.tools.trace_summary" not in res.stderr
    assert len(list((tmp_path / "out").rglob("*.png"))) == 4
