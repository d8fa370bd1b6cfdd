"""A run whose timed path is broken underneath comes out not correct.

The cells run here on the CPU at a tiny size (`bench_tiny`), the
program on its plain versions, the look for a card skipped; the limits
are this size's own, set above its sound readings. Each fault a cell can
have is planted where the program produces the result: a training step
that leaves its state unchanged, a step whose loss leaves half of the
batch out (the mean over the rest), a view whose rays are half left out,
a view whose answer is altered. One chip only, so no exchange to leave
out."""

import pytest
import torch

from bench_tiny import tiny_cell
import run

TRAIN_LIMITS = {"numbers": {"loss_gap": {"limit": 0.05}, "grad_gap": {"limit": 0.5},
                            "update_gap": {"limit": 0.5}}}
VIEW_LIMITS = {"numbers": {"rgb_mae": {"limit": 0.01}, "depth_mae": {"limit": 0.01},
                           "alpha_mae": {"limit": 0.01}}}
SEED = 2 ** 33 + 17


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# srn's bfloat16 step, and sn64's float32 step without the stem's max-pool
TRAIN_CONFIGS = ["srn", "sn64"]


def _train(config="srn"):
    return run.run_cell(tiny_cell("train", TRAIN_LIMITS, config), SEED, 0.1, False, "cpu")


def _view():
    return run.run_cell(tiny_cell("view", VIEW_LIMITS), SEED, 0.1, False, "cpu")


def test_sound_runs_are_correct():
    assert _train()["correct"] and _view()["correct"]


def test_sound_float32_run_without_first_pool_is_correct():
    assert _train("sn64")["correct"]


@pytest.mark.parametrize("config", TRAIN_CONFIGS)
def test_state_left_unchanged(monkeypatch, config):
    from pixelnerf_tpu_torch.train.step import MultiSteps

    monkeypatch.setattr(MultiSteps, "update", lambda self: False)
    res = _train(config)
    assert not res["correct"] and res["check"]["update_gap"]["value"] >= 0.99


@pytest.mark.parametrize("config", TRAIN_CONFIGS)
def test_half_batch_left_out(monkeypatch, config):
    from pixelnerf_tpu_torch.models import losses

    def half_mse(pred, target):
        sb = pred.shape[0] // 2
        return torch.mean((pred[:sb] - target[:sb]) ** 2)

    monkeypatch.setattr(losses, "mse_loss", half_mse)
    assert not _train(config)["correct"]


def _patch_render(monkeypatch, change):
    from pixelnerf_tpu_torch.eval import render_utils

    real = render_utils.make_chunk_renderer

    def make(model, rcfg):
        inner = real(model, rcfg)
        return lambda enc, rays, gen: change(inner(enc, rays, gen))

    monkeypatch.setattr(render_utils, "make_chunk_renderer", make)


def test_view_rays_half_left_out(monkeypatch):
    def half(out):
        cut = lambda v: torch.cat([v[:, :v.shape[1] // 2], torch.zeros_like(v[:, v.shape[1] // 2:])], 1)
        return {head: {k: cut(v) for k, v in vals.items()} for head, vals in out.items()}

    _patch_render(monkeypatch, half)
    assert not _view()["correct"]


def test_view_answer_altered(monkeypatch):
    def alter(out):
        out = {head: dict(vals) for head, vals in out.items()}
        out["fine"]["rgb"] = out["fine"]["rgb"] + 0.05
        return out

    _patch_render(monkeypatch, alter)
    assert not _view()["correct"]
