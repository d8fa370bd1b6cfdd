"""Generic training loop with intervals, checkpointing and tensorboard.

Counterpart of `pixelnerf_tpu/train/trainer.py` (the reference Trainer,
train/trainlib/trainer.py:10-257): subclasses provide train_step,
eval_step and vis_step; the loop owns the print/eval/save/vis intervals,
epoch repeats, resume of the model, optimizer and iteration state, and
tensorboard scalars. The state is a torch model and a `MultiSteps`
optimizer, both updated in place. A step returns its losses as device
tensors; the loop converts them with `float()` only at a print, eval or
log interval, so the steps in between never wait for the device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable

import numpy as np

from pixelnerf_tpu_torch.utils import checkpoint as ckpt
from pixelnerf_tpu_torch.utils.visualize import write_png

__all__ = ["Trainer", "data_loop"]


def data_loop(dl: Iterable):
    """Loop an iterable forever (reference trainer.py:154-160)."""
    while True:
        for x in iter(dl):
            yield x


class Trainer:
    """Generic loop. Subclass and override train_step/eval_step/vis_step.

    :param model the torch model, its weights already loaded
    :param optimizer a `train.step.MultiSteps`
    :param train_loader / test_loader BatchLoader-like iterables of collated
        numpy batch dicts
    """

    def __init__(self, model, optimizer, train_loader, test_loader, args, conf):
        self.model = model
        self.optimizer = optimizer
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.args = args

        tconf = conf["train"] if "train" in conf else conf
        self.save_interval = tconf.get_int("save_interval", 50)
        self.print_interval = tconf.get_int("print_interval", 2)
        self.vis_interval = tconf.get_int("vis_interval", 100)
        self.eval_interval = tconf.get_int("eval_interval", 50)
        self.num_epoch_repeats = tconf.get_int("num_epoch_repeats", 1)
        self.num_epochs = args.epochs

        self.summary_path = os.path.join(args.logs_path, args.name)
        self.visual_path = os.path.join(args.visual_path, args.name)
        os.makedirs(self.summary_path, exist_ok=True)
        os.makedirs(self.visual_path, exist_ok=True)
        self.writer = self._make_writer(self.summary_path)
        self.fixed_test = getattr(args, "fixed_test", False)

        cp = args.checkpoints_path
        self.iter_state_path = os.path.join(cp, args.name, "_iter")
        self.optim_state_path = os.path.join(cp, args.name, "_optim")

        self.start_iter_id = 0
        self.start_epoch = 0
        if args.resume:
            self._resume()

    def _make_writer(self, path: str):
        """A tensorboard writer, tensorboardX's or else torch's, where one
        imports; else None (no scalars are logged)."""
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return None
        return SummaryWriter(path)

    def _resume(self) -> None:
        if os.path.exists(self.optim_state_path):
            if ckpt.is_flax_checkpoint(self.optim_state_path):
                # an optax state has no torch.optim counterpart to load into
                print(f"Not read: {self.optim_state_path} is a JAX (optax) optimizer state; "
                      "the optimizer starts afresh from the loaded weights")
            else:
                device = next(self.model.parameters()).device
                self.optimizer.load_state_dict(ckpt.load_state(self.optim_state_path, device))
        if os.path.exists(self.iter_state_path + ".json"):
            with open(self.iter_state_path + ".json") as f:
                meta = json.load(f)
            self.start_iter_id = int(meta.get("iter", 0))
            self.start_epoch = int(meta.get("epoch", 0))

    def save_checkpoint(self, epoch: int, step_id: int) -> None:
        ckpt.save_model_weights(self.model, self.args.checkpoints_path, self.args.name)
        ckpt.save_state(self.optim_state_path, self.optimizer.state_dict())
        tmp = self.iter_state_path + ".json.tmp"
        with open(tmp, "w") as f:
            json.dump({"iter": step_id + 1, "epoch": epoch}, f)
        os.replace(tmp, self.iter_state_path + ".json")
        self.extra_save_state()

    def current_lr(self, epoch: int) -> float:
        """The learning rate the optimizer applies next."""
        return self.optimizer.lr()

    # -------- hooks (reference trainer.py:116-148) --------------------- #

    def post_batch(self, epoch: int, batch: int) -> None:
        pass

    def extra_save_state(self) -> None:
        pass

    def train_step(self, data: Dict, global_step: int) -> Dict:
        raise NotImplementedError()

    def eval_step(self, data: Dict, global_step: int) -> Dict:
        raise NotImplementedError()

    def vis_step(self, data: Dict, global_step: int):
        return None, None

    # ------------------------------------------------------------------ #

    def start(self) -> None:
        def fmt_loss_str(losses):
            return "loss " + " ".join(f"{k}:{float(v):.6f}" for k, v in losses.items())

        test_iter = data_loop(self.test_loader)
        step_id = self.start_iter_id
        print("Starting training at step", step_id)
        if self.start_epoch >= self.num_epochs:
            print(
                f"Nothing to do: resumed at epoch {self.start_epoch} but "
                f"--epochs is {self.num_epochs}; raise --epochs to continue."
            )

        for epoch in range(self.start_epoch, self.num_epochs):
            if self.writer:
                self.writer.add_scalar("lr", self.current_lr(epoch), global_step=step_id)

            batch = 0
            for _ in range(self.num_epoch_repeats):
                for data in self.train_loader:
                    losses = self.train_step(data, global_step=step_id)
                    if batch % self.print_interval == 0:
                        print("E", epoch, "B", batch, fmt_loss_str(losses),
                              " lr", self.current_lr(epoch))

                    if batch % self.eval_interval == 0:
                        test_data = next(test_iter)
                        test_losses = self.eval_step(test_data, global_step=step_id)
                        if self.writer:
                            for k, v in losses.items():
                                self.writer.add_scalar(f"train/{k}", float(v), global_step=step_id)
                            for k, v in test_losses.items():
                                self.writer.add_scalar(f"test/{k}", float(v), global_step=step_id)
                        print("*** Eval:", "E", epoch, "B", batch, fmt_loss_str(test_losses))

                    if batch % self.save_interval == 0 and (epoch > 0 or batch > 0):
                        print("saving")
                        self.save_checkpoint(epoch, step_id)

                    if batch % self.vis_interval == 0:
                        print("generating visualization")
                        if self.fixed_test:
                            test_data = next(iter(self.test_loader))
                        else:
                            test_data = next(test_iter)
                        vis, vis_vals = self.vis_step(test_data, global_step=step_id)
                        if vis_vals is not None and self.writer:
                            for k, v in vis_vals.items():
                                self.writer.add_scalar(f"vis/{k}", float(v), global_step=step_id)
                        if vis is not None:
                            vis_u8 = (np.clip(vis, 0, 1) * 255).astype(np.uint8)
                            write_png(
                                os.path.join(self.visual_path, f"{epoch:04d}_{batch:04d}_vis.png"),
                                vis_u8,
                            )

                    self.post_batch(epoch, batch)
                    step_id += 1
                    batch += 1
        if self.writer:
            self.writer.close()
