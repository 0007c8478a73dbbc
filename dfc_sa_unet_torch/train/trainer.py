"""Trainer: the epoch loop with the reference's training semantics, on one
device (counterpart of dfc_sa_unet_tpu/train/trainer.py).

Kept from the JAX trainer (reference utils/trainer.py:105-461):
  * forward -> sigmoid -> loss on f32 probabilities, hard IoU/Dice per batch;
  * a step whose loss or any gradient is not finite changes nothing
    (parameters, momentum, BatchNorm running statistics and their
    ``num_batches_tracked`` stay as they were), still counts as a step and
    is left out of the epoch's means;
  * gradient clip at global norm 1.0, SGD with momentum and weight decay;
  * ``grad_accum``: sequential microbatches, BatchNorm statistics thread
    through them, their losses are averaged, one update;
  * validation each epoch with the best and worst K samples by Dice;
  * best model = highest validation Dice; periodic and best checkpoints;
  * loss/Dice/IoU plots and CSVs each epoch, per-epoch sample dumps;
  * resume restores everything (weights, momentum, history, best metrics,
    step) and continues at epoch+1;
  * SIGTERM/SIGINT ask for a checkpoint and a clean stop.

The state lives in the trainer (the module, the optimiser, ``step``), where
the JAX trainer threads a TrainState through pure functions.  Optional bf16
compute keeps f32 parameters and an f32 loss.  Dropout masks depend on
(seed, step) alone, like the JAX trainer's ``fold_in(base_key, step)``
(the numbers differ), so a resumed run repeats them.

Not ported yet, each raising with a pointer to ROADMAP.md: a mesh,
multi-host training, ``exe_cache_dir`` and ``grad_accum_exact``.
"""

import os
import signal
import threading
import time
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from dfc_sa_unet_torch.data.loader import BatchLoader, binarize_mask, to_device
from dfc_sa_unet_torch.data.normalize import normalize
from dfc_sa_unet_torch.losses import compute_loss
from dfc_sa_unet_torch.metrics import hard_dice_iou, per_sample_hard_dice_iou
from dfc_sa_unet_torch.ops.dropout import set_dropout_generator
from dfc_sa_unet_torch.train import optim
from dfc_sa_unet_torch.utils import checkpoint as ckpt_util
from dfc_sa_unet_torch.utils.device import resolve_device
from dfc_sa_unet_torch.utils.profiling import StepTimer

HISTORY_KEYS = (
    "train_losses", "val_losses", "train_dice_scores", "val_dice_scores",
    "train_iou_scores", "val_iou_scores",
)


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to dfc_sa_unet_torch yet (see ROADMAP.md, Queue A 5 and A 11)")


def _step_seed(seed: int, step: int) -> int:
    """One generator seed per (seed, step), mixed so that the low 32 bits, all
    that a CPU generator reads, depend on both."""
    z = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB) % 2**64
    return (z ^ (z >> 31)) % 2**63


class Trainer:
    def __init__(
        self,
        model: nn.Module,
        train_loader: BatchLoader,
        val_loader: BatchLoader,
        config: Mapping[str, Any],
        mesh=None,
        seed: int = 0,
        compute_dtype=None,
        device=None,
        progress: bool = True,
    ):
        """``device`` None means CUDA and raises without it; ``compute_dtype``
        (None or torch.bfloat16) must be the dtype the model was built with;
        ``progress`` shows a tqdm bar per epoch."""
        self.device = resolve_device(device)
        if mesh is not None:
            _not_ported("training over a mesh")
        tr = config["training"]
        if tr.get("exe_cache_dir"):
            _not_ported("training.exe_cache_dir")
        if tr.get("grad_accum_exact"):
            _not_ported("training.grad_accum_exact")
        if tr.get("multihost") or tr.get("data_parallel") or int(tr.get("spatial_parallel", 1) or 1) > 1:
            _not_ported("multi-device training (data_parallel / spatial_parallel / multihost)")
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.config = config
        self.compute_dtype = compute_dtype or torch.float32
        self.progress = progress

        self.num_epochs = tr["num_epochs"]
        self.save_checkpoint_freq = tr.get("save_checkpoint_freq", 100)
        self.grad_accum = int(tr.get("grad_accum", 1))
        loss_cfg = tr.get("loss", {}) or {}
        self.loss_type = loss_cfg.get("type", "dice")
        self.loss_params = dict(loss_cfg.get("params", {}) or {})

        self.log_dir = config["logging"]["log_dir"].replace("\\", "/")
        self.images_dir = config["logging"]["images_dir"].replace("\\", "/")
        self.save_k = config["logging"].get("save_best_worst_samples", 0)
        os.makedirs(self.log_dir, exist_ok=True)
        os.makedirs(self.images_dir, exist_ok=True)
        self.checkpoint_dir = os.path.join(self.log_dir, "checkpoints")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.best_model_path = os.path.join(self.log_dir, "best_model")

        self.optimizer = optim.from_config(config, self.model.named_parameters())
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        set_dropout_generator(self.model, self.generator)
        self._bn_buffers = [b for m in self.model.modules() if isinstance(m, nn.BatchNorm2d)
                            for b in (m.running_mean, m.running_var, m.num_batches_tracked)]
        self.step = 0
        self.history = {k: [] for k in HISTORY_KEYS}
        self.epochs: list = []
        self.best_val_dice = 0.0
        self.best_val_loss = float("inf")
        self.start_epoch = 0
        self.start_time = time.time()
        self._stop_requested = threading.Event()
        self._input_bound_warned = False
        self.last_epoch_timer, self.last_epoch_applied = None, 0  # of the newest train_epoch

    # ---------------------------------------------------------------- steps

    def _inputs(self, images_u8: torch.Tensor, masks_u8: torch.Tensor):
        """uint8 NHWC images and masks on the device -> normalised NCHW
        (a channels_last view) in the compute dtype, and {0,1} f32 targets."""
        x = normalize(images_u8, self.compute_dtype).permute(0, 3, 1, 2)
        return x, binarize_mask(masks_u8)

    def train_step(self, images_u8: torch.Tensor, masks_u8: torch.Tensor) -> dict:
        """One update from one uint8 batch on the device.  Returns Python
        numbers: loss, iou, dice, and ``finite`` (False: the step was skipped)."""
        self.model.train()
        x, t = self._inputs(images_u8, masks_u8)
        self.generator.manual_seed(_step_seed(self.seed, self.step))
        stats_before = [b.clone() for b in self._bn_buffers]
        self.optimizer.zero_grad()
        bsz = x.shape[0]
        accum = self.grad_accum if self.grad_accum > 1 and bsz % self.grad_accum == 0 else 1
        losses, probs = [], []
        for xi, ti in zip(x.chunk(accum), t.chunk(accum)):
            p = torch.sigmoid(self.model(xi).float())
            loss_i = compute_loss(p, ti, self.loss_type, self.loss_params)
            (loss_i / accum).backward()
            losses.append(loss_i.detach())
            probs.append(p.detach())
        loss = torch.stack(losses).mean()
        probs = torch.cat(probs)
        # finiteness per tensor through its largest magnitude (NaN and inf pass through a max; a
        # squared norm would overflow long before a gradient does), fused over the tensors; one
        # flag, read once
        grads = [p.grad for _, p in self.optimizer.named_params if p.grad is not None]
        largest = torch.stack(torch._foreach_norm(grads, float("inf"))) if grads else loss.new_zeros(1)
        finite = torch.isfinite(loss) & torch.isfinite(largest).all()
        iou, dice = hard_dice_iou(probs, t)
        loss_v, iou_v, dice_v, finite_v = torch.stack([loss, iou, dice, finite.float()]).tolist()
        if finite_v:
            self.optimizer.step()
        else:
            with torch.no_grad():
                for buf, old in zip(self._bn_buffers, stats_before):
                    buf.copy_(old)
        self.optimizer.zero_grad()
        self.step += 1
        return {"loss": loss_v, "iou": iou_v, "dice": dice_v, "finite": bool(finite_v)}

    @torch.no_grad()
    def eval_step(self, images_u8: torch.Tensor, masks_u8: torch.Tensor) -> dict:
        """Loss, hard IoU and Dice of one batch, and both per sample, in eval mode."""
        self.model.eval()
        x, t = self._inputs(images_u8, masks_u8)
        probs = torch.sigmoid(self.model(x).float())
        loss = compute_loss(probs, t, self.loss_type, self.loss_params)
        iou, dice = hard_dice_iou(probs, t)
        ps_iou, ps_dice = per_sample_hard_dice_iou(probs, t)
        loss_v, iou_v, dice_v = torch.stack([loss, iou, dice]).tolist()
        return {"loss": loss_v, "iou": iou_v, "dice": dice_v,
                "per_sample_iou": ps_iou.cpu().numpy(), "per_sample_dice": ps_dice.cpu().numpy()}

    # ---------------------------------------------------------------- epochs

    def _progress(self, loader, desc):
        if not self.progress:
            return loader, None
        from tqdm import tqdm

        bar = tqdm(loader, total=len(loader), desc=desc, leave=False)
        return bar, bar

    def train_epoch(self, epoch: int):
        """One pass over the train loader.  Returns the means of loss, IoU
        and Dice over the steps that were applied."""
        self.train_loader.set_epoch(epoch)
        sums = {"loss": 0.0, "iou": 0.0, "dice": 0.0}
        n_used = 0
        timer = StepTimer(self.device)
        timer.tick()
        batches, bar = self._progress(self.train_loader, f"Epoch {epoch + 1}/{self.num_epochs} [Train]")
        # time spent in next() is the host pipeline failing to keep up with the device step
        wait_s = 0.0
        epoch_t0 = time.perf_counter()
        batch_iter = iter(batches)
        while True:
            t0 = time.perf_counter()
            batch = next(batch_iter, None)
            wait_s += time.perf_counter() - t0
            if batch is None:
                break
            imgs, masks = to_device(batch, self.device)
            metrics = self.train_step(imgs, masks)
            timer.tick(items=int(imgs.shape[0]))
            if not metrics["finite"]:
                print(f"Warning: non-finite loss or gradient at step {self.step}; batch skipped")
                continue
            if metrics["loss"] > 100:
                print(f"Warning: very large loss detected: {metrics['loss']:.6f}")
            for k in sums:
                sums[k] += metrics[k]
            n_used += 1
            if bar is not None:
                bar.set_postfix(loss=sums["loss"] / n_used, iou=sums["iou"] / n_used, dice=sums["dice"] / n_used)
            if self._stop_requested.is_set():
                break
        if bar is not None:
            bar.close()
        self.last_epoch_timer, self.last_epoch_applied = timer, n_used
        if timer.steps:
            print(f"  [epoch {epoch + 1}] {timer.summary()}")
        epoch_wall = time.perf_counter() - epoch_t0
        if not self._input_bound_warned and n_used >= 2 and epoch_wall > 0 and wait_s / epoch_wall > 0.3:
            self._input_bound_warned = True
            cache_hint = "" if getattr(getattr(self.train_loader, "dataset", None), "cache", True) \
                else " enable dataset.cache or"
            print(f"  [input-bound] {wait_s / epoch_wall:.0%} of epoch {epoch + 1} was spent waiting on the "
                  f"host loader -{cache_hint} raise training.num_workers")
        n = max(n_used, 1)
        return sums["loss"] / n, sums["iou"] / n, sums["dice"] / n

    def validate_epoch(self, loader: Optional[BatchLoader] = None) -> dict:
        loader = loader or self.val_loader
        sums = {"loss": 0.0, "iou": 0.0, "dice": 0.0}
        n_batches = 0
        sample_records = []  # (dice, iou, filename)
        for batch in loader:
            metrics = self.eval_step(*to_device(batch, self.device))
            if not np.isfinite(metrics["loss"]):
                print("Warning: NaN loss detected in validation; batch skipped")
                continue
            for k in sums:
                sums[k] += metrics[k]
            n_batches += 1
            for i, fname in enumerate(batch["filename"]):
                sample_records.append((float(metrics["per_sample_dice"][i]), float(metrics["per_sample_iou"][i]),
                                       fname))
        n = max(n_batches, 1)
        sample_records.sort(key=lambda r: r[0])
        k = self.save_k
        return {
            "loss": sums["loss"] / n,
            "iou": sums["iou"] / n,
            "dice": sums["dice"] / n,
            "worst_samples": sample_records[:k] if k else [],
            "best_samples": sample_records[-k:] if k else [],
        }

    # ------------------------------------------------------------ checkpoint

    def _state_to_tree(self, epoch: int) -> dict:
        opt = self.optimizer.state_dict()
        return {
            "epoch": int(epoch),
            "step": int(self.step),
            "model": {k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()},
            "optimizer": {"momentum_buffers": {k: v.cpu() for k, v in opt["momentum_buffers"].items()}},
            "history": {k: np.asarray(v, np.float64) for k, v in self.history.items()},
            "best_val_dice": float(self.best_val_dice),
            "best_val_loss": float(self.best_val_loss),
        }

    def save_checkpoint(self, epoch: int, is_best: bool = False) -> str:
        tree = self._state_to_tree(epoch)
        path = ckpt_util.save_tree(os.path.join(self.checkpoint_dir, f"checkpoint_epoch_{epoch + 1}"), tree)
        if is_best:
            ckpt_util.save_tree(os.path.join(self.checkpoint_dir, "best_checkpoint"), tree)
            ckpt_util.save_tree(self.best_model_path, tree["model"])
        return path

    def load_checkpoint(self, path: str):
        """Restore the full training state; sets start_epoch to epoch+1."""
        tree = ckpt_util.restore_tree(path)
        self.model.load_state_dict(tree["model"], strict=True)
        self.optimizer.load_state_dict(tree["optimizer"])
        self.history = {k: [float(x) for x in np.asarray(v)] for k, v in tree["history"].items()}
        self.epochs = list(range(1, len(self.history["train_losses"]) + 1))
        self.best_val_dice = float(tree["best_val_dice"])
        self.best_val_loss = float(tree["best_val_loss"])
        self.start_epoch = int(tree["epoch"]) + 1
        self.step = int(tree["step"])
        print(f"Resuming from epoch {self.start_epoch}")

    # ---------------------------------------------------------------- train

    @torch.no_grad()
    def _dump_samples(self, records, out_dir: str):
        """Re-read the K selected samples and render prediction dumps."""
        if not records:
            return
        from dfc_sa_unet_torch.utils.visualization import save_prediction_samples

        os.makedirs(out_dir, exist_ok=True)
        dataset = self.val_loader.dataset
        by_name = {s[2]: i for i, s in enumerate(dataset.samples)}
        self.model.eval()
        for _, _, fname in records:
            idx = by_name.get(fname)
            if idx is None:
                continue
            sample = dataset.__getitem__(idx)
            img = torch.from_numpy(np.array(sample["image"])[None]).to(self.device)
            mask = torch.from_numpy(np.array(sample["mask"])[None]).to(self.device)
            x, t = self._inputs(img, mask)
            probs = torch.sigmoid(self.model(x).float())
            save_prediction_samples(x.float().cpu().numpy(), probs.cpu().numpy(), t.cpu().numpy(), [fname],
                                    out_dir, channels_last=False)

    def _install_preemption_handler(self):
        if threading.current_thread() is not threading.main_thread():
            return

        def handler(signum, frame):
            print(f"Signal {signum} received - will checkpoint and stop at the epoch boundary")
            self._stop_requested.set()

        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass

    def train(self, resume_from: Optional[str] = None):
        from dfc_sa_unet_torch.utils.visualization import save_loss_plot, save_metrics_plot

        if resume_from:
            self.load_checkpoint(resume_from)
        self._install_preemption_handler()
        print(f"Using loss: {self.loss_type} params={self.loss_params}")
        for epoch in range(self.start_epoch, self.num_epochs):
            if self._stop_requested.is_set():
                self.save_checkpoint(epoch - 1)
                print(f"Preemption checkpoint saved at epoch {epoch}; exiting")
                break
            tr_loss, tr_iou, tr_dice = self.train_epoch(epoch)
            val = self.validate_epoch()

            self.epochs.append(epoch + 1)
            self.history["train_losses"].append(tr_loss)
            self.history["val_losses"].append(val["loss"])
            self.history["train_dice_scores"].append(tr_dice)
            self.history["val_dice_scores"].append(val["dice"])
            self.history["train_iou_scores"].append(tr_iou)
            self.history["val_iou_scores"].append(val["iou"])

            print(f"Epoch [{epoch + 1}/{self.num_epochs}]")
            print(f"  Train Loss: {tr_loss:.4f}, Dice: {tr_dice:.4f}, IoU: {tr_iou:.4f}")
            print(f"  Val Loss: {val['loss']:.4f}, Dice: {val['dice']:.4f}, IoU: {val['iou']:.4f}")

            is_best = val["dice"] > self.best_val_dice
            if is_best:
                self.best_val_dice = val["dice"]
                print(f"  Saved best model with validation dice: {self.best_val_dice:.4f}")
            self.best_val_loss = min(self.best_val_loss, val["loss"])

            if (epoch + 1) % self.save_checkpoint_freq == 0 or is_best:
                self.save_checkpoint(epoch, is_best)

            save_loss_plot(self.history["train_losses"], self.history["val_losses"],
                           os.path.join(self.images_dir, "loss_plot.png"))
            save_metrics_plot(self.epochs, self.history["train_dice_scores"], self.history["val_dice_scores"],
                              "Dice", os.path.join(self.images_dir, "dice_plot.png"))
            save_metrics_plot(self.epochs, self.history["train_iou_scores"], self.history["val_iou_scores"],
                              "IoU", os.path.join(self.images_dir, "iou_plot.png"))

            if self.save_k:
                epoch_dir = os.path.join(self.log_dir, f"epoch_{epoch + 1}")
                self._dump_samples(val["best_samples"], os.path.join(epoch_dir, "best_samples"))
                self._dump_samples(val["worst_samples"], os.path.join(epoch_dir, "worst_samples"))

        total = time.time() - self.start_time
        h, rem = divmod(total, 3600)
        m, s = divmod(rem, 60)
        print(f"Training completed in {int(h)}h {int(m)}m {int(s)}s")
        print(f"Best validation dice: {self.best_val_dice:.4f}")
        if os.path.isfile(self.best_model_path):
            print(f"Best model saved to {self.best_model_path}")
        else:  # the validation dice never exceeded 0.0: nothing was saved
            print("No best model saved (validation dice never improved)")
        return self
