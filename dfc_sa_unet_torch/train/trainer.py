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
    through them, their losses are averaged, one update; with
    ``grad_accum_exact`` one loss over the probabilities of every
    microbatch (the monolithic batch's loss for the batch-coupled Dice and
    Tversky sums), each microbatch's forward rematerialised in the backward
    (``ops/dropout.py::remat_call``: 2 forwards and 1 backward a
    microbatch, the memory of one microbatch's graph); a batch that
    ``grad_accum`` does not divide runs as one monolithic step;
  * validation each epoch with the best and worst K samples by Dice;
  * best model = highest validation Dice; periodic and best checkpoints;
  * loss/Dice/IoU plots and CSVs each epoch, per-epoch sample dumps;
  * resume restores everything (weights, momentum, history, best metrics,
    step) and continues at epoch+1;
  * SIGTERM/SIGINT ask for a checkpoint and a clean stop;
  * data parallelism over processes (``mesh=``, parallel/mesh.py), one
    process a card: each process trains on its contiguous chunk of the
    global batch (``BatchLoader(shard=...)``) with BatchNorm statistics
    and the loss over the global batch (parallel/spmd.py), the gradients
    averaged in one flat all-reduce a step, then the clip, the
    finiteness check and the update, identical on every process; the
    result equals the single-device step on the global batch.  With
    ``grad_accum`` > 1 the loader hands each process its share of every
    global microbatch (``BatchLoader(microbatches=...)``), so microbatch m
    is the single-device microbatch m split across the processes, as in
    JAX.  A train batch that does not divide (or whose microbatch does
    not) runs whole on every process with every collective off; a padded
    eval batch masks its padding (``sample_mask``).  Only the primary
    process writes files;
  * row (spatial) sharding of every model of the factory (a mesh with
    ``spatial`` S > 1, ``parallel.mesh.serving_mesh``): each of the S ranks of
    a data index takes that index's chunk of every batch and its band of the
    images' rows, cut on the host before the copy to the card, and runs the
    step in the band's context (parallel/rows.py: halo exchanges, the pooled
    attention's pool over the bands, GroupNorm's statistics over the group,
    the transformers' tokens and the full-resolution attention's keys
    gathered).  The loss sums, the hard counts and BatchNorm's statistics
    reduce over every process, whose pixels are all different, and the
    gradient average stays over every process: the step equals one process's
    on the whole batch, with ``grad_accum``, ``grad_accum_exact`` and
    ``remat`` too.  The ranks of a data index seed their dropout alike (the
    token stage runs whole on each).  A height that is not a multiple of S
    times the family's stride (``rows.family_stride``: 16, or ViT-seg's
    patch) shards the batch on the data axis only, with JAX's warning, the
    spatial ranks of a data index computing the same thing (the collectives
    then over the data axis);
  * ``exe_cache_dir`` is where the hand-written CUDA kernels are built and
    loaded from (``ops/_build.py::set_build_dir``): eager PyTorch compiles
    nothing per shape, so the nvcc libraries are the only compiled
    artifacts to cache.

The state lives in the trainer (the module, the optimiser, ``step``), where
the JAX trainer threads a TrainState through pure functions.  Optional bf16
compute keeps f32 parameters and an f32 loss.  Dropout masks depend on
(seed, step) alone, like the JAX trainer's ``fold_in(base_key, step)``
(the numbers differ), so a resumed run repeats them; under data
parallelism the data index is folded in as well, so the processes of two
data indices drop different units (as JAX's explicit SPMD step does) and
the bands of one image the same.
"""

import contextlib
import functools
import os
import signal
import threading
import time
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from dfc_sa_unet_torch.data.loader import BatchLoader, binarize_mask, to_device
from dfc_sa_unet_torch.data.normalize import normalize
from dfc_sa_unet_torch.losses import compute_loss
from dfc_sa_unet_torch.metrics import hard_dice_iou, per_sample_hard_dice_iou
from dfc_sa_unet_torch.nn.layers import bn_cross_replica
from dfc_sa_unet_torch.ops import _build
from dfc_sa_unet_torch.ops.dropout import remat_call, set_dropout_generator
from dfc_sa_unet_torch.parallel import multihost as mh, rows, spmd
from dfc_sa_unet_torch.train import optim
from dfc_sa_unet_torch.utils import checkpoint as ckpt_util
from dfc_sa_unet_torch.utils.device import resolve_device
from dfc_sa_unet_torch.utils.profiling import StepTimer

HISTORY_KEYS = (
    "train_losses", "val_losses", "train_dice_scores", "val_dice_scores",
    "train_iou_scores", "val_iou_scores",
)


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
        """``device`` None means the mesh's device, or CUDA (raising without it);
        ``mesh`` a ``parallel.mesh.ProcessMesh`` (data parallelism when it holds
        a group); ``compute_dtype`` (None or torch.bfloat16) must be the dtype the
        model was built with; ``progress`` shows a tqdm bar per epoch."""
        self.device = resolve_device(mesh.device if device is None and mesh is not None else device)
        # a flag, not the group: the group is the default one, and a held reference would outlive
        # destroy_process_group (parallel/mesh.py)
        self.data_parallel = mesh is not None and mesh.group is not None
        self.rank, self.world = (mesh.rank, mesh.world_size) if self.data_parallel else (0, 1)
        self.is_primary = self.rank == 0
        # row sharding: S ranks a data index, each on a band of the rows (training.spatial_parallel is
        # the CLI's to act on, as data_parallel is: the Trainer takes its mesh)
        self.mesh = mesh if self.data_parallel else None
        self.spatial = mesh.spatial if self.data_parallel else 1
        self.data_axis = self.world // self.spatial
        if self.spatial > 1:
            rows.check_model(model)
        self.stride = rows.family_stride(model)
        # the dropout seed of a step: the data index's, shared by the ranks of a spatial group, whose token
        # stages (ViT-seg, TransUNet) compute the same tokens whole and must draw the same masks
        self.data_index = mesh.data_index if self.data_parallel else 0
        tr = config["training"]
        self.grad_accum = int(tr.get("grad_accum", 1))
        self.grad_accum_exact = bool(tr.get("grad_accum_exact", False))
        if (self.data_parallel and self.grad_accum > 1 and getattr(train_loader, "shard", None) is not None
                and getattr(train_loader, "microbatches", 1) != self.grad_accum):
            # JAX's microbatch m under a mesh is the single-device microbatch m split across the
            # processes; a process splitting its own chunk would put other rows in each BatchNorm batch
            raise ValueError(f"training.grad_accum {self.grad_accum} under data parallelism needs a train loader "
                             f"built with microbatches={self.grad_accum}")
        if tr.get("exe_cache_dir"):
            _build.set_build_dir(tr["exe_cache_dir"])
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.config = config
        self.compute_dtype = compute_dtype or torch.float32
        self.progress = progress and self.is_primary

        self.num_epochs = tr["num_epochs"]
        self.save_checkpoint_freq = tr.get("save_checkpoint_freq", 100)
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
        if self.data_parallel:
            mh.broadcast_tree(self.model.state_dict())  # rank 0's seeded or loaded weights everywhere
        self.step = 0
        self.history = {k: [] for k in HISTORY_KEYS}
        self.epochs: list = []
        self.best_val_dice = 0.0
        self.best_val_loss = float("inf")
        self.start_epoch = 0
        self.start_time = time.time()
        self._stop_requested = threading.Event()
        self._input_bound_warned = False
        self._warned_accum_replicated = False
        self._warned_spatial = False
        self.last_epoch_timer, self.last_epoch_applied = None, 0  # of the newest train_epoch

    # ---------------------------------------------------------------- steps

    def _inputs(self, images_u8: torch.Tensor, masks_u8: torch.Tensor):
        """uint8 NHWC images and masks on the device -> normalised NCHW
        (a channels_last view) in the compute dtype, and {0,1} f32 targets."""
        x = normalize(images_u8, self.compute_dtype).permute(0, 3, 1, 2)
        return x, binarize_mask(masks_u8)

    def _probs(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.model(x).float())

    def layout(self, height: int, sharded: bool):
        """(band, group, sharded) of a batch of ``height`` rows that the loader sharded over the data
        axis (``sharded``) or not: under row sharding, this process's band of the rows and the
        collectives over every process (group None); where the height breaks the band rule
        (rows.divides), no band, with JAX's warning once, and the collectives over the data axis (none
        where the data axis is one process)."""
        if not sharded or self.spatial == 1:
            return None, None, sharded
        if rows.divides(height, self.spatial, self.stride):
            return self.mesh.band(height), None, True
        if not self._warned_spatial and self.is_primary:
            print(f"Warning: image height {height} is not divisible by the mesh's spatial axis ({self.spatial}) "
                  f"into bands of whole rows of the model's coarsest grid (a multiple of "
                  f"{self.spatial * self.stride}); sharding the batch dimension only.")
        self._warned_spatial = True
        if self.data_axis == 1:
            return None, None, False
        return None, self.mesh.data_group, True

    def band_rows(self, batch: dict, band) -> dict:
        """The batch's images and masks cut to ``band``'s rows on the host (the batch itself without one)."""
        if band is None:
            return batch
        cut = slice(band.row0, band.row0 + band.rows)
        return {**batch, "image": batch["image"][:, cut], "mask": batch["mask"][:, cut]}

    def train_step(self, images_u8: torch.Tensor, masks_u8: torch.Tensor, replicated: bool = False, band=None,
                   group=None) -> dict:
        """One update from one uint8 batch on the device: this process's share of the global
        batch under data parallelism (with ``grad_accum`` > 1, its share of each microbatch in
        turn), or the whole batch on every process when ``replicated``.  Under row sharding
        (``layout``) the images are ``band``'s rows, or, without a band, the collectives run over
        ``group`` (the data axis).
        Returns Python numbers: loss, iou, dice, and ``finite`` (False: the step was skipped)."""
        self.model.train()
        x, t = self._inputs(images_u8, masks_u8)
        collective = self.data_parallel and not replicated
        seed = _step_seed(self.seed, self.step)
        self.generator.manual_seed(_step_seed(seed, self.data_index) if collective else seed)
        stats_before = [b.clone() for b in self._bn_buffers]
        self.optimizer.zero_grad()
        bsz = x.shape[0]
        accum = self.grad_accum if self.grad_accum > 1 and bsz % self.grad_accum == 0 else 1
        if self.data_parallel and replicated and accum > 1 and (bsz // accum) % self.data_axis:
            if not self._warned_accum_replicated and self.is_primary:
                print(f"Warning: microbatch {bsz}//{accum} does not divide the data axis ({self.data_axis}); running "
                      f"the grad-accum loop fully replicated for exactness (all parallel speedup lost) — pick "
                      f"grad_accum/batch so (B/accum) % data == 0")
            self._warned_accum_replicated = True
        loss_fn = functools.partial(spmd.global_loss, group=group) if collective else compute_loss
        with (bn_cross_replica(group=group) if collective else contextlib.nullcontext()), rows.band_context(band):
            if accum > 1 and self.grad_accum_exact:
                # one loss over the whole batch's probabilities; each microbatch's forward runs again
                # in the backward (with the same dropout masks and BatchNorm statistics left alone),
                # so only one microbatch's graph is held at a time.  Under data parallelism every
                # process reaches the recomputations, and their collectives, in the same order.
                probs = torch.cat([remat_call(self._probs, xi, generator=self.generator) for xi in x.chunk(accum)])
                loss = loss_fn(probs, t, self.loss_type, self.loss_params)
                loss.backward()
                loss, probs = loss.detach(), probs.detach()
            else:
                losses, probs = [], []
                for xi, ti in zip(x.chunk(accum), t.chunk(accum)):
                    p = self._probs(xi)
                    loss_i = loss_fn(p, ti, self.loss_type, self.loss_params)
                    (loss_i / accum).backward()
                    losses.append(loss_i.detach())
                    probs.append(p.detach())
                loss = torch.stack(losses).mean()
                probs = torch.cat(probs)
        grads = [p.grad for _, p in self.optimizer.named_params if p.grad is not None]
        bad_loss = (~torch.isfinite(loss)).float().reshape(1)
        if self.data_parallel:
            # one all-reduce: the gradients (averaged), the count of processes with a bad loss and,
            # when the batch is sharded, the global hard-metric counts; every process then takes
            # the same clip, finiteness decision and update
            extra = torch.cat([bad_loss, spmd.hard_counts(probs, t)]) if collective else bad_loss
            flat = _flatten_dense_tensors(grads + [extra])
            dist.all_reduce(flat)
            n_grad = flat.numel() - extra.numel()
            torch._foreach_copy_(grads, _unflatten_dense_tensors(flat[:n_grad].div_(self.world), grads))
            bad_loss, counts = flat[n_grad:n_grad + 1], flat[n_grad + 1:]
            if group is not None:  # the data axis's counts, summed once by each spatial rank
                counts = counts / self.spatial
        # finiteness per tensor through its largest magnitude (NaN and inf pass through a max; a
        # squared norm would overflow long before a gradient does), fused over the tensors; one
        # flag, read once
        largest = torch.stack(torch._foreach_norm(grads, float("inf"))) if grads else loss.new_zeros(1)
        finite = (bad_loss == 0).all() & torch.isfinite(largest).all()
        iou, dice = spmd.dice_iou_from_counts(counts) if collective else hard_dice_iou(probs, t)
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
    def eval_step(self, images_u8: torch.Tensor, masks_u8: torch.Tensor, valid=None, sharded: bool = False,
                  band=None, group=None) -> dict:
        """Loss, hard IoU and Dice of one batch, and both per sample, in eval mode.  ``valid`` ([B]
        of 0/1) marks the real rows of a zero-padded batch: the padding's probabilities are zeroed
        and the losses skip it, so the metrics are those of the real rows.  ``sharded``: the batch
        is this process's chunk and loss, IoU and Dice are the global batch's (reduced over
        ``group``, default every process); ``band``: the images are its rows (``layout``), and the
        per-sample metrics are summed over the spatial group."""
        self.model.eval()
        x, t = self._inputs(images_u8, masks_u8)
        with rows.band_context(band):
            probs = torch.sigmoid(self.model(x).float())
            if valid is not None:
                probs = probs * valid.reshape(-1, 1, 1, 1)
            if sharded:
                loss = spmd.global_loss(probs, t, self.loss_type, self.loss_params, sample_mask=valid, group=group)
                iou, dice = spmd.global_hard_dice_iou(probs, t, group=group)
            else:
                loss = compute_loss(probs, t, self.loss_type, self.loss_params, sample_mask=valid)
                iou, dice = hard_dice_iou(probs, t)
        if band is not None:
            ps_iou, ps_dice = spmd.per_sample_hard_dice_iou(probs, t, group=band.group)
        else:
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
            if batch.get("valid") is not None:
                raise ValueError("a padded batch reached the train step: build the train loader with "
                                 "partial='replicate' (padding would change the BatchNorm statistics)")
            # a partial batch, or a loader that does not shard, runs whole on every process
            replicated = self.data_parallel and (bool(batch.get("replicated")) or "filename_global" not in batch)
            band, group, sharded = self.layout(batch["image"].shape[1], not replicated)
            imgs, masks = to_device(self.band_rows(batch, band), self.device)
            metrics = self.train_step(imgs, masks, replicated=self.data_parallel and not sharded, band=band,
                                      group=group)
            timer.tick(items=int(imgs.shape[0]))
            if not metrics["finite"]:
                if self.is_primary:
                    print(f"Warning: non-finite loss or gradient at step {self.step}; batch skipped")
                continue
            if metrics["loss"] > 100 and self.is_primary:
                print(f"Warning: very large loss detected: {metrics['loss']:.6f}")
            for k in sums:
                sums[k] += metrics[k]
            n_used += 1
            if bar is not None:
                bar.set_postfix(loss=sums["loss"] / n_used, iou=sums["iou"] / n_used, dice=sums["dice"] / n_used)
            if self._check_stop():
                break
        if bar is not None:
            bar.close()
        self.last_epoch_timer, self.last_epoch_applied = timer, n_used
        if timer.steps and self.is_primary:
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
            sharded = self.data_parallel and "filename_global" in batch and not batch.get("replicated")
            band, group, sharded = self.layout(batch["image"].shape[1], sharded)
            valid = batch.get("valid")
            valid = None if valid is None else torch.as_tensor(valid, dtype=torch.float32).to(self.device)
            metrics = self.eval_step(*to_device(self.band_rows(batch, band), self.device), valid=valid,
                                     sharded=sharded, band=band, group=group)
            if not np.isfinite(metrics["loss"]):
                if self.is_primary:
                    print("Warning: NaN loss detected in validation; batch skipped")
                continue
            for k in sums:
                sums[k] += metrics[k]
            n_batches += 1
            names = batch["filename_global"] if sharded else batch["filename"]
            ps_dice, ps_iou = metrics["per_sample_dice"], metrics["per_sample_iou"]
            if sharded:  # per-sample values in the global batch's order, on every process
                ps_dice, ps_iou = mh.gather_rows_many([ps_dice, ps_iou], len(names), every=self.spatial)
            for i, fname in enumerate(names):
                sample_records.append((float(ps_dice[i]), float(ps_iou[i]), fname))
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

    def save_checkpoint(self, epoch: int, is_best: bool = False) -> Optional[str]:
        """Written by the primary process only (the state is the same on every process); returns
        the path, or None on the others."""
        if not self.is_primary:
            return None
        tree = self._state_to_tree(epoch)
        path = ckpt_util.save_tree(os.path.join(self.checkpoint_dir, f"checkpoint_epoch_{epoch + 1}"), tree)
        if is_best:
            ckpt_util.save_tree(os.path.join(self.checkpoint_dir, "best_checkpoint"), tree)
            ckpt_util.save_tree(self.best_model_path, tree["model"])
        return path

    def load_checkpoint(self, path: str):
        """Restore the full training state; sets start_epoch to epoch+1.  Under data parallelism
        every process reads the same file, and rank 0's values are then broadcast."""
        tree = ckpt_util.restore_tree(path)
        self.model.load_state_dict(tree["model"], strict=True)
        self.optimizer.load_state_dict(tree["optimizer"])
        if self.data_parallel:
            mh.broadcast_tree({"model": self.model.state_dict(), "momentum": self.optimizer.momentum_buffers})
        self.history = {k: [float(x) for x in np.asarray(v)] for k, v in tree["history"].items()}
        self.epochs = list(range(1, len(self.history["train_losses"]) + 1))
        self.best_val_dice = float(tree["best_val_dice"])
        self.best_val_loss = float(tree["best_val_loss"])
        self.start_epoch = int(tree["epoch"]) + 1
        self.step = int(tree["step"])
        if self.is_primary:
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

    def _check_stop(self) -> bool:
        """The preemption flag, agreed on by every process (a process leaving the loop alone would
        block the others in their next collective)."""
        stop = self._stop_requested.is_set()
        return mh.any_flag(stop) if self.data_parallel else stop

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
        log = print if self.is_primary else (lambda *a, **k: None)
        log(f"Using loss: {self.loss_type} params={self.loss_params}")
        for epoch in range(self.start_epoch, self.num_epochs):
            if self._check_stop():
                self.save_checkpoint(epoch - 1)
                log(f"Preemption checkpoint saved at epoch {epoch}; exiting")
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

            log(f"Epoch [{epoch + 1}/{self.num_epochs}]")
            log(f"  Train Loss: {tr_loss:.4f}, Dice: {tr_dice:.4f}, IoU: {tr_iou:.4f}")
            log(f"  Val Loss: {val['loss']:.4f}, Dice: {val['dice']:.4f}, IoU: {val['iou']:.4f}")

            # the validation metrics are the global batch's on every process: the same decision
            is_best = val["dice"] > self.best_val_dice
            if is_best:
                self.best_val_dice = val["dice"]
                log(f"  Saved best model with validation dice: {self.best_val_dice:.4f}")
            self.best_val_loss = min(self.best_val_loss, val["loss"])

            if (epoch + 1) % self.save_checkpoint_freq == 0 or is_best:
                self.save_checkpoint(epoch, is_best)
            if not self.is_primary:
                continue

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
        if not self.is_primary:
            return self
        print(f"Training completed in {int(h)}h {int(m)}m {int(s)}s")
        print(f"Best validation dice: {self.best_val_dice:.4f}")
        if os.path.isfile(self.best_model_path):
            print(f"Best model saved to {self.best_model_path}")
        else:  # the validation dice never exceeded 0.0: nothing was saved
            print("No best model saved (validation dice never improved)")
        return self
