"""Training entry point: ``python -m dfc_sa_unet_torch.train`` (counterpart of
the JAX package's train.py, with its flags).

    python -m dfc_sa_unet_torch.train --config configs/config_dfc-sa-res-block.yaml \\
        [--resume CKPT] [--loss {dice,tversky,bce_dice,joint}] [--alpha A]
        [--beta B] [--weight_bce W] [--weight_dice W] [--bce_weight W]
        [--dice_weight W] [--contour_weight W] [--augmentation true|false]
        [--bf16 | --no_bf16] [--remat [all|l12|deep]] [--seed N]
        [--grad_accum N] [--device cuda|cpu]

Runs on the card; without CUDA it raises unless ``--device cpu`` is given.
``--bf16`` computes in bfloat16 with f32 parameters and an f32 loss.  The
JAX CLI's parallel, multi-host, ``--exe_cache`` and ``--grad_accum_exact``
flags are not taken (ROADMAP.md), nor ``--use_pallas`` / ``--no_pallas``: on
the card the attention kernels always run.
"""

import argparse

import torch

from dfc_sa_unet_torch.config import apply_overrides, load_config, merge_bf16_flag
from dfc_sa_unet_torch.utils.device import resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a segmentation model (PyTorch, one GPU)")
    parser.add_argument("--config", type=str, required=True, help="Path to config file")
    parser.add_argument("--resume", type=str, help="Checkpoint to resume from")
    parser.add_argument("--loss", type=str, choices=["dice", "tversky", "bce_dice", "joint"])
    parser.add_argument("--alpha", type=float, help="Tversky alpha (FP weight)")
    parser.add_argument("--beta", type=float, help="Tversky beta (FN weight)")
    parser.add_argument("--weight_bce", type=float)
    parser.add_argument("--weight_dice", type=float)
    parser.add_argument("--bce_weight", type=float)
    parser.add_argument("--dice_weight", type=float)
    parser.add_argument("--contour_weight", type=float)
    parser.add_argument("--augmentation", type=lambda x: str(x).lower() == "true", default=None,
                        help="Enable/disable data augmentation (true/false)")
    parser.add_argument("--bf16", action="store_true", default=None, help="bfloat16 compute (f32 master params)")
    parser.add_argument("--no_bf16", action="store_false", dest="bf16",
                        help="override a config-enabled training.bf16")
    parser.add_argument("--remat", nargs="?", const="all", default=None, choices=["all", "l12", "deep"],
                        help="recompute blocks in the backward pass for larger batches: 'all' (every block), "
                             "'l12' (the four blocks with the largest activations) or 'deep' (the five deepest); "
                             "the transformer families treat any mode as 'all'")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--grad_accum", type=int, default=None,
                        help="split each batch into N sequential microbatches and apply one averaged update; "
                             "batch-coupled losses are computed per microbatch and averaged, and BatchNorm "
                             "statistics thread through the microbatches")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises when CUDA is absent) or cpu")
    return parser.parse_args(argv)


def build_trainer(config, args):
    """The Trainer of ``config`` and the parsed flags (raises without CUDA
    unless ``args.device`` is the CPU)."""
    from dfc_sa_unet_torch.data.loader import DataLoaderFactory
    from dfc_sa_unet_torch.models.factory import create_model
    from dfc_sa_unet_torch.train.trainer import Trainer
    from dfc_sa_unet_torch.utils.weights import load_state_dict_file

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else None
    model = create_model(config, dtype=dtype, device=device, remat=args.remat or False)
    pretrained = config["model"].get("pretrained_path")
    if pretrained:
        print(f"Warm-starting from pretrained weights: {pretrained}")
        model.load_state_dict(load_state_dict_file(pretrained), strict=True)
    factory = DataLoaderFactory(config, seed=args.seed)
    return Trainer(model, factory.get_train_loader(), factory.get_val_loader(), config, seed=args.seed,
                   compute_dtype=dtype, device=device)


def main(argv=None):
    args = parse_args(argv)
    config = load_config(args.config)
    if args.grad_accum:
        config["training"]["grad_accum"] = args.grad_accum
    apply_overrides(config, args.loss, args.alpha, args.beta, args.weight_bce, args.weight_dice,
                    args.bce_weight, args.dice_weight, args.contour_weight, args.augmentation)
    merge_bf16_flag(args, config)
    trainer = build_trainer(config, args)
    print(f"Device: {trainer.device}")
    trainer.train(resume_from=args.resume)
    return trainer


if __name__ == "__main__":
    main()
