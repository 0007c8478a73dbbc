"""Training entry point: ``python -m dfc_sa_unet_torch.train`` (counterpart of
the JAX package's train.py, with its flags).

    python -m dfc_sa_unet_torch.train --config configs/config_dfc-sa-res-block.yaml \\
        [--resume CKPT] [--loss {dice,tversky,bce_dice,joint}] [--alpha A]
        [--beta B] [--weight_bce W] [--weight_dice W] [--bce_weight W]
        [--dice_weight W] [--contour_weight W] [--augmentation true|false]
        [--bf16 | --no_bf16] [--remat [all|l12|deep]] [--seed N]
        [--grad_accum N [--grad_accum_exact]] [--exe_cache DIR] [--device cuda|cpu]
        [--data_parallel] [--spatial_parallel S] [--multihost] [--coordinator HOST:PORT
        --num_processes N --process_id I]

    torchrun --nproc_per_node N -m dfc_sa_unet_torch.train --config CFG --data_parallel \\
        [--grad_accum 2 [--grad_accum_exact]]
    torchrun --nproc_per_node N -m dfc_sa_unet_torch.train --config CFG --spatial_parallel S

Trains any of the factory's twelve models (``--remat`` reaches the flagship
and the transformers only, as in the JAX package; ``UNet_FullResAttention``
needs a dataset ``img_size`` of at most 64x64).
Runs on the card; without CUDA it raises unless ``--device cpu`` is given.
``--bf16`` computes in bfloat16 with f32 parameters and an f32 loss.
``--data_parallel`` under torchrun trains one process per card, each on
``cuda:LOCAL_RANK`` (or ``--device``) over its chunk of every global batch,
NCCL between cards and Gloo on the CPU; the step equals one card's on the
whole batch.  ``--multihost`` or ``--coordinator`` forms the group from
explicit ``--num_processes`` / ``--process_id``.  Without torchrun
``--data_parallel`` trains on one card.  The YAML's ``training:`` section
may set ``data_parallel``, ``multihost`` and ``bf16``; flags win both ways.
``--grad_accum N`` splits each batch into N microbatches (under a group, each
process loads its share of every microbatch); ``--grad_accum_exact`` takes one
loss over all of them, which for the Dice and Tversky terms is the whole
batch's loss (the flagship's B=128 on one H100: ``--grad_accum 2
--grad_accum_exact``).  ``--exe_cache DIR`` builds and loads the CUDA kernels
in DIR (the nvcc libraries are the port's only compiled artifacts).
``--spatial_parallel S`` (or ``training.spatial_parallel``) under torchrun
shards the rows of every image over S processes (row sharding of the DFC
family, parallel/rows.py: large crops whose activations exceed one card's
memory): N / S data groups, each loading its chunk of every batch, each rank
training on a band of its rows; the step equals one card's on the whole
batch.  The crop's height must be a multiple of 16 S (else the batch shards on
the data axis only, with a warning); the transformer families,
UNet_FullResAttention and the vanilla UNet with ``bilinear: true`` raise under
it (ROADMAP.md, Queue A 4.2).  Not taken: ``--use_pallas`` / ``--no_pallas``:
on the card the attention kernels always run.
"""

import argparse

import torch

from dfc_sa_unet_torch.config import apply_overrides, load_config, merge_parallel_flags
from dfc_sa_unet_torch.parallel.mesh import ProcessMesh, add_parallel_flags, mesh_from_flags
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
    parser.add_argument("--grad_accum_exact", action="store_true",
                        help="with --grad_accum: one loss (and gradient) over the whole batch, the monolithic "
                             "batch's for the batch-coupled dice/tversky/joint sums, at one more forward per "
                             "microbatch (rematerialised). YAML: training.grad_accum_exact")
    parser.add_argument("--exe_cache", type=str, default=None,
                        help="directory the CUDA kernels are built in and loaded from (a warm directory skips "
                             "the nvcc build). YAML: training.exe_cache_dir")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default: cuda:LOCAL_RANK under torchrun; raises when CUDA is absent), "
                             "cuda:I or cpu")
    add_parallel_flags(parser, "train data-parallel, one process per card, each on its chunk of every batch")
    return parser.parse_args(argv)


def build_trainer(config, args, mesh=None):
    """The Trainer of ``config``, the parsed flags and ``mesh`` (parallel.mesh.ProcessMesh; None: one
    process on ``args.device``, raising without CUDA unless it is the CPU); with a group each process
    loads its data index's chunk of every batch (the ranks of a spatial group the same chunk)."""
    from dfc_sa_unet_torch.data.loader import DataLoaderFactory
    from dfc_sa_unet_torch.models.factory import create_model
    from dfc_sa_unet_torch.train.trainer import Trainer
    from dfc_sa_unet_torch.utils.weights import load_state_dict_file

    mesh = mesh or ProcessMesh(1, 0, 0, resolve_device(args.device))
    device = mesh.device
    dtype = torch.bfloat16 if args.bf16 else None
    torch.manual_seed(args.seed)  # the weights' initialisation follows --seed
    model = create_model(config, dtype=dtype, device=device, remat=args.remat or False)
    pretrained = config["model"].get("pretrained_path")
    if pretrained:
        print(f"Warm-starting from pretrained weights: {pretrained}")
        model.load_state_dict(load_state_dict_file(pretrained), strict=True)
    factory = DataLoaderFactory(config, seed=args.seed)
    if mesh.group is None:
        train_loader, val_loader = factory.get_train_loader(), factory.get_val_loader()
    else:
        shard = (mesh.data_index, mesh.data_size)
        train_loader = factory.get_train_loader(drop_last=True, shard=shard,
                                                microbatches=int(config["training"].get("grad_accum", 1)))
        val_loader = factory.get_val_loader(shard)
    return Trainer(model, train_loader, val_loader, config, mesh=mesh, seed=args.seed, compute_dtype=dtype,
                   device=device)


def main(argv=None):
    args = parse_args(argv)
    config = load_config(args.config)
    if args.grad_accum:
        config["training"]["grad_accum"] = args.grad_accum
    if args.grad_accum_exact:
        config["training"]["grad_accum_exact"] = True
    if args.exe_cache:
        config["training"]["exe_cache_dir"] = args.exe_cache
    apply_overrides(config, args.loss, args.alpha, args.beta, args.weight_bce, args.weight_dice,
                    args.bce_weight, args.dice_weight, args.contour_weight, args.augmentation)
    merge_parallel_flags(args, config, sections=("training",))
    mesh = mesh_from_flags(args)
    try:
        trainer = build_trainer(config, args, mesh)
        print(f"Device: {trainer.device}" + (f" (rank {mesh.rank} of {mesh.world_size}, {mesh.backend})"
                                             if mesh.group is not None else ""))
        trainer.train(resume_from=args.resume)
    finally:
        mesh.close()
    return trainer


if __name__ == "__main__":
    main()
