"""The benchmark's cells cut to a size the CPU runs in seconds, for the tests: the flagship at
features 8/16/24/32 on 32 x 32 images, TransUNet (whose widths the factory fixes) on 32 x 32, a
few tiles a request and a few images an epoch.  Everything else is the cell's own.

``dfc_train_b64`` is the training cell that ``BENCHMARK.json`` leaves out until the program's bf16
training step agrees with the reference (PERF.md, Open questions); its workload is kept here, so
that the tests hold the training driver and its checks.  Its limits are the tests' (the worst leaf
of a tiny model swings with rounding); the cell's own are set anew, from readings, when it returns."""

import copy

from portbench import core

TRAINING = {
    "dfc_train_b64": {
        "config": "dfc_sa_res_block", "driver": "train_epochs", "chips": 1,
        "program": {"dtype": "bfloat16"},
        "traffic": {"batch": 64, "images": 612, "height": 288, "width": 384, "warmup_epochs": 1},
        "limits": {"loss_gap": 0.0014, "bn_gap": 0.008, "change_gap_median": 0.1},
    },
}
_TINY_CONFIG = {
    "dfc_sa_res_block": {"model": {"features": [8, 16, 24, 32]}, "dataset": {"img_size": [32, 32]}},
    "transunet_r50_vit_b16": {"dataset": {"img_size": [32, 32]}},
}
_TINY_TRAFFIC = {
    "serve_closed": {"batch": 4, "height": 32, "width": 32, "pool_requests": 2, "warmup_requests": 1,
                     "traced_requests": 2, "sampled_requests": 2, "reference_block": 2},
    "train_epochs": {"batch": 4, "images": 10, "height": 36, "width": 48, "warmup_epochs": 1},
}


def tiny_cell(name: str) -> core.Cell:
    full = core.Cell(name, workload=copy.deepcopy(TRAINING.get(name)))
    workload, config = copy.deepcopy(full.workload), copy.deepcopy(full.config)
    for section, values in _TINY_CONFIG[workload["config"]].items():
        config[section].update(values)
    workload["traffic"].update(_TINY_TRAFFIC[workload["driver"]])
    return core.Cell(name, workload=workload, config=config)
