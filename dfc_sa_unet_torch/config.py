"""YAML config loading and the CLI-over-YAML merge (counterpart of
dfc_sa_unet_tpu/config.py).

``yaml`` is imported when a file is read, so the package imports without
it; code that runs without PyYAML builds its config dict directly.
"""

from typing import Any, Dict, Optional

REQUIRED_SECTIONS = ("training", "model", "dataset", "logging")


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path.replace("\\", "/"), "r", encoding="utf-8") as f:
        config = yaml.safe_load(f)
    missing = [s for s in REQUIRED_SECTIONS if s not in config]
    if missing:
        raise ValueError(f"config {path} missing sections: {missing}")
    if "name" not in config["model"]:
        raise ValueError("config['model'] must include 'name'")
    config["training"].setdefault("loss", {"type": "dice", "params": {}})
    config["training"]["loss"].setdefault("params", {})
    return config


def merge_bf16_flag(args, config: Dict[str, Any], section: str = "training"):
    """``args.bf16`` from the YAML's ``<section>.bf16`` (``training`` for the
    training CLI, ``inference`` for the inference CLI) where the flag was not
    given (None); ``--bf16`` / ``--no_bf16`` win both ways.  The part of the
    JAX package's ``merge_parallel_flags`` that a one-card run has."""
    if args.bf16 is None:
        args.bf16 = bool((config.get(section) or {}).get("bf16", False))
    return args


def apply_overrides(
    config: Dict[str, Any],
    loss: Optional[str] = None,
    alpha: Optional[float] = None,
    beta: Optional[float] = None,
    weight_bce: Optional[float] = None,
    weight_dice: Optional[float] = None,
    bce_weight: Optional[float] = None,
    dice_weight: Optional[float] = None,
    contour_weight: Optional[float] = None,
    augmentation: Optional[bool] = None,
) -> Dict[str, Any]:
    """CLI-over-YAML precedence (reference train.py:119-134)."""
    lp = config["training"]["loss"]["params"]
    if loss is not None:
        config["training"]["loss"]["type"] = loss
    for key, val in (
        ("alpha", alpha), ("beta", beta),
        ("weight_bce", weight_bce), ("weight_dice", weight_dice),
        ("bce_weight", bce_weight), ("dice_weight", dice_weight),
        ("contour_weight", contour_weight),
    ):
        if val is not None:
            lp[key] = val
    if augmentation is not None:
        config["dataset"]["augmentation"] = augmentation
    return config
