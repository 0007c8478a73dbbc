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


def merge_parallel_flags(args, config: Dict[str, Any], sections=("training",)):
    """``data_parallel`` / ``spatial_parallel`` / ``multihost`` / ``bf16`` from the YAML where the
    flags were not given (copied from dfc_sa_unet_tpu/config.py:29-59).  ``sections`` is searched
    in order (the training CLI reads ``training:``, the inference CLI ``inference:``).  The parsers
    leave these flags None when not given, so ``--data_parallel`` / ``--no_data_parallel`` (and an
    explicit ``--spatial_parallel 1``) win over the config both ways, and the config fills only
    unset flags.  Mutates and returns ``args``."""
    def get(key, default):
        for s in sections:
            v = (config.get(s) or {}).get(key)
            if v is not None:
                return v
        return default

    def tri(flag_val, key):
        # None = flag not given -> config fills; True/False = CLI wins
        return bool(get(key, False)) if flag_val is None else bool(flag_val)

    args.data_parallel = tri(getattr(args, "data_parallel", None), "data_parallel")
    if getattr(args, "spatial_parallel", None) is None:
        args.spatial_parallel = int(get("spatial_parallel", 1) or 1)
    args.multihost = tri(getattr(args, "multihost", None), "multihost")
    if hasattr(args, "bf16"):
        args.bf16 = tri(args.bf16, "bf16")
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
