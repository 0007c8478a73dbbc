"""YAML config loading (counterpart of dfc_sa_unet_tpu/config.py:16).

``yaml`` is imported when a file is read, so the package imports without
it; code that runs without PyYAML builds its config dict directly.
"""

from typing import Any, Dict

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
