"""Shared helpers of the tests that hold dfc_sa_unet_torch against dfc_sa_unet_tpu.

Weights are made once, by the port from a seeded torch.Generator (with
jittered BatchNorm statistics and a non-zero attention gamma, so BN
folding and the attention branch both count), and handed to JAX through
the JAX package's own converter, with a template from ``jax.eval_shape``
so no JAX init runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dfc_sa_unet_tpu.models.factory import create_model as jax_create_model
from dfc_sa_unet_tpu.utils.torch_convert import torch_state_dict_to_variables
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.utils.weights import init_random_

SMALL = {"name": "DFC-SA-Res-Block", "features": [8, 16, 24, 32], "pool_size": 4}
# the configurations of tests/goldens/vit_seg_small.npz and transunet_small.npz
# (tests/test_goldens.py:36-55); the TransUNet one is built as a module, not by the factory
VIT_SMALL = {"name": "VisionTransformerSegmentation", "img_dim": 32, "patch_dim": 8, "in_channels": 3,
             "out_channels": 1, "embed_dim": 32, "num_layers": 1, "num_heads": 2, "mlp_dim": 64,
             "dropout": 0.0}
TRANSUNET_SMALL = {"patches_grid": (4, 4), "resnet_num_layers": (1, 1, 1), "resnet_width_factor": 1,
                   "hidden_size": 64, "mlp_dim": 128, "num_heads": 2, "num_layers": 1,
                   "attention_dropout_rate": 0.0, "dropout_rate": 0.0, "decoder_channels": (32, 16, 8, 8),
                   "skip_channels": [512, 256, 64, 16], "n_classes": 1, "n_skip": 3}
TRANSUNET_SMALL_IMG = 64


def port_model(model_cfg, seed=0, use_pallas=False):
    """Port module on the CPU with seeded weights, in eval mode."""
    model = create_model({"model": model_cfg}, use_pallas=use_pallas, device="cpu")
    return init_random_(model, torch.Generator().manual_seed(seed)).eval()


def jax_model_and_variables(model_cfg, model, image_hw=(32, 32), use_pallas=False, dtype=None):
    """The JAX module of ``model_cfg`` and the port model's weights as Flax variables."""
    jmodel = jax_create_model({"model": model_cfg}, use_pallas=use_pallas, dtype=dtype)
    return jmodel, variables_from_port(jmodel, model, image_hw, model_cfg.get("in_channels", 3))


def port_transunet(vit_config=TRANSUNET_SMALL, img_size=TRANSUNET_SMALL_IMG, seed=0):
    """Port TransUNet built as a module (the golden's way), seeded weights, eval mode."""
    from dfc_sa_unet_torch.models.transunet import TransUNet

    model = TransUNet(vit_config, img_size=img_size, num_classes=vit_config["n_classes"])
    return init_random_(model, torch.Generator().manual_seed(seed)).eval()


def jax_transunet(vit_config=TRANSUNET_SMALL, img_size=TRANSUNET_SMALL_IMG, use_pallas=False, dtype=None):
    from dfc_sa_unet_tpu.models.transunet import TransUNet as JaxTransUNet

    return JaxTransUNet(config=dict(vit_config), img_size=img_size, num_classes=vit_config["n_classes"],
                        use_pallas=use_pallas, dtype=dtype)


def variables_from_port(jmodel, model, image_hw, in_channels=3):
    """The port model's weights as Flax variables of ``jmodel``."""
    x = jnp.zeros((1, *image_hw, in_channels), jnp.float32)
    template = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), x, train=False))
    return jax.tree.map(jnp.asarray, torch_state_dict_to_variables(model.state_dict(), template))


def golden(name):
    """(Flax-style nested variables of numpy arrays, NCHW input, NCHW output) of a golden file."""
    import os

    g = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", f"{name}.npz"))
    variables = {}
    for key in g.files:
        if key.startswith("__"):
            continue
        coll, path = key.split("::", 1)
        node = variables.setdefault(coll, {})
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(g[key], np.float32)
    return variables, g["__input__"].astype(np.float32), g["__output__"]


def images(seed, shape):
    """Normalised-scale f32 NHWC images."""
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def to_nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()
