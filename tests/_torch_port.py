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


def port_model(model_cfg, seed=0, use_pallas=False):
    """Port module on the CPU with seeded weights, in eval mode."""
    model = create_model({"model": model_cfg}, use_pallas=use_pallas, device="cpu")
    return init_random_(model, torch.Generator().manual_seed(seed)).eval()


def jax_model_and_variables(model_cfg, model, image_hw=(32, 32), use_pallas=False, dtype=None):
    """The JAX module of ``model_cfg`` and the port model's weights as Flax variables."""
    jmodel = jax_create_model({"model": model_cfg}, use_pallas=use_pallas, dtype=dtype)
    x = jnp.zeros((1, *image_hw, model_cfg.get("in_channels", 3)), jnp.float32)
    template = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), x, train=False))
    variables = torch_state_dict_to_variables(model.state_dict(), template)
    return jmodel, jax.tree.map(jnp.asarray, variables)


def images(seed, shape):
    """Normalised-scale f32 NHWC images."""
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def to_nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()
