"""The port's SGD (clip, weight decay, momentum) against the JAX package's optax chain.

Three steps on a dict of random tensors, once with gradients under the
clip norm and once over it.  Tolerance 1e-6 of max|parameter|: the same f32
arithmetic, with the global norm summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfc_sa_unet_tpu.train import optim as joptim
from dfc_sa_unet_torch.train import optim

SHAPES = {"a.weight": (4, 3, 3, 3), "a.bias": (4,), "b.weight": (5, 4), "gamma": (1,)}
CONFIG = {"training": {"learning_rate": 0.05, "momentum": 0.9, "weight_decay": 1e-3}}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["under_clip", "over_clip"])
def test_three_steps_match_optax(grad_scale):
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (grad_scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    norms = [np.sqrt(sum(float((g ** 2).sum()) for g in step.values())) for step in grads]
    assert all(n < 1.0 for n in norms) if grad_scale < 1 else all(n > 1.0 for n in norms)

    tx = joptim.from_config(CONFIG)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = optim.from_config(CONFIG, params.items())
    for step in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in step.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(step[k].copy())
        opt.step()
        for k in SHAPES:
            want = np.asarray(jparams[k])
            np.testing.assert_allclose(params[k].detach().numpy(), want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))
    # the momentum buffers are optax's trace, by name
    trace = [s for s in state if hasattr(s, "trace")][0].trace
    for k in SHAPES:
        np.testing.assert_allclose(opt.momentum_buffers[k].numpy(), np.asarray(trace[k]), rtol=0, atol=1e-6)


def test_state_dict_round_trip_and_missing_grads():
    params = {"w": torch.nn.Parameter(torch.ones(3)), "frozen": torch.nn.Parameter(torch.ones(2))}
    opt = optim.SGDWithClip(params.items(), 0.1)
    params["w"].grad = torch.full((3,), 0.1)
    opt.step()  # "frozen" has no gradient: left alone
    assert torch.equal(params["frozen"].detach(), torch.ones(2)) and set(opt.momentum_buffers) == {"w"}
    other = optim.SGDWithClip(params.items(), 0.1)
    other.load_state_dict(opt.state_dict())
    assert torch.equal(other.momentum_buffers["w"], opt.momentum_buffers["w"])
    assert other.momentum_buffers["w"] is not opt.momentum_buffers["w"]
