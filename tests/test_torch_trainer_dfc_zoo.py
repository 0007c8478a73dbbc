"""One training step of ``UNet_AttentionOnly`` (small widths) and of the vanilla
``UNet`` (its fixed widths 64..1024, at 32x32) through the port's Trainer against
the JAX Trainer: the slice as a whole for the DFC zoo.  The JAX side runs with
``use_pallas=True``, so the attention-only model's nine attention cores go
through the Pallas kernel in interpret mode and its custom VJP.  Tolerances in
``_torch_port.assert_step_matches``: loss 1e-5, updates 1e-3 of the largest,
BatchNorm statistics 1e-5.

The UNet steps at learning rate 0.5: its 31 M parameters share a gradient
clipped to norm 1, so at the YAML's 0.01 the largest update of a BatchNorm
scale near 1.0 is 1.5e-6, a dozen f32 ulps of the parameter, and the
comparison would be of roundings of the parameter, not of gradients.
Its batch seed is one where no ReLU input lies within an f32 rounding of zero:
the full-width UNet has about a million ReLU inputs at this size, the two
frameworks sum their convs in different orders, and where one such input
lands on either side of zero (batch seeds 2, 4 and 6 among the first six) that
pixel's gradient is kept by one framework and dropped by the other, which
moves its channel's updates in ``inc`` and ``down1`` by 0.3 to 5%.  The
gradients themselves agree: with that batch both f32 frameworks are equally
far from an f64 run of the port.  The small attention-only model is far less
touchy: of batch seeds 1 to 6 five stay under 0.36 of the update limit over
two steps and one (5) reads 1.17 of it at down4's BatchNorm scale.
"""

import pytest
import torch

from _torch_port import (assert_step_matches, jax_model_and_variables, port_model, run_both_trainers, train_config,
                         uint8_batches)

torch.set_num_threads(2)
ATTENTION_ONLY = {"name": "UNet_AttentionOnly", "features": [8, 16, 24, 32], "pool_size": 4}


@pytest.mark.parametrize("model_cfg,batches,lr", [(ATTENTION_ONLY, uint8_batches(1, 2, 4, (32, 32)), 0.01),
                                                  ({"name": "UNet"}, uint8_batches(1, 1, 2, (32, 32)), 0.5)],
                         ids=["UNet_AttentionOnly", "UNet"])
def test_step_matches_the_jax_trainer(tmp_path, model_cfg, batches, lr):
    cfg = train_config(tmp_path, model_cfg, learning_rate=lr)
    model = port_model(model_cfg, seed=8)
    jmodel, _ = jax_model_and_variables(model_cfg, model, use_pallas=True)
    steps, init = run_both_trainers(cfg, model, jmodel, (32, 32), batches)
    for step in steps:
        assert_step_matches(*step, init)
