"""The port's Predictor against the JAX Predictor with the same weights.

Small widths (8/16/24/32, pool 4), 48-pixel tiles.  Probabilities in f32:
atol 1e-5 (sigmoid of logits that agree to ~1e-5).
"""

import numpy as np
import pytest
import torch

from _torch_port import SMALL, jax_model_and_variables, port_model
from dfc_sa_unet_tpu.infer.predictor import Predictor as JaxPredictor
from dfc_sa_unet_torch.infer.engine import DFCEngine
from dfc_sa_unet_torch.infer.predictor import Predictor

torch.set_num_threads(2)
TILE, OVERLAP, BATCH = 48, 12, 8


def _image(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def predictors():
    model = port_model(SMALL, seed=7)
    jmodel, variables = jax_model_and_variables(SMALL, model, (TILE, TILE))
    return Predictor(model, device="cpu"), JaxPredictor(jmodel, variables)


@pytest.mark.parametrize("tta", [False, True])
def test_predict_sliding_matches_jax(predictors, tta):
    port, jax_pred = predictors
    img = _image(0, 100, 90)
    got = port.predict_sliding(img, TILE, OVERLAP, BATCH, tta=tta)
    want = jax_pred.predict_sliding(img, TILE, OVERLAP, BATCH, tta=tta)
    assert got.shape == (100, 90)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_stream_equals_per_image_sliding(predictors):
    port, jax_pred = predictors
    imgs = [_image(1, 100, 90), _image(2, 40, 60), _image(3, 64, 130)]  # one smaller than a tile
    stream = list(port.predict_sliding_stream(enumerate(imgs), TILE, OVERLAP, BATCH, tta=True))
    assert [k for k, _ in stream] == [0, 1, 2]
    for (_, got), img in zip(stream, imgs):
        np.testing.assert_allclose(got, port.predict_sliding(img, TILE, OVERLAP, BATCH, tta=True), atol=1e-6)
    jstream = dict(jax_pred.predict_sliding_stream(enumerate(imgs), TILE, OVERLAP, BATCH, tta=True))
    for key, got in stream:
        np.testing.assert_allclose(got, jstream[key], atol=1e-5)


def test_predict_probs_batch_policy(predictors):
    """Batches of every size run as they are (above 128 and 64-127 too); results are per-image."""
    port, _ = predictors
    batch = np.stack([_image(10 + i, 16, 16) for i in range(130)])
    probs = port.predict_probs(batch)
    assert probs.shape == (130, 16, 16) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs[70], port.predict_single(batch[70]), atol=1e-6)
    np.testing.assert_allclose(port.predict_probs(batch[:70])[3], probs[3], atol=1e-6)


@pytest.mark.parametrize("n", [70, 150])
def test_predict_probs_equals_each_images_own_forward(predictors, n):
    """Whatever the batch policy (a pad to 128, chunks of 128, or the batch as it is), every image's
    probabilities are those of its own forward: f32, within 1e-6."""
    port, _ = predictors
    batch = np.stack([_image(300 + i, 16, 16) for i in range(n)])
    probs = port.predict_probs(batch)
    assert probs.shape == (n, 16, 16)
    own = np.stack([port._forward_u8(batch[i:i + 1])[0] for i in range(n)])
    np.testing.assert_allclose(probs, own, rtol=0, atol=1e-6)


def test_engine_predictor_matches_module_predictor(predictors):
    port, _ = predictors
    engine = DFCEngine({"model": SMALL}, port.model, dtype=torch.float32, device="cpu",
                       tail_kernel_levels="auto", conv_kernel_levels="auto")
    img = _image(4, 100, 90)
    np.testing.assert_allclose(
        Predictor(engine, device="cpu").predict_sliding(img, TILE, OVERLAP, BATCH, tta=True),
        port.predict_sliding(img, TILE, OVERLAP, BATCH, tta=True), atol=1e-4)
