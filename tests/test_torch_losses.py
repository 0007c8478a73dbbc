"""Losses and metrics of the port against the JAX package's.

The same numpy inputs go through both; the port takes NCHW ``[B,1,H,W]``,
JAX NHWC ``[B,H,W,1]`` (the same memory for one channel).  Tolerances: a
loss value 1e-6 relative (both are f32 sums of a few thousand terms in
different orders), its gradient w.r.t. the probabilities 1e-5 of the
largest reference entry; 3e-5 for the joint loss, whose contour BCE divides
by Laplacian responses near 0, which amplifies the rounding of the 9-tap
sums (taken in another order by the two convolutions; read 1.2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfc_sa_unet_tpu import losses as jl
from dfc_sa_unet_tpu import metrics as jm
from dfc_sa_unet_torch import losses as tl
from dfc_sa_unet_torch import metrics as tm

torch.set_num_threads(2)
B, H, W = 3, 12, 10
CASES = [
    ("dice", {}),
    ("tversky", {"alpha": 0.3, "beta": 0.7}),
    ("bce_dice", {"weight_bce": 0.5, "weight_dice": 0.5}),
    ("bce_dice", {"bce_weight": 0.25, "dice_weight": 2.0}),  # the configs' spelling
    ("bce_dice", {}),
    ("joint", {"bce_weight": 1.0, "dice_weight": 0.5, "contour_weight": 0.7}),
]


def _inputs(seed, endpoints=False):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.02, 0.98, (B, H, W, 1)).astype(np.float32)
    t = (rng.uniform(size=(B, H, W, 1)) > 0.5).astype(np.float32)
    if endpoints:  # fully confident pixels, right and wrong
        p[0, 0, 0, 0], p[0, 0, 1, 0], p[1, 2, 3, 0], p[1, 2, 4, 0] = 0.0, 1.0, 0.0, 1.0
        t[0, 0, 0, 0], t[0, 0, 1, 0], t[1, 2, 3, 0], t[1, 2, 4, 0] = 0.0, 0.0, 1.0, 1.0
    return p, t


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _both(loss_type, params, p, t, mask):
    jmask = None if mask is None else jnp.asarray(mask)
    jloss, jgrad = jax.value_and_grad(
        lambda q: jl.compute_loss(q, jnp.asarray(t), loss_type, params, sample_mask=jmask))(jnp.asarray(p))
    tp = _nchw(p).requires_grad_(True)
    tmask = None if mask is None else torch.from_numpy(mask)
    tloss = tl.compute_loss(tp, _nchw(t), loss_type, params, sample_mask=tmask)
    tloss.backward()
    return float(jloss), np.asarray(jgrad), float(tloss.detach()), tp.grad.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("masked", [False, True], ids=["all", "sample_mask"])
@pytest.mark.parametrize("endpoints", [False, True], ids=["interior", "endpoints"])
@pytest.mark.parametrize("loss_type,params", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_loss_and_gradient_match_jax(loss_type, params, endpoints, masked):
    p, t = _inputs(3, endpoints)
    mask = np.asarray([1.0, 0.0, 1.0], np.float32) if masked else None
    jloss, jgrad, tloss, tgrad = _both(loss_type, params, p, t, mask)
    assert np.isfinite(tloss) and np.isfinite(tgrad).all()
    assert tloss == pytest.approx(jloss, rel=1e-6)
    tol = 3e-5 if loss_type == "joint" else 1e-5
    np.testing.assert_allclose(tgrad, jgrad, rtol=0, atol=tol * max(np.abs(jgrad).max(), 1e-12))


def test_bce_endpoints_have_jax_gradient_not_the_clamped_one():
    """At p exactly 0 or 1 the value is torch's clamped one (-100 per wrong
    pixel) and the gradient is zero, where F.binary_cross_entropy returns 1e12."""
    t = torch.tensor([[[[0.0, 1.0, 0.0, 1.0]]]])
    p = torch.tensor([[[[0.0, 0.0, 1.0, 1.0]]]], requires_grad=True)
    loss = tl.bce_dice_loss(p, t, 0.5, 0.5)
    loss.backward()
    assert float(loss) == pytest.approx(0.5 * 50.0 + 0.5 * 0.4, rel=1e-6)
    jgrad = jax.grad(lambda q: jl.bce_dice_loss(q, jnp.asarray(t.numpy()), 0.5, 0.5))(jnp.asarray(p.detach().numpy()))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-7)
    q = p.detach().clone().requires_grad_(True)
    torch.nn.functional.binary_cross_entropy(q, t).backward()
    assert q.grad.abs().max() > 1e6  # what the port must not do
    p2 = torch.tensor([[[[0.3, 0.8]]]], requires_grad=True)
    tl.bce_dice_loss(p2, torch.tensor([[[[0.0, 1.0]]]]), 1.0, 0.0).backward()
    np.testing.assert_allclose(p2.grad.numpy().ravel(), np.asarray([1.0 / 0.7, -1.0 / 0.8]) / 2.0, rtol=1e-5)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="unsupported loss"):
        tl.compute_loss(torch.zeros(1, 1, 2, 2), torch.zeros(1, 1, 2, 2), "focal")


def test_metrics_match_jax():
    p, t = _inputs(5)
    tp, tt = _nchw(p), _nchw(t)
    jp, jt = jnp.asarray(p), jnp.asarray(t)
    for name in ("dice_coefficient", "iou_score"):
        assert float(getattr(tm, name)(tp, tt)) == pytest.approx(float(getattr(jm, name)(jp, jt)), rel=1e-6)
    for got, want in zip(tm.hard_dice_iou(tp, tt), jm.hard_dice_iou(jp, jt)):
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    for got, want in zip(tm.per_sample_hard_dice_iou(tp, tt), jm.per_sample_hard_dice_iou(jp, jt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    got = tm.calculate_metrics(tp, tt, "bce_dice", {"bce_weight": 0.5, "dice_weight": 0.5})
    want = jm.calculate_metrics(jp, jt, "bce_dice", {"bce_weight": 0.5, "dice_weight": 0.5})
    assert set(got) == set(want) == {"loss", "iou", "dice"}
    for k in got:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6)
