"""The Predictor's read-back (infer/predictor.py::_to_host): the probabilities as a host array.

On the CPU a tensor's own memory is returned, values unchanged.  Marked ``card`` (skipped without an
NVIDIA card): from the card the answer lands in page-locked memory, equals a plain ``.cpu()`` copy
bit for bit (contiguous or a channel of an NCHW output), and a dropped answer's block is taken again
by the next one, so a request maps no fresh pages.  On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_predictor_read_back.py -m card
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dfc_sa_unet_torch.infer.predictor import _to_host  # noqa: E402


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _probs(device, channel_of_nchw):
    g = torch.Generator(device=device).manual_seed(3)
    if channel_of_nchw:  # as the Predictor slices it: channel 0 of a channels-last [B,1,H,W] output
        out = torch.rand(4, 1, 96, 64, generator=g, device=device).to(memory_format=torch.channels_last)
        return out[:, 0]
    return torch.rand(4, 96, 64, generator=g, device=device)


@pytest.mark.parametrize("channel_of_nchw", [False, True], ids=["contiguous", "channel"])
def test_a_host_tensor_is_returned_as_it_is(channel_of_nchw):
    probs = _probs(torch.device("cpu"), channel_of_nchw)
    got = _to_host(probs)
    assert isinstance(got, np.ndarray) and got.shape == (4, 96, 64)
    assert np.shares_memory(got, probs.numpy())
    np.testing.assert_array_equal(got, probs.numpy())


@pytest.mark.card
@pytest.mark.parametrize("channel_of_nchw", [False, True], ids=["contiguous", "channel"])
def test_the_answer_lands_in_reused_page_locked_memory(card, channel_of_nchw):
    probs = _probs(card, channel_of_nchw)
    want = probs.cpu().numpy()
    got = _to_host(probs)
    np.testing.assert_array_equal(got, want)
    assert torch.from_numpy(got).is_pinned()
    first = got.ctypes.data
    del got
    again = _to_host(probs * 0.5)
    assert again.ctypes.data == first
    np.testing.assert_array_equal(again, (probs * 0.5).cpu().numpy())
    kept = _to_host(probs)  # ``again`` is still held: a block of its own
    assert kept.ctypes.data != again.ctypes.data
    np.testing.assert_array_equal(kept, want)
