"""Tensor ops of the port: plain PyTorch functions and the kernel wrappers.

Plain ops take NCHW tensors (the model's layout, stored channels_last);
the kernel wrappers (``pooled_attention``, ``dfc_tail``, ``conv_bn_stats``, the convs of
``mxu_probes``, ``conv_s8``) take NHWC, the
JAX layout, which is a contiguous ``permute(0, 2, 3, 1)`` view of a
channels_last tensor; ``mha`` takes token tensors ``[B,N,E]``.
"""

from dfc_sa_unet_torch.ops.attention import full_res_self_attention, pooled_self_attention
from dfc_sa_unet_torch.ops.conv_bn_stats import LAUNCHES as _STATS_LAUNCHES
from dfc_sa_unet_torch.ops.conv_s8 import LAUNCHES as _S8_LAUNCHES
from dfc_sa_unet_torch.ops.convt import conv_transpose_2x2
from dfc_sa_unet_torch.ops.dfc_tail import LAUNCHES as _TAIL_LAUNCHES
from dfc_sa_unet_torch.ops.mha import LAUNCHES as _MHA_LAUNCHES
from dfc_sa_unet_torch.ops.mxu_probes import LAUNCHES as _PROBE_LAUNCHES
from dfc_sa_unet_torch.ops.pooled_attention import FEWER_QUERIES as _ATTN_FEWER_QUERIES
from dfc_sa_unet_torch.ops.pooled_attention import LAUNCHES as _ATTN_LAUNCHES
from dfc_sa_unet_torch.ops.pooling import adaptive_avg_pool, max_pool
from dfc_sa_unet_torch.ops.resize import resize_bilinear

__all__ = ["adaptive_avg_pool", "conv_transpose_2x2", "full_res_self_attention", "launches", "max_pool",
           "pooled_self_attention", "reset_launches", "resize_bilinear"]

_COUNTS = (_ATTN_LAUNCHES, _TAIL_LAUNCHES, _MHA_LAUNCHES, _STATS_LAUNCHES, _PROBE_LAUNCHES, _S8_LAUNCHES)


def reset_launches():
    """Set every kernel's launch count to 0 (and the pooled attention's count of launches with fewer
    queries than keys, a part of its own)."""
    for counts in (*_COUNTS, _ATTN_FEWER_QUERIES):
        for key in counts:
            counts[key] = 0


def launches() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: n for counts in _COUNTS for name, n in counts.items()}
