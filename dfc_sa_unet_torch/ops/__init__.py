"""Tensor ops of the port: plain PyTorch functions and the kernel wrappers.

Plain ops take NCHW tensors (the model's layout, stored channels_last);
the kernel wrappers (``pooled_attention``, ``dfc_tail``, ``conv_bn_stats``, the convs of
``mxu_probes``, ``conv_s8``, ``lsa_epilogue``) take NHWC, the
JAX layout, which is a contiguous ``permute(0, 2, 3, 1)`` view of a
channels_last tensor; ``mha`` takes token tensors ``[B,N,E]``; ``bias_add`` a product in the
layer's layout and its bias as torch broadcasts it.  Every wrapper calls its kernel through
``ops/_build.py``, which counts the launches that ``launches()`` shows.
"""

from dfc_sa_unet_torch.ops._build import launches, reset_launches
from dfc_sa_unet_torch.ops.attention import full_res_self_attention, pooled_self_attention
from dfc_sa_unet_torch.ops.convt import conv_transpose_2x2
from dfc_sa_unet_torch.ops.pooling import adaptive_avg_pool, max_pool
from dfc_sa_unet_torch.ops.resize import resize_bilinear

__all__ = ["adaptive_avg_pool", "conv_transpose_2x2", "full_res_self_attention", "launches", "max_pool",
           "pooled_self_attention", "reset_launches", "resize_bilinear"]
