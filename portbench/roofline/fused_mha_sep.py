"""Roofline of the multi-head attention kernel (``csrc/mha.cu``) as TransUNet calls it
(``fused_mha_sep``: separate q, k, v [B, N, E]), once a transformer layer.

Work of a launch, as chip_smoke.py's phase 7 counts it: q, k, v and the output read or written once
in bf16 (2 x 4 x B x N x E bytes); operations 4 x B x heads x N^2 x head size (q k^T and p v);
exponentials B x heads x N^2.  N is the 14 x 14 patch grid of a 224 x 224 image.
"""

KERNELS = ("mha_wgmma_kernel", "mha_mma_kernel", "mha_simt_kernel")


def work(b, n, e, heads):
    """(bytes, operations, exponentials) of one bf16 launch."""
    return 2 * 4 * b * n * e, 4 * b * heads * n * n * (e // heads), b * heads * n * n


def launches(config, workload):
    """(b, n, e, heads) of each launch of one request: one a transformer layer."""
    m, t = config["model"], workload["traffic"]
    n = (t["height"] // 16) * (t["width"] // 16)
    return [(t["batch"], n, m["hidden_size"], m["num_heads"])] * m["num_layers"]
