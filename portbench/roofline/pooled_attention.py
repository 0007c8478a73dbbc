"""Roofline of the pooled-attention kernel (``csrc/pooled_attention.cu``) as SegFormer calls it: one
launch a block, every pixel's query of the stage against the keys and values of the map its
spatial-reduction conv cut down (``nq`` = h w, ``nk`` = (h / R) (w / R)), ``heads`` heads of 64.

Work of a launch, as the kernel table of PERF.md counts its row 1: q, k, v and the output read or
written once in bf16 (2 x B x heads x (nq Cq + nk Cq + nk C + nq C) bytes); operations 2 x B x heads x
nq x nk x (Cq + C) (q k^T and p v); exponentials B x heads x nq x nk.
"""

KERNELS = ("pooled_attention_wgmma_kernel", "pooled_attention_kernel", "pooled_attention_long_kernel")


def work(b, nq, nk, cq, c, heads):
    """(bytes, operations, exponentials) of one bf16 launch."""
    nbytes = 2 * b * heads * (nq * cq + nk * cq + nk * c + nq * c)
    return nbytes, 2 * b * heads * nq * nk * (cq + c), b * heads * nq * nk


def launches(config, workload):
    """(b, nq, nk, cq, c, heads) of each launch of one request: one a block, stage by stage (a stage at
    1/4, 1/8, 1/16 and 1/32 of the tile)."""
    m, t = config["model"], workload["traffic"]
    out = []
    for i, (dim, depth, heads, sr) in enumerate(zip(m["embed_dims"], m["depths"], m["num_heads"], m["sr_ratios"])):
        h, w = t["height"] >> (2 + i), t["width"] >> (2 + i)
        out += [(t["batch"], h * w, (h // sr) * (w // sr), dim // heads, dim // heads, heads)] * depth
    return out
