"""Roofline of the pooled-attention kernel (``csrc/pooled_attention.cu``) as SAM's image encoder calls it:
one launch a block with the decomposed relative-position tables, 12 a request (models/sam.py).  A global
block attends over the whole 64 x 64 map of each image (B' = the batch, nq = nk = 4096, tables of 64 and 64);
a windowed one over each 14 x 14 window of the map zero-padded to 70 x 70 (B' = 25 windows x the batch,
nq = nk = 196, tables of 14 and 14); 12 heads of 64.

Work of a launch, the published work whatever implements it: q, k, v and the output read or written once
in bf16 and the two tables read once (2 B' heads (nq Cq + nk Cq + nk C + nq C) + 2 B' heads nq (kh + kw)
bytes); operations 2 B' heads nq nk (Cq + C) (q k^T and p v; the bias adds are not counted); exponentials
B' heads nq nk.  A tile padded past 196 rows or keys is not counted.
"""

KERNELS = ("pooled_attention_relpos_kernel",)


def work(b, nq, nk, cq, c, heads, kh, kw):
    """(bytes, operations, exponentials) of one bf16 launch with tables."""
    nbytes = 2 * b * heads * (nq * cq + nk * cq + nk * c + nq * c) + 2 * b * heads * nq * (kh + kw)
    return nbytes, 2 * b * heads * nq * nk * (cq + c), b * heads * nq * nk


def launches(config, workload):
    """(B', nq, nk, cq, c, heads, kh, kw) of each launch of one request, in block order."""
    m, t = config["model"], workload["traffic"]
    grid = m["img_size"] // m["patch_size"]
    hd = m["embed_dim"] // m["num_heads"]
    ws = m["window_size"]
    windows = (-(-grid // ws)) ** 2
    out = []
    for i in range(m["depth"]):
        if i in m["global_attn_indexes"]:
            out.append((t["batch"], grid * grid, grid * grid, hd, hd, m["num_heads"], grid, grid))
        else:
            out.append((t["batch"] * windows, ws * ws, ws * ws, hd, hd, m["num_heads"], ws, ws))
    return out
