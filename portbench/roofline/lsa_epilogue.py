"""Roofline of the pooled attention's epilogue kernel (``csrc/lsa_epilogue.cu``): one launch resizes
a block's p x p attention output to the block's H x W, scales it by gamma and adds the attention
branch's input a, for a batch, in bf16.

Work of a launch, as chip_smoke.py's phase 7 counts it: a read and the output written once (bf16),
o read once (bf16), gamma (one f32); operations 10 an element (the four taps' products and sums,
the scale and the add).  The engine runs it at all nine blocks, pool 8.
"""

KERNELS = ("lsa_epilogue_kernel",)
LEVELS = ("down1", "down2", "down3", "down4", "bottleneck", "up_conv4", "up_conv3", "up_conv2", "up_conv1")


def work(b, h, w, c, p):
    """(bytes, operations, exponentials) of one bf16 launch on [b, h, w, c] with a p x p map."""
    n = b * h * w * c
    return 2 * n + 2 * n + 2 * b * p * p * c + 4, 10 * n, 0


def launches(config, workload):
    """(b, h, w, c, p) of each launch of one request."""
    m = config["model"]
    f, p = m["features"], m["pool_size"]
    t = workload["traffic"]
    b, h, w = t["batch"], t["height"], t["width"]
    shapes = {"down1": (0, f[0]), "down2": (1, f[1]), "down3": (2, f[2]), "down4": (3, f[3]),
              "bottleneck": (4, 2 * f[3]), "up_conv4": (3, f[3]), "up_conv3": (2, f[2]),
              "up_conv2": (1, f[1]), "up_conv1": (0, f[0])}
    return [(b, h >> lvl, w >> lvl, c, p) for lvl, c in (shapes[k] for k in LEVELS)]
