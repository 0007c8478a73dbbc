"""Roofline of the DFC tail kernel (``csrc/dfc_tail.cu``): one launch computes a block's 3x3 conv,
gate, fusion and residual for a batch, in bf16.

Work of a launch, as chip_smoke.py's phase 7 and scripts/bench_torch_dfc_tail.py count it: x, a and
the output read or written once (bf16), the weights once (bf16), three f32 biases; operations
2 x pixels x C x (9 Cin + 5 C + Cin) (the 3x3 conv, the gate's 2C -> C, the fusion's 3C -> C, the
residual's Cin -> C).  The engine runs it at the seven "auto" levels: down2-down4 and the four
decoder blocks (down1, Cin 3, and the bottleneck, C 1024, run conv3x3 alone).
"""

KERNELS = ("dfc_tail_wgmma_kernel", "dfc_tail_wgmma_halo_kernel", "dfc_tail_kernel", "dfc_tail_halo_kernel")
LEVELS = ("down2", "down3", "down4", "up_conv4", "up_conv3", "up_conv2", "up_conv1")


def work(b, h, w, cin, c):
    """(bytes, operations, exponentials) of one bf16 launch on [b, h, w] pixels, Cin -> C."""
    npix = b * h * w
    nbytes = 2 * npix * (cin + 2 * c) + 2 * (9 * cin * c + 5 * c * c + cin * c) + 4 * 3 * c
    return nbytes, 2 * npix * c * (9 * cin + 5 * c + cin), 0


def launches(config, workload):
    """(b, h, w, cin, c) of each launch of one request."""
    f = config["model"]["features"]
    t = workload["traffic"]
    b, h, w = t["batch"], t["height"], t["width"]
    shapes = {"down2": (1, f[0], f[1]), "down3": (2, f[1], f[2]), "down4": (3, f[2], f[3]),
              "up_conv4": (3, 2 * f[3], f[3]), "up_conv3": (2, 2 * f[2], f[2]),
              "up_conv2": (1, 2 * f[1], f[1]), "up_conv1": (0, 2 * f[0], f[0])}
    return [(b, h >> lvl, w >> lvl, cin, c) for lvl, cin, c in (shapes[k] for k in LEVELS)]
