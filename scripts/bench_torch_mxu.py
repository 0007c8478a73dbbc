#!/usr/bin/env python3
"""Matrix-unit probes on one GPU: how close does a hand-written product get to
the library's, and which tap schedule should a conv mainloop use?

    python3 scripts/bench_torch_mxu.py [--root DIR] [--batch 128] [--iters 10] [--seed 0]

Counterpart of scripts/bench_mxu.py for the PyTorch port.  At the flagship's
down3 shape (B=128, 56x56, Cin=128, Cout=256), bf16, seeded inputs, it times

  torch.matmul     [M, 3*Cin] @ [3*Cin, Cout], M = B*56*56: cuBLAS, the clean
                   matrix-unit reference (the JAX script's xla_matmul)
  probe_matmul     the same product through the hand-written kernel, a
                   persistent wgmma GEMM whose operands come by TMA
  F.conv2d         cuDNN's 3x3 conv (xla_conv)
  probe_conv_cat   the hand-written conv with the weight [3][3*Cin][Cout]
  probe_conv_9dot  the same with the weight [9][Cin][Cout]; both conv probes
                   run on the pipelined wgmma mainloop of
                   csrc/conv3x3_wgmma.cuh, one stream of (tap, 64-channel)
                   steps whose copies overlap the products

with CUDA events after a warm-up, prints ms and TF/s for each, each kernel's
largest absolute error against its plain version (at most 2e-2 of the largest
|reference|, as the port's other bf16 kernels) and the least time the card
could take: the larger of bytes / 3.35 TB/s (inputs and output once) and
operations / 989 TFLOP/s.  ``--root DIR`` times the ``dfc_sa_unet_torch`` of
another checkout (the parent commit, unpacked in a git-ignored directory), so
that two versions of the kernels are timed by the same script on the same
card.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dfc_sa_unet_torch.ops import launches, reset_launches  # noqa: E402
from dfc_sa_unet_torch.ops import mxu_probes as ops  # noqa: E402

H, W, CIN, COUT = 56, 56, 128, 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_BF16_OPS = 989e12
TOL = 2e-2
CHECK_BATCH = 8  # the plain convs hold f32 copies of the taps: checked on the first images


def inputs(batch, generator, h=H, w=W, cin=CIN, cout=COUT, dtype=torch.bfloat16):
    """x2 [M, 3*Cin], w2 [3*Cin, Cout], x [B,H,W,Cin], w4 [3,3,Cin,Cout] as the JAX
    script draws them (bench_mxu.py:154-163): standard normal, the conv weight times 0.05."""
    dev = generator.device

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=generator, device=dev) * scale).to(dtype)

    m = batch * h * w
    return randn(m, 3 * cin), randn(3 * cin, cout), randn(batch, h, w, cin), randn(3, 3, cin, cout, scale=0.05)


def bounds(batch, h=H, w=W, cin=CIN, cout=COUT, itemsize=2):
    """{row: (bytes, operations)} that the matmul and the conv need at this shape."""
    m = batch * h * w
    return {"matmul": (itemsize * (m * 3 * cin + 3 * cin * cout + m * cout), 2 * m * 3 * cin * cout),
            "conv": (itemsize * (m * cin + 9 * cin * cout + m * cout), 2 * m * 9 * cin * cout)}


def bound_ms(nbytes, nops):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / PEAK_BF16_OPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def timed(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want):
    """(largest |got - want|, the same over max(1, largest |want|))."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


class Probe:
    """The seeded operands of one probe run and the five functions it times."""

    def __init__(self, batch, generator):
        self.batch = batch
        self.x2, self.w2, self.x, w4 = inputs(batch, generator)
        self.w3, self.w9 = w4.reshape(3, 3 * CIN, COUT), w4.reshape(9, CIN, COUT)  # one weight, two layouts
        x_nchw = self.x.permute(0, 3, 1, 2)  # a channels_last view
        w_oihw = w4.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        # name -> (which bound, the timed call, its plain version on the first n rows or images)
        self.rows = {
            "torch.matmul": ("matmul", lambda: torch.matmul(self.x2, self.w2), None),
            "probe_matmul": ("matmul", lambda: ops.probe_matmul(self.x2, self.w2),
                             lambda n: ops.probe_matmul_plain(self.x2[:n * H * W], self.w2)),
            "F.conv2d": ("conv", lambda: F.conv2d(x_nchw, w_oihw, padding=1), None),
            "probe_conv_cat": ("conv", lambda: ops.probe_conv_cat(self.x, self.w3),
                               lambda n: ops.probe_conv_cat_plain(self.x[:n], self.w3)),
            "probe_conv_9dot": ("conv", lambda: ops.probe_conv_9dot(self.x, self.w9),
                                lambda n: ops.probe_conv_9dot_plain(self.x[:n], self.w9)),
        }

    def check(self):
        """One launch of each kernel against its plain version on the first images:
        {name: (max abs err, the same over max(1, largest |plain|))}.  Raises above TOL."""
        nb = min(self.batch, CHECK_BATCH)
        errs = {}
        for name, (_, fn, plain) in self.rows.items():
            if plain is None:
                continue
            got, want = fn(), plain(nb)
            got = got[:nb * H * W] if got.dim() == 2 else got[:nb]
            errs[name] = rel_err(got, want)
            if got.shape != want.shape or not errs[name][1] <= TOL:
                raise RuntimeError(f"{name}: kernel and plain version disagree: max abs err {errs[name][0]:.3e}, "
                                   f"{errs[name][1]:.3e} of the largest |reference| (limit {TOL})")
        return errs

    def time(self, iters, errs, card=""):
        """The five rows, printed as they are measured:
        [{name, ms, tflops, max_abs_err, bound_ms, bound_by}]."""
        need = bounds(self.batch)
        out = []
        for name, (kind, fn, _) in self.rows.items():
            ms = timed(fn, iters)
            nbytes, nops = need[kind]
            bound, by = bound_ms(nbytes, nops)
            err, rel = errs.get(name, (None, None))
            out.append({"name": name, "ms": ms, "tflops": nops / ms / 1e9, "max_abs_err": err,
                        "bound_ms": bound, "bound_by": by})
            checked = "" if err is None else f"  max abs err {err:.3e} ({rel:.1e} of max|plain|)"
            print(f"{name:16s} {ms:8.3f} ms  {nops / ms / 1e9:7.1f} TF/s  bound {bound:6.3f} ms ({by}){checked}  "
                  f"({card})", flush=True)
        return out


def _use_root(root):
    """Time the kernels of the dfc_sa_unet_torch at ``root`` instead of this checkout's."""
    global launches, ops, reset_launches
    for name in [m for m in sys.modules if m.split(".")[0] == "dfc_sa_unet_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(root))
    from dfc_sa_unet_torch.ops import launches, reset_launches
    from dfc_sa_unet_torch.ops import mxu_probes as ops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="checkout whose dfc_sa_unet_torch is timed (default: this one)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: scripts/bench_torch_mxu.py times kernels on a GPU")
    if args.root:
        _use_root(args.root)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    m = args.batch * H * W
    print(f"card: {card}; torch {torch.__version__}; B={args.batch} {H}x{W} {CIN}->{COUT} bf16; "
          f"matmul [{m}x{3 * CIN}]@[{3 * CIN}x{COUT}]; dfc_sa_unet_torch from "
          f"{os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(ops.__file__))))}")
    reset_launches()
    with torch.inference_mode():
        probe = Probe(args.batch, gen)
        probe.time(args.iters, probe.check(), card)
    counts = launches()
    print("launches: " + ", ".join(f"{k} {n}" for k, n in counts.items() if k.startswith("probe_")))


if __name__ == "__main__":
    main()
