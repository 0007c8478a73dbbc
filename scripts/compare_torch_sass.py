#!/usr/bin/env python3
"""Compare the machine code (SASS) of the port's CUDA kernels between two checkouts.

    python3 scripts/compare_torch_sass.py ROOT_A ROOT_B [--kernels NAME,NAME]

Builds ``dfc_sa_unet_torch/csrc`` of both checkouts with their own ``ops/_build.py`` (nvcc for
sm_90a, into each checkout's git-ignored ``_build/``), disassembles every library with the CUDA
toolkit's ``cuobjdump -sass``, and prints, for each instance of the named kernels, whether its
instructions are the same in both builds (addresses stripped; the unnamed-namespace prefix of the
mangled name, which differs from build to build, removed).  It answers whether a change to a
shared header left a kernel's code as it was.  Needs nvcc and cuobjdump, not a card.  The default
kernels are every kernel of the libraries that share the conv headers (conv3x3_bn_relu and the DFC
tail in bf16 and f32, conv3x3_bias_stats, the matrix-unit probes, conv3x3_s8) and of the two that
share only common.cuh (the attention kernels).  The halo instantiations of row sharding
(``*_halo_kernel``) match none of these names.
"""

import argparse
import glob
import os
import re
import shutil
import subprocess
import sys

KERNELS = ("conv3x3_bn_relu_kernel", "conv3x3_bn_relu_narrow_kernel", "conv3x3_bn_relu_wgmma_kernel",
           "dfc_tail_kernel", "dfc_tail_wgmma_kernel", "conv3x3_bias_stats_kernel", "conv3x3_bias_stats_wgmma_kernel",
           "conv3x3_bias_stats_narrow_kernel", "probe_conv_kernel", "probe_matmul_kernel", "conv3x3_s8_kernel",
           "pooled_attention_kernel", "pooled_attention_long_kernel", "pooled_attention_mma_kernel",
           "mha_simt_kernel", "mha_mma_kernel", "mha_wgmma_kernel")


def build(root):
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                    "from dfc_sa_unet_torch.ops import _build; _build.build()", os.path.abspath(root)], check=True)


def sass(root, kernels, cuobjdump):
    """{kernel instance: [instruction, ...]} of the named kernels in root's built libraries."""
    out = {}
    for so in sorted(glob.glob(os.path.join(root, "dfc_sa_unet_torch", "_build", "lib*.so"))):
        text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True, check=True).stdout
        for chunk in text.split("Function : ")[1:]:
            name = chunk.split("\n", 1)[0].strip()
            if not any(k in name for k in kernels):
                continue
            # the unnamed namespace's name, which differs from build to build, by its length prefix
            anon = re.match(r"_ZN(\d+)_GLOBAL__N__", name)
            if anon:
                name = "_ZN" + name[anon.end(1) + int(anon.group(1)):]
            out[name] = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).split(";")[0].strip() for ln in chunk.splitlines()
                         if re.search(r"/\*[0-9a-f]{4}\*/", ln)]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    args = ap.parse_args()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        sys.exit("cuobjdump not found: the comparison needs the CUDA toolkit")
    kernels = args.kernels.split(",")
    for root in (args.root_a, args.root_b):
        build(root)
    a, b = sass(args.root_a, kernels, cuobjdump), sass(args.root_b, kernels, cuobjdump)
    print(f"{len(a)} kernel instances in {args.root_a}, {len(b)} in {args.root_b}")
    different = 0
    for name in sorted(set(a) | set(b)):
        la, lb = a.get(name), b.get(name)
        if la is None or lb is None:
            different += 1
            print(f"  only in {args.root_a if lb is None else args.root_b}: {name}")
            continue
        differ = sum(x != y for x, y in zip(la, lb)) + abs(len(la) - len(lb))
        different += differ > 0
        print(f"  {'identical' if not differ else 'DIFFERENT'}: {len(la)} / {len(lb)} instructions, {differ} differ: "
              f"{name}")
    sys.exit(1 if different else 0)


if __name__ == "__main__":
    main()
