"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``dfc_sa_unet_torch``, on a machine with the NVIDIA cards the
cell asks for.  The last line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last); the last
lines of standard error give each compared number beside its limit.  With ``--trace 0`` the metrics
are the cell's end-to-end ones, with ``--trace 1`` its per-layer ones.  Exits non-zero, printing no
result, without CUDA or with fewer cards than the cell asks for, and if JAX or the JAX package was
loaded.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import core  # noqa: E402

core.set_cache_dirs()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = core.Cell(args.workload)
    import torch

    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = core.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the benchmark measures {core.PROGRAM} alone", file=sys.stderr)
        return 3
    core.print_checks(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
