"""The readings that a cell's limits are set from, many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 [--seconds 2]
        [--plant fp8] [--set program.dtype="float32"] [--out FILE]

For each seed, one run of the cell with a short window (``core.run_cell``), its readings against
the float32 reference and whether it came out correct.  ``--plant`` runs it with one of
``plant.PLANTS`` in place: the control ("fp8", the reference in fp8 in the program's place, which
must come out not correct), a fault the checks must catch, or a witness.  One JSON line a seed goes
to ``--out``; the last lines give, for every reading, the smallest and the largest over the seeds,
and how many runs came out correct.  Needs the card, like ``run.py``.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import core  # noqa: E402

core.set_cache_dirs()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--plant", default=None, help="the control, a fault or a witness (plant.PLANTS)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[], metavar="SECTION.KEY=JSON",
                    help="override a value of the cell's workload file (a witness at another size or dtype)")
    args = ap.parse_args(argv)
    import torch

    from portbench.plant import planted

    if not torch.cuda.is_available():
        print("calibrate.py reads the program on the card; no CUDA card here", file=sys.stderr)
        return 2
    cell = core.Cell(args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        section, name = key.split(".", 1)
        cell.workload[section][name] = json.loads(value)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        with planted(args.plant):
            result = core.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0))
        row = {"workload": args.workload, "seed": seed, "plant": args.plant, "set": args.set,
               "correct": result["correct"], "readings": result["readings"],
               "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(json.dumps(row) + "\n")
    label = args.plant or "program"
    for name in rows[0]["readings"]:
        values = [r["readings"][name] for r in rows]
        print(f"{args.workload} {label} {name}: min {min(values)!r} max {max(values)!r}", flush=True)
    print(f"{args.workload} {label}: {sum(r['correct'] for r in rows)} of {len(rows)} runs correct", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
