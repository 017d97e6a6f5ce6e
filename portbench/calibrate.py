"""Readings that the correctness limits of `limits/<workload>.json` are set
from, on the card at the cell's own sizes (not run by the benchmark's runs):

    python3 -m portbench.calibrate --workload <name> --seeds 12 --controls 3 [--out FILE]

For each of `--seeds` seeds, one short run of the cell (`run.run_cell`, a
window of `--seconds`) gives the program's numbers (the lower readings).
For each control and each of `--controls` further seeds, the control
gives its numbers (the upper readings): the program's own paths one
precision below the configuration's, in its place (`CONTROLS`). One JSON
line per reading; the calls that set the limits are
in PERF.md.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import run

# the program one precision below the configuration: int8 projections for
# its bfloat16 body, bfloat16 heads for its float32 ones
CONTROLS = ("int8", "bf16_heads")


def readings(cell, seed, seconds, variant=None, device="cuda"):
    """The numbers of one short run (`variant`: None, the program; else a
    control)."""
    result, details = run.run_cell(cell, seed, seconds, 0, device, variant=variant)
    return dict(seed=seed, variant=variant, correct=result["correct"],
                numbers=details["numbers"])


def main(argv=None):
    run.set_environment()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = run.resolve(run.load_json(run.ROOT / "BENCHMARK.json"), args.workload)
    out = open(args.out, "a") if args.out else None
    seed = args.first_seed
    plan = [None] * args.seeds + [v for v in CONTROLS for _ in range(args.controls)]
    for variant in plan:
        row = readings(cell, seed, args.seconds, variant)
        row.update(workload=args.workload, variant=variant)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        seed += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
