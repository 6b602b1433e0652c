#!/usr/bin/env python3
"""The readings that set each check's limit, at the cell's own size.

  python3 portbench/control.py --workload NAME --seeds N [N ...]
                               [--seconds S] [--control-seeds K]

For each seed, one run of the cell with a short window (`--seconds`, at
the cell's own load) gives the program's readings of every number the
check compares; for the first `--control-seeds` seeds the control is read
too: the plain reference computed in bfloat16, the precision below the
configuration's float32, put in the program's place for the same sampled
queries, against the float64 reference.  One JSON line per seed.  The
benchmark's own runs do not run this; it needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control-seeds", type=int, default=3)
    args = p.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    from portbench import harness
    harness.require_devices(1)
    for i, seed in enumerate(args.seeds):
        keep = {}
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               device="cuda", keep=keep)
        line = {"workload": args.workload, "seed": seed,
                "correct": res["correct"], "attempted": res["attempted"],
                "program": {k: c["value"] for k, c in res["checks"].items()},
                "limits": {k: c["limit"] for k, c in res["checks"].items()}}
        if i < args.control_seeds:
            line["control"] = harness.control(keep["parts"], keep["edges"],
                                              keep["samples"], "cuda")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
