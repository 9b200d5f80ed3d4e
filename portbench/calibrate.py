#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 12
        --control 3 --seconds 2 [--first 1000] [--fault half_batch
        --fault-seeds 3]

For ``--seeds`` seeds from ``--first`` on it runs the cell as ``run.py``
does, with a window of ``--seconds``, and prints the numbers the
comparison reads for the program; then, for the first ``--control``
seeds, the same with the reference in TF32 in the program's place (the
control); then, for the first ``--fault-seeds`` seeds, the program with
the fault ``--fault`` planted (``faults.py``).  One JSON line a run:
``{"seed", "side", "numbers", "e2e"}``.  The benchmark's own runs do not
run this.
"""

import argparse
import json
import os
import sys

sys.path = [p for p in sys.path
            if os.path.abspath(p or ".") != os.path.dirname(
                os.path.abspath(__file__))]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first", type=int, default=1000)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = run.load_json("workloads", args.workload + ".json")
    config = run.load_json("configs", cell["config"] + ".json")
    run.prepare_environment(config)
    import importlib
    from portbench import faults
    traffic = importlib.import_module("portbench.traffic." + cell["traffic"])
    runs = [(s, "program") for s in range(args.first,
                                          args.first + args.seeds)]
    runs += [(s, "tf32") for s in range(args.first,
                                        args.first + args.control)]
    if args.fault:
        runs += [(s, args.fault) for s in range(
            args.first, args.first + args.fault_seeds)]
    planted = False
    for seed, side in runs:
        if side == args.fault and not planted:
            faults.plant(cell["traffic"], args.fault, setattr)
            planted = True
        state = traffic.setup(config, cell["params"], seed, args.device)
        out = traffic.run(state, args.seconds)
        numbers = traffic.check(state, out,
                                "tf32" if side == "tf32" else "float32")
        print(json.dumps({"seed": seed, "side": side, "numbers": numbers,
                          "e2e": out["e2e"], "failed": out["failed"]}),
              flush=True)
        del state, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
