"""The control of the comparison that decides ``correct``: each query's
reference computed in float32 (the precision below the configurations'
exact int64) in the program's place, over the cell's own tables, judged
by the same comparison as a run.  It has to come out not correct.

    python3 h100bench/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed with each compared number and its limit,
and exits 1 if a seed's control passed.  The benchmark's runs never run it.
"""

import argparse
import json
import os
import sys

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from h100bench import cells, check, gen  # noqa: E402


def control_run(name: str, seed: int, device, sf=None, bench=None) -> dict:
    c = cells.cell(name, bench)
    sf = c.config["scale_factor"] if sf is None else sf
    numbers = check.control(gen.generate(sf, seed, device), c)
    return {"workload": name, "seed": seed, "sf": sf,
            "correct": check.passed(numbers), "checks": numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("h100bench: no CUDA device", file=sys.stderr)
        return 2
    failed_to_fail = 0
    for seed in args.seeds:
        rec = control_run(args.workload, seed, torch.device("cuda"))
        failed_to_fail += rec["correct"]
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 1 if failed_to_fail else 0


if __name__ == "__main__":
    sys.exit(main())
