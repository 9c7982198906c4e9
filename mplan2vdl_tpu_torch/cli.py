"""Command line of the port.

Run a plan on a generated TPC-H dataset and print the result as CSV (the
same output as ``python -m mplan2vdl_tpu run``)::

    python -m mplan2vdl_tpu_torch run QUERY.mplan --sf 0.01 --seed 7 [--decode] [--cpu]

The engine runs on the GPU; without one the command fails unless ``--cpu``
asks for the CPU.  ``compile``, ``genplans``, ``explain``, ``--tbl``,
``--devices``, ``--profile`` and ``--roofline`` are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def cmd_run(args):
    from .engine import datagen
    from .engine.lower import CompiledQuery, plan_to_vexps

    device = "cpu" if args.cpu else "cuda"
    store = datagen.generate(sf=args.sf, seed=args.seed)
    cfg = store.make_catalog()
    text = open(args.plan).read() if args.plan != "-" else sys.stdin.read()
    res = CompiledQuery(cfg, plan_to_vexps(text, cfg), store,
                        device=device)()
    if args.decode:
        cols = res.decoded(store)
    else:
        cols = [(str(nm[-1]) if nm else f"col{i}", c)
                for i, (nm, c) in enumerate(zip(res.names, res.columns))]
    print(",".join(c[0] for c in cols))
    n = len(cols[0][1]) if cols else 0
    for i in range(n):
        print(",".join(str(c[1][i]) for c in cols))


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    ap = argparse.ArgumentParser(prog="mplan2vdl_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", help="execute a plan on the engine")
    pr.add_argument("plan")
    pr.add_argument("--sf", type=float, default=0.01)
    pr.add_argument("--seed", type=int, default=7)
    pr.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    pr.add_argument("--decode", action="store_true",
                    help="decode dictionary codes / dates / decimals")
    pr.set_defaults(fn=cmd_run)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
