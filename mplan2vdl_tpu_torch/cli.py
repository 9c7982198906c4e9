"""Command line of the port, mirroring ``python -m mplan2vdl_tpu``: the
reference UX (MainFuns.hs:34-75; SURVEY.md Appendix A) plus execution.

Compile a plan to VDL text (the reference's only mode; no device)::

    python -m mplan2vdl_tpu_torch compile QUERY.mplan \
        -b bounds.csv -t storage.csv -s schema.msqldump --dictionary d.csv \
        [-p/--push-joins] [-c/--cleanup] [--metadata] \
        [--aggserial|--agghierarchical -g N|--aggshuffle] \
        [--sparsity X] [--goffset N] [--use-cross-product] [--dot]

With no subcommand the arguments mean ``compile``, and with no FILE the
plan is read from stdin.  ``explain`` dumps the vector-IR DAG with its
metadata; ``genplans DIR`` (or ``genplans META DIR``, META holding the four
metadata files) batch-compiles a directory.  None of these touch a device.

Run a plan on the engine against a generated dataset, or against dbgen
``.tbl`` files, and print the result as CSV::

    python -m mplan2vdl_tpu_torch run QUERY.mplan --sf 0.01 --seed 7 \
        [--decode] [--tbl DIR] [--cpu] [--profile DIR] \
        [--roofline [--hbm-gbps GBPS]] [--devices N [--explain-dist]]

``run`` uses the GPU; without one it fails unless ``--cpu`` asks for the
CPU.  ``--profile DIR`` writes a torch.profiler trace of the call
(``trace.json``), its op table (``ops.txt``) and its program spans
(``spans.txt``: one row per span name of ``tracing``, ``m2v_query``,
``m2v_node.<kind>``, ``m2v_sync.<site>``, ...: calls, host ms, host self
ms, and on the GPU the device ms of the work launched inside the span and
the device's idle ms while it was the host's innermost span);
``--roofline`` prints ``CompiledQuery.cost_report`` on stderr, with the
floor times only when ``--hbm-gbps`` gives the device's memory rate (it has
no default).

``--devices N`` (N > 1) distributes the plan over N ranks with
``parallel/auto.py``: N processes on this host, started by
``torch.multiprocessing`` (spawn) and meeting on a free localhost port, one
card each over NCCL, or with ``--cpu`` N CPU processes over gloo.  Under
``torchrun`` (``WORLD_SIZE`` set) the command joins that world instead,
which must have N processes.  Every rank builds the same store; rank 0
alone prints.  A plan outside the distribution algebra runs on rank 0's
device alone (``# not distributable (...)`` on stderr); ``--explain-dist``
prints the distribution plan on stderr.  Fewer than N cards without
``--cpu`` is an error.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def _add_meta_args(p):
    p.add_argument("-b", "--bounds", required=True)
    p.add_argument("-t", "--storage", required=True)
    p.add_argument("-s", "--schema", required=True)
    p.add_argument("--dictionary", required=True)


def _add_flag_args(p):
    p.add_argument("-p", "--push-joins", action="store_true",
                   help="apply pushFKJoins/fuseSelects rewrites")
    p.add_argument("-c", "--cleanup", action="store_true", default=True)
    p.add_argument("--no-cleanup", dest="cleanup", action="store_false")
    p.add_argument("--metadata", action="store_true")
    p.add_argument("--aggserial", action="store_true")
    p.add_argument("--agghierarchical", action="store_true")
    p.add_argument("--aggshuffle", action="store_true")
    p.add_argument("-g", "--grainsize", type=int, default=1)
    p.add_argument("--sparsity", type=float, default=1.0)
    p.add_argument("--goffset", type=int, default=0)
    p.add_argument("--use-cross-product", action="store_true")
    p.add_argument("--vdlformat", action="store_true", default=True)
    p.add_argument("--vliteformat", dest="vdlformat", action="store_false",
                   help="one-value-per-vector output labels")
    p.add_argument("--dot", action="store_true",
                   help="emit a graphviz digraph of the plan tree")
    p.add_argument("--quirks", action="store_true", default=None,
                   help="reproduce the reference's behavioral quirks "
                        "byte-for-byte: the dictionary-lookup stderr "
                        "trace (Mplan.hs:44) on top of the always-on "
                        "conformance rewrites")
    p.add_argument("--no-quirks", dest="quirks", action="store_false",
                   help="drop the reference quirk set (conformance-agg "
                        "rewrites incl. the hardcoded >32000 shuffle, "
                        "Vlite.hs:1076-1079) from the emitted VDL")


def _config_from_args(args):
    from .catalog import (AGG_HIERARCHICAL, AGG_SERIAL, AGG_SHUFFLE,
                          load_config)

    strat = AGG_SERIAL
    if args.agghierarchical:
        strat = AGG_HIERARCHICAL
    elif args.aggshuffle:
        strat = AGG_SHUFFLE
    g = args.grainsize
    if g < 1 or g & (g - 1):
        raise ValueError("grainsize must be a power of two")
    return load_config(
        args.bounds, args.storage, args.schema, args.dictionary,
        cross_product=args.use_cross_product,
        sparsity_threshold=args.sparsity,
        show_metadata=args.metadata,
        gboffset=args.goffset,
        agg_strategy=strat,
        grainsize_log=g.bit_length() - 1,
        # compile produces the reference-conformance VDL artifact: the
        # aggregation-strategy rewrites apply (the engine's `run` builds its
        # own Config and keeps them off); --no-quirks drops them, --quirks
        # adds the dictionary-lookup stderr trace
        conformance_agg=args.quirks is not False,
        quirk_trace_dict=args.quirks is True,
    )


def _compile_to_vexps(text, cfg, push_joins, cleanup):
    from . import mplan, passes, vir
    from .fe import lexer, plan_parser

    rel = plan_parser.parse(lexer.strip_plan_comments(text))
    m = mplan.mplan_from_parse_tree(rel, cfg)
    if push_joins:
        m = mplan.fuse_selects(mplan.push_fk_joins(m))
    vexps = vir.vexps_from_mplan(m, cfg)
    if cleanup:
        vexps = passes.reference_passes(vexps)
    return vexps


def _plan_text(path):
    """The plan text of a file, or of stdin for ``-``."""
    if path == "-":
        return sys.stdin.read()
    with open(path) as f:
        return f.read()


def compile_to_text(plan_path, bounds, storage, schema, dictionary,
                    extra=()):
    """Programmatic ``compile``: the VDL text of a plan file against a
    metadata snapshot, ``extra`` holding further command-line flags."""
    ap = argparse.ArgumentParser()
    ap.add_argument("plan")
    _add_meta_args(ap)
    _add_flag_args(ap)
    args = ap.parse_args([plan_path, "-b", bounds, "-t", storage,
                          "-s", schema, "--dictionary", dictionary,
                          *extra])
    cfg = _config_from_args(args)
    from .vdl_emit import emit_vdl, emit_vlite

    vexps = _compile_to_vexps(_plan_text(plan_path), cfg, args.push_joins,
                              args.cleanup)
    if args.vdlformat:
        return emit_vdl(vexps, cfg, show_metadata=args.metadata)
    return emit_vlite(vexps, cfg)


def cmd_compile(args):
    cfg = _config_from_args(args)
    text = _plan_text(args.plan)
    if args.dot:
        # permissive re-parse: --dot renders plans the strict grammar or
        # codegen rejects (reference MainFuns.hs:165-170, TreeParser.y)
        from .dot import plan_text_to_dot
        from .fe import lexer

        print(plan_text_to_dot(lexer.strip_plan_comments(text)))
        return
    from .vdl_emit import emit_vdl, emit_vlite

    vexps = _compile_to_vexps(text, cfg, args.push_joins, args.cleanup)
    if args.vdlformat:
        print(emit_vdl(vexps, cfg, show_metadata=args.metadata))
    else:
        print(emit_vlite(vexps, cfg))


def cmd_genplans(args):
    """Batch compile; reports SUCCESS/TOTAL (reference genplans:12-33)."""
    cfg = _config_from_args(args)
    files = sorted(glob.glob(os.path.join(args.dir, "*plan")))
    ok = 0
    for f in files:
        try:
            vexps = _compile_to_vexps(_plan_text(f), cfg, args.push_joins,
                                      args.cleanup)
            print(f"{os.path.basename(f)}: OK ({len(vexps)} outputs)")
            ok += 1
        except Exception as e:  # one plan's failure is its report line
            print(f"{os.path.basename(f)}: FAIL {type(e).__name__}: "
                  f"{str(e)[:120]}")
    print(f"SUCCESS/TOTAL: {ok}/{len(files)}")


def cmd_explain(args):
    cfg = _config_from_args(args)
    from . import passes
    from .explain import explain_vexps

    vexps = _compile_to_vexps(_plan_text(args.plan), cfg, args.push_joins,
                              False)
    if args.cleanup:
        vexps = passes.engine_passes(vexps)
    print(explain_vexps(vexps))


def _profiled_call(runner, device, out_dir):
    """One call of ``runner`` under torch.profiler: CPU activity, and CUDA
    activity on the GPU.  Writes ``trace.json`` (a Chrome trace),
    ``ops.txt`` (``key_averages`` by self device time; by self CPU time on
    the CPU) and ``spans.txt`` (``tracing.span_table``) into ``out_dir``
    and returns the call's result.  The columns are on ``device`` (the
    caller put them there) and the kernel library loads before the session
    opens, so the trace holds the call alone.
    Each kernel launch is a range named after its C entry point
    (``m2v_gather``, ...).  On the GPU it raises when the profiler recorded
    no device activity: a trace without the card's kernels is not
    written.  Open one session per process; a later session in the same
    process has been seen to miss kernel records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from . import tracing

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        from .engine.kernels import _lib

        _lib.lib()
        torch.cuda.synchronize(device)
        acts.append(ProfilerActivity.CUDA)
    tracing.clear()
    with profile(activities=acts) as prof:
        res = runner()
    avg = prof.key_averages()
    sort = "self_cpu_time_total"
    if device.type == "cuda":
        if not any(e.device_type == DeviceType.CUDA for e in avg):
            raise RuntimeError("--profile: the profiler recorded no CUDA "
                               "activity on the card")
        sort = "self_device_time_total"
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    with open(os.path.join(out_dir, "ops.txt"), "w") as f:
        f.write(avg.table(sort_by=sort, row_limit=-1,
                          max_name_column_width=100))
    with open(os.path.join(out_dir, "spans.txt"), "w") as f:
        f.write(tracing.span_table(prof))
    return res


def _print_roofline(rep):
    """``cost_report(per_op=True)`` as ``# key: value`` lines on stderr,
    then the bytes per VIR node kind and the costliest nodes."""
    rep = dict(rep)
    per_op = rep.pop("per_op", None)
    for k, v in rep.items():
        print(f"# {k}: {v}", file=sys.stderr)
    if per_op:
        print("# per-node-kind traffic (estimated operand+output bytes):",
              file=sys.stderr)
        for kind, b in list(per_op["by_kind"].items())[:8]:
            print(f"#   {kind:<28} {b/1e6:10.2f} MB", file=sys.stderr)
        print("# top nodes:", file=sys.stderr)
        for label, b, ob in per_op["top_nodes"][:8]:
            print(f"#   {label:<44} {b/1e6:10.2f} MB", file=sys.stderr)


def cmd_run(args):
    n_dev = args.devices or 0
    if n_dev > 1:
        _run_distributed(args, n_dev)
        return
    from . import device

    _run(args, device.resolve("cpu" if args.cpu else None))


def _run(args, dev, mesh=None):
    """``run`` on this process's ``dev``; with a ``mesh`` (this rank's),
    distributed over its ranks, rank 0 alone printing."""
    from .engine import datagen
    from .engine.lower import CompiledQuery, plan_to_vexps

    if args.tbl:
        from .engine import tblingest

        store = tblingest.from_tbl(args.tbl)
    else:
        store = datagen.generate(sf=args.sf, seed=args.seed,
                                 legacy_fk_names=args.legacy_fk_names)
    cfg = store.make_catalog(cross_product=args.use_cross_product)
    vexps = plan_to_vexps(_plan_text(args.plan), cfg)
    lead = mesh is None or mesh.rank == 0

    runner, cq = None, None
    if mesh is not None:
        from .parallel import auto

        try:
            dq = auto.distribute(cfg, store, vexps, mesh)
            runner = dq.result
            if args.explain_dist and lead:
                for ln in dq.describe().splitlines():
                    print(f"# {ln}", file=sys.stderr)
        except auto.NotDistributable as e:
            # decided alike on every rank, before any collective: rank 0
            # runs the plan alone and the others are done
            if not lead:
                return
            print(f"# not distributable ({e}); running single-chip",
                  file=sys.stderr)
    if runner is None:
        cq = CompiledQuery(cfg, vexps, store, device=dev)
        runner = cq
    if args.profile and lead:
        if cq is not None:
            cq.device_args()
        res = _profiled_call(runner, dev, args.profile)
        print(f"# profiler trace written to {args.profile}", file=sys.stderr)
    else:
        res = runner()
    if not lead:
        return
    if args.roofline:
        if cq is None:
            print("# --roofline accounts the single-chip program; "
                  "ignored under --devices", file=sys.stderr)
        else:
            _print_roofline(cq.cost_report(hbm_gbps=args.hbm_gbps,
                                           per_op=True))
    if args.decode:
        cols = res.decoded(store)
    else:
        cols = [(str(nm[-1]) if nm else f"col{i}", c)
                for i, (nm, c) in enumerate(zip(res.names, res.columns))]
    print(",".join(c[0] for c in cols))
    n = len(cols[0][1]) if cols else 0
    for i in range(n):
        print(",".join(str(c[1][i]) for c in cols))


def _run_distributed(args, n_dev):
    """``run --devices N``: join torchrun's world of N processes, or start
    N ranks on this host (spawned, meeting on a free localhost port)."""
    import socket

    import torch
    from torch.multiprocessing.spawn import ProcessException

    world = os.environ.get("WORLD_SIZE")
    if world is not None:
        if int(world) != n_dev:
            sys.exit(f"--devices {n_dev}: torchrun started {world} "
                     "process(es)")
        _rank_main(int(os.environ.get("RANK", "0")), n_dev, None,
                   vars(args))
        return
    if not args.cpu and torch.cuda.device_count() < n_dev:
        sys.exit(f"--devices {n_dev}: only {torch.cuda.device_count()} "
                 f"device(s) available (use --cpu for {n_dev} gloo ranks)")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        url = f"tcp://localhost:{sock.getsockname()[1]}"
    # the ranks share this host: NCCL's bootstrap over the loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    sys.stdout.flush()
    sys.stderr.flush()
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(n_dev, url, vars(args)), nprocs=n_dev,
            start_method="spawn")
    except ProcessException as e:
        sys.exit(f"--devices {n_dev}: {e}")


def _rank_main(rank, world, url, arg_dict):
    """One rank of ``run --devices``: join the group (gloo on the CPU,
    NCCL with card ``rank`` of this host otherwise), run, leave."""
    import torch
    import torch.distributed as tdist

    from .parallel import multihost

    args = argparse.Namespace(**arg_dict)
    if args.cpu:
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    elif url is None:  # torchrun: this process's card is LOCAL_RANK
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    else:
        dev = torch.device("cuda", rank)
    multihost.initialize(url, world, rank, device=dev)
    try:
        _run(args, dev, multihost.data_mesh(device=dev))
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        tdist.destroy_process_group()


# flags that consume the next argv token (for the no-subcommand rewrite)
_VALUE_FLAGS = {"-b", "--bounds", "-t", "--storage", "-s", "--schema",
                "--dictionary", "-g", "--grainsize", "--sparsity",
                "--goffset", "--sf", "--seed", "--devices", "--profile",
                "--tbl", "--hbm-gbps"}
_SUBCOMMANDS = ("compile", "genplans", "explain", "run")


def _normalize_argv(argv):
    """Reference UX (MainFuns.hs:34-75,140; SURVEY Appendix A): the binary
    takes ``[FILE] -b … -t … -s … --dictionary …`` with NO subcommand,
    defaulting to compile and reading the plan from stdin when FILE is
    absent.  Rewrite such invocations into the ``compile`` subcommand;
    explicit subcommands pass through untouched."""
    if not argv or "-h" in argv or "--help" in argv:
        return argv
    positionals = []
    skip = False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok in _VALUE_FLAGS:
            skip = True
            continue
        if tok.startswith("--") and "=" in tok:
            continue
        if tok.startswith("-") and tok != "-":
            continue
        positionals.append(tok)
    if positionals and positionals[0] in _SUBCOMMANDS:
        return argv
    if not positionals:
        # no FILE: read the plan from stdin (MainFuns.hs:140)
        return ["compile", "-"] + list(argv)
    return ["compile"] + list(argv)


def _expand_genplans_meta(argv):
    """Reference ``genplans META DIR`` convenience (genplans:12-33 +
    tpchrun:2-4): a metadata DIRECTORY as the first genplans operand
    expands to the four conventional file flags inside it."""
    if len(argv) >= 3 and argv[0] == "genplans" and \
            os.path.isdir(argv[1]) and \
            os.path.isfile(os.path.join(argv[1], "bounds.csv")) and \
            not any(a in ("-b", "--bounds") for a in argv):
        meta, rest = argv[1], argv[2:]
        return ["genplans", *rest,
                "-b", os.path.join(meta, "bounds.csv"),
                "-t", os.path.join(meta, "storage.csv"),
                "-s", os.path.join(meta, "schema.msqldump"),
                "--dictionary", os.path.join(meta, "dictionary.csv")]
    return argv


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    argv = _normalize_argv(list(argv))
    argv = _expand_genplans_meta(argv)
    ap = argparse.ArgumentParser(prog="mplan2vdl_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("compile", help="mplan -> VDL text")
    pc.add_argument("plan")
    _add_meta_args(pc)
    _add_flag_args(pc)
    pc.set_defaults(fn=cmd_compile)

    pg = sub.add_parser("genplans", help="batch compile a directory")
    pg.add_argument("dir")
    _add_meta_args(pg)
    _add_flag_args(pg)
    pg.set_defaults(fn=cmd_genplans)

    pe = sub.add_parser("explain", help="dump the vector-IR DAG + metadata")
    pe.add_argument("plan")
    _add_meta_args(pe)
    _add_flag_args(pe)
    pe.set_defaults(fn=cmd_explain)

    pr = sub.add_parser("run", help="execute a plan on the engine")
    pr.add_argument("plan")
    pr.add_argument("--sf", type=float, default=0.01)
    pr.add_argument("--seed", type=int, default=7)
    pr.add_argument("--tbl", metavar="DIR", default=None,
                    help="load the database from dbgen .tbl files in DIR "
                         "instead of generating synthetic data")
    pr.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    pr.add_argument("--devices", type=int, default=0, metavar="N",
                    help="distribute over N ranks, one card each (with "
                         "--cpu, N CPU processes over gloo); plans outside "
                         "the distribution algebra run on one device")
    pr.add_argument("--explain-dist", action="store_true",
                    help="print the distribution plan (sharded vs "
                         "replicated columns, partitioned joins, domains)")
    pr.add_argument("--decode", action="store_true",
                    help="decode dictionary codes / dates / decimals")
    pr.add_argument("--use-cross-product", action="store_true")
    pr.add_argument("--legacy-fk-names", action="store_true",
                    help="name FK join-index columns %%<tab>_fkN (the "
                         "monetpch/simple corpora's convention)")
    pr.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace of the call, its "
                         "op table and its program spans into DIR")
    pr.add_argument("--roofline", action="store_true",
                    help="print memory-roofline accounting (scan bytes, "
                         "bytes accessed, amplification; floor times with "
                         "--hbm-gbps)")
    pr.add_argument("--hbm-gbps", type=float, default=None,
                    help="the device's memory rate in GB/s for the "
                         "roofline floor (no default)")
    pr.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
