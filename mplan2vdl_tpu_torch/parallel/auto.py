"""Automatic distributed execution of fact-table aggregate plans.

The port of ``mplan2vdl_tpu/parallel/auto.py``, SPMD over a
``torch.distributed`` process group (``dist.Mesh``): every rank runs the
same calls on its own rows, and the collectives of ``dist``,
``shuffle_agg`` and ``shuffle_join`` take the place of ``shard_map``,
``lax.psum``/``pmax``/``pmin`` and ``all_to_all``.  When the plan
qualifies, the pre-aggregate stage runs fully distributed:

  * the FACT table (the one whose row count carries the plan's row axis)
    is row-sharded over the ranks (rank ``r`` holds rows
    ``[r·shard_rows, (r+1)·shard_rows)``); all other (dimension) tables
    are replicated on every rank's device — so the FK-gather join algebra
    (Vlite.hs:1248-1282), selections, LIKE, and scalar arithmetic all run
    rank-local through the ordinary engine Compiler with zero
    communication
  * every terminal Fold shares one dense-bounded group-id vector; each
    rank produces a dense per-domain partial per Fold, and one
    ``all_reduce`` per Fold (sum / max / min) combines them — the analog
    of the reference's hierarchical fold (Vlite.hs:1173-1194)
  * the combined vectors are compacted to occupied groups and seeded into
    a fresh Compiler memo, which evaluates the remaining group-level
    expressions (avg divisions, outer folds, key reuse) unchanged, on
    every rank

Equijoins run one of two ways:

  * PARTITIONED SHUFFLE JOIN (default for fact-frame right sides —
    Q2/Q17/Q21-class self-joins; see _plan_part_joins and
    parallel/shuffle_join.py): both sides evaluate rank-locally, rows
    exchange by key hash, matched pairs + right-value payload columns
    route back to the probe rank.  Exchange capacities are EXACT, from
    the heavy-key round and two small counting rounds (destination
    histograms, then a counts-only exchange).  MPLAN2VDL_NO_PART_JOIN=1
    disables.
  * replicated right side (everything else): the right side evaluates at
    full width on every rank and the local probe searches it.

Other frames that do not shard elementwise are routed through full-width
evaluation (identical on every rank, from replicated columns): fact-domain
mask scatters slice per-rank row windows; gathers whose positions live in
replicated frames evaluate whole.  Fact ROW-POSITION values
(representative-row picks, row-id group keys, rowid join keys, synthesized
row identities over derived frames) evaluate locally and are globalized by
``rstep * shard_start`` at the fold/join/exchange boundary — EXCEPT chains
passing through full-width or payload nodes, whose values are global
already; positions that leak through unrecognized shapes disqualify the
plan.

What the JAX module does only for XLA's static shapes has no counterpart:
the distributed counting round of each replicated-right join
(``count_join_round``), ``dynamic_nodes`` and the pruned ``CompiledQuery``
pass that sized ``join_sizes`` and ``full_fsel_sizes``.  The port's
compiler is eager and reads each join's and each selection's size where it
arises, so a rank's buffers have its own local sizes.  For the same
reason a ``JoinIndex`` above the innermost folds needs no pre-sized join in
the group stage (the JAX group stage raises there, TPC-H Q17).

Every host decision that changes what the ranks exchange reads values
all-reduced over the ranks (the heavy plan and the capacities, the sparse
overflow retry, the occupancy check), and no rank skips a node, so every
rank reaches every collective.  Results stay on the device until the
edge: the dense combined vectors, each owner's live rows of a sparse
group-by, the valid prefixes of a rowset plan.  Every rank returns the
same rows.

Disqualified (single-device fallback, ``NotDistributable``): plans with
SortPerm inside the aggregate stage, sparse (> 2^20) domains mixing
heterogeneous fold keys/masks or scatters, and the other shapes named by
each ``NotDistributable`` text below.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .. import vir as V
from ..catalog import Config
from ..engine.columnstore import ColumnStore
from ..engine.kernels import segred
from ..engine.lower import (Compiler, QueryResult, Val, _children,
                            _mask_tail, _sel_positions, torch_dtype_for)
from . import dist
from .shuffle_agg import _SENT, shard_shuffle_combine
from .shuffle_join import (dest_histogram, key_sents, owner_dest,
                           shard_heavy_detect, shard_join_count_stats,
                           shard_shuffle_join, _member_lohi)


class NotDistributable(Exception):
    pass


def _collect_folds(vexps: List[V.Vexp]) -> List[V.Vexp]:
    """INNERMOST aggregate folds: the row->group reduction boundary.
    Outer folds over group-level frames (Q15's max-over-revenues) stay in
    the host-side group stage, evaluated from the seeded inner results."""
    seen, folds = set(), {}

    def go(v: V.Vexp):
        if v.skey in seen:
            return
        seen.add(v.skey)
        if isinstance(v.vx, V.Fold) and v.vx.foldop != V.FSEL:
            folds[v.skey] = v
        for c in _children(v.vx):
            go(c)

    for v in vexps:
        go(v)

    def has_nested(v: V.Vexp) -> bool:
        stack, s2 = list(_children(v.vx)), set()
        while stack:
            x = stack.pop()
            if x.skey in s2:
                continue
            s2.add(x.skey)
            if isinstance(x.vx, V.Fold) and x.vx.foldop != V.FSEL:
                return True
            stack.extend(_children(x.vx))
        return False

    return [v for v in folds.values() if not has_nested(v)]


def _joins_under(v: V.Vexp):
    seen, out = set(), []

    def go(x: V.Vexp):
        if x.skey in seen:
            return
        seen.add(x.skey)
        if isinstance(x.vx, V.JoinIndex):
            out.append(x)
        for c in _children(x.vx):
            go(c)

    go(v)
    return out


def _contains_right_join(v: V.Vexp) -> bool:
    seen = set()

    def go(x: V.Vexp) -> bool:
        if x.skey in seen:
            return False
        seen.add(x.skey)
        if isinstance(x.vx, V.JoinIndex) and x.vx.jside in (
                V.JRIGHT, V.JOUTER_RIGHT):
            return True
        return any(go(c) for c in _children(x.vx))

    return go(v)


def _rowid_chain(v: V.Vexp, fact_count: int):
    """If this expression's VALUES are fact row positions reached through
    a pure gather/partition chain from ``RangeV(rmin, rstep, RangeC_fact)``
    (representative-row picks, row-id group keys), return ``rstep`` — the
    per-row-position increment.  Shard-local evaluation yields LOCAL
    positions; adding ``rstep * shard_start`` globalizes them.  None when
    values are not row positions."""
    vx = v.vx
    if (isinstance(vx, V.RangeV) and vx.rstep != 0
            and isinstance(vx.rref.vx, V.RangeC)
            and vx.rref.vx.rcount == fact_count):
        return vx.rstep
    if isinstance(vx, V.Shuffle) and vx.shop == V.GATHER:
        return _rowid_chain(vx.shsource, fact_count)
    if isinstance(vx, V.Partition):
        return _rowid_chain(vx.pdata, fact_count)
    return None


def _frame_pos_chain(v: V.Vexp, fact_count: int):
    """Superset of ``_rowid_chain``: also accepts positions of DERIVED
    local frames — ``RangeV(rmin, rstep!=0)`` over ANY fact-frame-bounded
    ref (synthesized row identities over compacted frames, the reference's
    ``identity()`` row-ids).  Globalizing by ``rstep*shard_start`` keeps
    them distinct, in-bounds (local positions < local valid rows), and
    order-isomorphic with the single-chip values — sufficient for GROUP
    IDS and partition keys, NOT for value-exact uses (join keys, values
    gathered through later)."""
    vx = v.vx
    if (isinstance(vx, V.RangeV) and vx.rstep != 0
            and vx.rref.info.count == fact_count):
        return vx.rstep
    if isinstance(vx, V.Fold) and vx.foldop == V.FSEL:
        return 1  # compaction positions ARE local frame positions
    if isinstance(vx, V.Shuffle) and vx.shop == V.GATHER:
        return _frame_pos_chain(vx.shsource, fact_count)
    if isinstance(vx, V.Partition):
        return _frame_pos_chain(vx.pdata, fact_count)
    return None


def _chain_through(v: V.Vexp, skeys) -> bool:
    """True when the position/rowid CHAIN from ``v`` passes through one of
    ``skeys`` (intercepted payload gathers deliver already-globalized
    values — a second rstep*shard_start would corrupt them)."""
    if v.skey in skeys:
        return True
    vx = v.vx
    if isinstance(vx, V.Shuffle) and vx.shop == V.GATHER:
        return _chain_through(vx.shsource, skeys)
    if isinstance(vx, V.Partition):
        return _chain_through(vx.pdata, skeys)
    return False


def _rowid_leaks(v: V.Vexp, fact_count: int, allow_chain: bool = True) -> bool:
    """True if fact row-position VALUES flow into this expression through
    anything other than the pure chain ``_rowid_chain`` recognises (e.g.
    bit-packed composite keys): shard-local evaluation would mix local
    positions across shards, which no single offset can repair."""
    seen = set()

    def go(x: V.Vexp, in_chain: bool) -> bool:
        key = (x.skey, in_chain)
        if key in seen:
            return False
        seen.add(key)
        vx = x.vx
        if (isinstance(vx, V.RangeV) and vx.rstep != 0
                and isinstance(vx.rref.vx, V.RangeC)
                and vx.rref.vx.rcount == fact_count):
            return not in_chain
        if isinstance(vx, V.Fold) and vx.foldop == V.FSEL:
            return False  # selection vectors are index space, not values
        if isinstance(vx, V.JoinIndex):
            # probe keys that are rowid chains are globalized at the join
            # (see _ShardCompiler); rkeys evaluate at full width where
            # rowids are global already; join OUTPUTS are index space
            return go(vx.lkeys, True)
        if isinstance(vx, V.Shuffle) and vx.shop == V.GATHER:
            # positions are index space (selection compositions); only the
            # source carries values onward
            return go(vx.shsource, in_chain)
        if (isinstance(vx, V.Shuffle) and vx.shop == V.SCATTER
                and vx.shshape is not None
                and vx.shshape.info.count == fact_count):
            return False  # full-eval region
        if isinstance(vx, V.Partition):
            return go(vx.pdata, in_chain)
        return any(go(c, False) for c in _children(vx))

    return go(v, allow_chain)


_PART_SIDES = frozenset((V.JLEFT, V.JRIGHT, V.JSEMI, V.JANTI,
                         V.JOUTER_LEFT, V.JOUTER_RIGHT, V.JOUTER_VALID))
_OUTER_SIDES = frozenset((V.JOUTER_LEFT, V.JOUTER_RIGHT, V.JOUTER_VALID))


def _loads_outside_part(folds, part_keys, part_skip):
    """Table columns read OUTSIDE partitioned-join right-side chains (those
    chains' loads ship sharded; anything else still needs replication)."""
    seen, out = set(), []

    def go(x: V.Vexp):
        if x.skey in seen or x.skey in part_skip:
            return
        seen.add(x.skey)
        vx = x.vx
        if isinstance(vx, V.Load):
            out.append(vx.name)
            return
        if isinstance(vx, V.JoinIndex) and (
                vx.lkeys.skey, vx.rkeys.skey) in part_keys:
            go(vx.lkeys)  # the rkeys chain is exchange territory
            return
        for c in _children(vx):
            go(c)

    for f in folds:
        go(f)
    return out


def _plan_part_joins(folds, fact: str, fact_count: int, store=None):
    """Joins whose RIGHT side is a pure fact-frame chain run as DISTRIBUTED
    SHUFFLE JOINS (parallel/shuffle_join.py) instead of replicating the
    right side to every shard: both sides evaluate shard-locally, rows
    exchange by key range, and matches route back to the probe shard.
    This removes the full-width fact-column replication that the Q2/Q17/
    Q21-class self-joins otherwise force (their right sides ARE fact-frame
    expressions).

    Right-side VALUES reach the probe shard as PAYLOAD columns riding the
    exchange.  A consumer gather whose source holds plain values ships
    directly; position-valued sources (FSel compaction positions, RangeV
    row identities — the reference's ``identity()``) are handled by
    GATHER-CHAIN COMPOSITION on the build side — ``S1[s0[jr]]`` becomes
    the shipped value ``(S1 o s0)`` evaluated where both frames are local
    — until the composed value is either plain or consumed only by
    grouping contexts (partition keys / fold group ids), where a
    distinctness-preserving globalization (+rstep*shard_start) suffices.

    RIGHT FRAMES may be the fact frame (Q17/Q21 self-joins) or a single
    partitioned DIM table's frame (Q13's orders side): dim-frame chains
    evaluate in a nested shard compiler over that table's row shard, so
    the dim table is never replicated.  OUTER joins append each probe
    shard's unmatched rows after its matched pairs (the single-chip
    layout), with outer-valid = 1/0 flags and null (0) right payloads.

    Partitionable when the key chains are 'L'-pure and value-exact and
    every 'right' output resolves through the composition rules above.

    Returns (part_joins: key -> spec, part_pay: intercepted gather skey ->
    (key, payload index), part_skip: gather skeys the region planner must
    not classify (their values come from the exchange), part_roots: chain
    sources the region planner still walks for scatter/sort checks).
    """
    nodes_seen, parents, joins_by_key = set(), {}, {}
    order = []  # post-order of join keys (dependency order for sizing)

    def walk(x: V.Vexp):
        if x.skey in nodes_seen:
            return
        nodes_seen.add(x.skey)
        for c in _children(x.vx):
            walk(c)
            parents.setdefault(c.skey, []).append(x)
        if isinstance(x.vx, V.JoinIndex):
            key = (x.vx.lkeys.skey, x.vx.rkeys.skey)
            if key not in joins_by_key:
                joins_by_key[key] = []
                order.append(key)
            joins_by_key[key].append(x)

    for f in folds:
        walk(f)

    def index_space(x: V.Vexp) -> bool:
        """Values are LOCAL row positions of some local frame (selection
        vectors, row identities, and their compositions)."""
        vx = x.vx
        if isinstance(vx, V.Fold) and vx.foldop == V.FSEL:
            return True
        if isinstance(vx, V.RangeV):
            return (vx.rstep == 0) or (vx.rstep == 1 and vx.rmin == 0)
        if isinstance(vx, V.Shuffle) and vx.shop == V.GATHER:
            return index_space(vx.shsource) and index_space(vx.shpos)
        if isinstance(vx, V.JoinIndex):
            return vx.jside in (V.JLEFT, V.JSEMI, V.JANTI)
        return False

    def make_klass(tab: str, cnt: int):
        """Frame classifier over ``tab``'s row frame: 'L' = pure chain
        (shard-local eval == global eval restricted to local rows); 'R' =
        fully replicated; None = neither.  In a partitioned-DIM context
        (tab != fact) fact columns are unavailable — they arrive sharded
        by the FACT layout — so they classify None."""
        kmemo = {}

        def klass(x: V.Vexp):
            if x.skey in kmemo:
                return kmemo[x.skey]
            vx = x.vx
            if isinstance(vx, V.Load):
                if vx.name[0] == tab:
                    r = "L"
                elif tab != fact and vx.name[0] == fact:
                    r = None
                else:
                    r = "R"
            elif isinstance(vx, V.RangeC):
                if vx.rcount == cnt:
                    r = "L"
                elif tab != fact and vx.rcount == fact_count:
                    r = None
                else:
                    r = "R"
            elif isinstance(vx, V.RangeV):
                r = klass(vx.rref)
            elif isinstance(vx, V.Binop):
                kl, kr = klass(vx.left), klass(vx.right)
                r = kl if kl == kr else None
            elif isinstance(vx, V.Shuffle) and vx.shop == V.GATHER:
                ks, kp = klass(vx.shsource), klass(vx.shpos)
                if kp == "L" and ks == "R":
                    r = "L"  # fk gather into a replicated dim frame
                elif kp == "L" and ks == "L" and index_space(vx.shpos):
                    r = "L"  # selection composition within the local frame
                elif kp == "R" and ks == "R":
                    r = "R"
                else:
                    r = None
            elif isinstance(vx, V.Fold) and vx.foldop == V.FSEL:
                r = klass(vx.fdata)
            elif isinstance(vx, V.Partition):
                r = klass(vx.pdata) if klass(vx.pivots) == "R" else None
            elif isinstance(vx, (V.Like, V.DictMap)):
                r = klass(vx.ldata)
            elif isinstance(vx, V.VShuffle):
                r = klass(vx.varg)
            else:  # aggregates, scatters, sorts, joins, cross products
                r = None
            kmemo[x.skey] = r
            return r

        return klass

    def has_pos_values(x: V.Vexp) -> bool:
        """Frame positions buried INSIDE value arithmetic (bit-packed
        composites etc.) — not salvageable by composition/globalization."""
        seen = set()

        def go(y: V.Vexp) -> bool:
            if y.skey in seen:
                return False
            seen.add(y.skey)
            vy = y.vx
            if isinstance(vy, V.RangeV) and vy.rstep != 0:
                return True
            if isinstance(vy, V.Fold) and vy.foldop == V.FSEL:
                return True
            if isinstance(vy, V.Shuffle) and vy.shop == V.GATHER:
                return go(vy.shsource)
            if isinstance(vy, V.JoinIndex):
                return False
            return any(go(c) for c in _children(vy))

        return go(x)

    def value_kind(src: V.Vexp, cnt: int):
        """'value' ships as-is; 'exact' = raw rowid chain (+og exact);
        'pos' = local frame positions (compose deeper, or globalize for
        grouping-only consumers); None = reject."""
        if _rowid_chain(src, cnt) is not None:
            return "exact"
        if index_space(src) or _frame_pos_chain(src, cnt) is not None:
            return "pos"
        if has_pos_values(src):
            return None
        return "value"

    tables_all = {nm[0] for nm in getattr(store, "columns", {})} \
        if store is not None else set()
    counts_all = {t: store.table_count((t,)) for t in tables_all}

    fact_klass = make_klass(fact, fact_count)
    part_joins, part_pay, part_skip, part_roots = {}, {}, set(), []
    for key in order:
        jnodes = joins_by_key[key]
        sides = {n.vx.jside for n in jnodes}
        if not sides <= _PART_SIDES:
            continue
        outer = bool(sides & _OUTER_SIDES)
        j0 = jnodes[0].vx
        lk, rk = j0.lkeys, j0.rkeys
        if lk.info.count != fact_count:
            continue
        # pick the right frame: the fact frame, or ONE partitionable dim
        # table whose row count matches and is unambiguous (RangeC sizing
        # in the dim shard compiler keys on the count)
        rtab, rcnt, klass = fact, fact_count, fact_klass
        if fact_klass(rk) != "L":
            cands = []
            for t in sorted({nm[0] for nm in _loads_under(rk)}):
                tc = counts_all.get(t)
                if (t != fact and tc and tc == rk.info.count
                        and tc != fact_count
                        and sum(1 for c in counts_all.values()
                                if c == tc) == 1):
                    kt = make_klass(t, tc)
                    if kt(rk) == "L":
                        cands.append((t, tc, kt))
            if len(cands) != 1:
                continue
            rtab, rcnt, klass = cands[0]
        # join keys must be VALUE-exact after shard-local eval
        if value_kind(lk, fact_count) not in ("value", "exact") \
                or value_kind(rk, rcnt) not in ("value", "exact"):
            continue

        pays, pay_map = [], {}
        new_pay, new_skip, new_roots = {}, set(), []

        def ship(gnode: V.Vexp, chain: tuple, loose: bool) -> None:
            sig = (chain, loose)
            if sig not in pay_map:
                pay_map[sig] = len(pays)
                pays.append(dict(chain=list(chain), loose=loose))
            new_pay[gnode.skey] = pay_map[sig]
            new_skip.add(gnode.skey)

        def visit(gnode: V.Vexp, chain: tuple) -> bool:
            """gnode's value = composition of ``chain`` at the join's
            right outputs.  Ship it, compose deeper, or reject."""
            src = chain[-1]
            if klass(src) != "L":
                return False
            if len(chain) == 1 and src.info.count != rk.info.count:
                return False
            kind = value_kind(src, rcnt)
            if kind is None:
                return False
            if kind in ("value", "exact"):
                ship(gnode, chain, loose=False)
                return True
            # 'pos': every consumer must compose deeper or only group by it
            shipped_loose = False
            for q in parents.get(gnode.skey, []):
                qx = q.vx
                if (isinstance(qx, V.Shuffle) and qx.shop == V.GATHER
                        and qx.shpos.skey == gnode.skey):
                    new_skip.add(gnode.skey)
                    if not visit(q, chain + (qx.shsource,)):
                        return False
                elif ((isinstance(qx, V.Partition)
                       and qx.pdata.skey == gnode.skey)
                      or (isinstance(qx, V.Fold)
                          and qx.fgroups.skey == gnode.skey)):
                    if not shipped_loose:
                        ship(gnode, chain, loose=True)
                        shipped_loose = True
                else:
                    return False
            return True

        ok = True
        for n in jnodes:
            if n.vx.jside not in (V.JRIGHT, V.JOUTER_RIGHT):
                continue
            for p in parents.get(n.skey, []):
                if not (isinstance(p.vx, V.Shuffle)
                        and p.vx.shop == V.GATHER
                        and p.vx.shpos.skey == n.skey):
                    ok = False
                    break
                if not visit(p, (p.vx.shsource,)):
                    ok = False
                    break
            if not ok:
                break
        if not ok:
            continue
        for spec in pays:
            new_roots.extend(spec["chain"])
        for skey, idx in new_pay.items():
            part_pay[skey] = (key, idx)
        part_skip |= new_skip
        part_roots.extend(new_roots + [lk, rk])
        klo = min(lk.info.bounds[0], rk.info.bounds[0])
        khi = max(lk.info.bounds[1], rk.info.bounds[1]) + 1
        # int32 keys when bounds fit below the int32 sentinels: halves
        # the exchange's key bytes and compiles faster
        k32 = klo > -(2**31) and khi < 2**31 - 2
        part_joins[key] = dict(lkeys=lk, rkeys=rk, pays=pays,
                               bounds=(int(klo), int(khi)), caps=None,
                               table=None if rtab == fact else rtab,
                               t_count=rcnt, outer=outer, k32=k32)
    return part_joins, part_pay, part_skip, part_roots


def _plan_regions(folds, fact: str, fact_count: int,
                  part_keys=frozenset(), part_skip=frozenset(),
                  part_roots=()):
    """Classify each fold-subtree node's FRAME as shard-LOCAL (fact rows,
    or frames derived from them: selections, join expansions of a local
    probe) or REPLICATED (dim tables, and anything forced to full-width
    evaluation), and assign full-width interception sets:

      scatters   — fact-domain-sized scatters: evaluated at full width in
                   the nested compiler, each shard slices its row window
      replicate  — whole nodes evaluated at full width (gathers whose
                   positions live in a replicated frame but index the fact
                   domain; join right-key vectors; joins with replicated
                   probes)
      fullsrc    — gathers whose POSITIONS are local but whose VALUES
                   index the full right frame of a join ('right' outputs):
                   source evaluates full-width, positions locally

    Raises NotDistributable for shapes the shard algebra cannot express.
    """
    scatters, replicate, fullsrc = {}, {}, {}
    loc_memo = {}

    def loc(v: V.Vexp) -> str:
        r = loc_memo.get(v.skey)
        if r is not None:
            return r
        vx = v.vx
        if v.skey in replicate:
            r = "R"
        elif isinstance(vx, V.Load):
            r = "L" if vx.name[0] == fact else "R"
        elif isinstance(vx, V.RangeC):
            r = "L" if vx.rcount == fact_count else "R"
        elif isinstance(vx, V.Shuffle) and vx.shop == V.GATHER:
            r = loc(vx.shpos)
        elif isinstance(vx, V.Shuffle) and vx.shop == V.SCATTER:
            r = ("L" if (vx.shshape is not None
                         and vx.shshape.info.count == fact_count) else "R")
        elif isinstance(vx, V.JoinIndex):
            r = loc(vx.lkeys)
        elif isinstance(vx, V.Fold):
            r = loc(vx.fdata)
        else:
            kids = _children(vx)
            r = "L" if any(loc(c) == "L" for c in kids) else "R"
        loc_memo[v.skey] = r
        return r

    seen = set()

    def walk(x: V.Vexp):
        if x.skey in seen:
            return
        seen.add(x.skey)
        vx = x.vx
        if isinstance(vx, V.SortPerm):
            raise NotDistributable("ordered aggregate stage")
        if isinstance(vx, V.Shuffle) and vx.shop == V.SCATTER:
            if (vx.shshape is not None
                    and vx.shshape.info.count == fact_count):
                # fact-domain mask scatter (Q4's exists marks): full-width
                # eval + per-shard window slice; subtree is full territory
                scatters[x.skey] = x
                return
            if loc(vx.shsource) == "L" or loc(vx.shpos) == "L":
                raise NotDistributable(
                    "scatter from shard-local rows into a replicated frame")
        if isinstance(vx, V.JoinIndex):
            if (vx.lkeys.skey, vx.rkeys.skey) in part_keys:
                # distributed shuffle join: BOTH sides are shard-local
                walk(vx.lkeys)
                walk(vx.rkeys)
                return
            if loc(vx.lkeys) == "R":
                # both sides replicated: the whole join is shard-invariant
                replicate[x.skey] = x
                return
            if vx.lkeys.info.count != fact_count:
                raise NotDistributable(
                    "join probes a derived local frame (not fact rows)")
            # local probe, full right side: rkeys evaluates at full width
            replicate[vx.rkeys.skey] = vx.rkeys
            walk(vx.lkeys)
            return
        if isinstance(vx, V.Shuffle) and vx.shop == V.GATHER:
            if x.skey in part_skip:
                # gather in a partitioned join's right-value composition:
                # its value comes from the exchange (payload column); its
                # chain sources are walked via part_roots
                return
            sl, pl = loc(vx.shsource), loc(vx.shpos)
            if sl == "L" and pl == "R":
                if vx.shsource.info.count != fact_count:
                    raise NotDistributable(
                        "replicated-frame positions index a derived local "
                        "frame")
                # Q4: lineitem-frame fk values into an orders-sized mask —
                # whole gather is replicated-frame
                replicate[x.skey] = x
                return
            if (sl == "L" and pl == "L"
                    and vx.shsource.info.count == fact_count
                    and _contains_right_join(vx.shpos)):
                # positions carry FULL right-frame ids (join 'right'
                # outputs): gather from the full-width source
                fullsrc[x.skey] = x
                walk(vx.shpos)
                return
        for c in _children(vx):
            walk(c)

    for f in folds:
        walk(f)
    for r in part_roots:  # partitioned joins' key/payload chains
        walk(r)
    # full-width columns: every fact column read under a full-eval region
    full_roots = [r for s in scatters.values()
                  for r in (s.vx.shsource, s.vx.shpos, s.vx.shshape)]
    full_roots += list(replicate.values())
    full_roots += [g.vx.shsource for g in fullsrc.values()]
    extra_full = sorted({nm for nm in _loads_under(*full_roots)
                         if nm[0] == fact})
    return scatters, replicate, fullsrc, extra_full, \
        [r for r in full_roots if r is not None]


def _loads_under(*roots: V.Vexp):
    """Every table column read anywhere under the given nodes."""
    seen, out = set(), []

    def go(x: V.Vexp):
        if x.skey in seen:
            return
        seen.add(x.skey)
        if isinstance(x.vx, V.Load):
            out.append(x.vx.name)
        for c in _children(x.vx):
            go(c)

    for r in roots:
        if r is not None:
            go(r)
    return out


def _positions(mask: torch.Tensor, n_out: int) -> torch.Tensor:
    """``n_out`` ascending positions of ``mask``'s true rows, zero tail (the
    compaction kernel); ``n_out`` may exceed the mask's length, since the
    capacities are maxima over the ranks and a rank's frame may be
    shorter."""
    n = mask.shape[0]
    sel = _sel_positions(mask, min(n_out, n))
    if n_out > n:
        sel = torch.cat([sel, sel.new_zeros(n_out - n)])
    return sel


class _ShardCompiler(Compiler):
    """Loads of the fact table yield this rank's row shard; dimension
    tables are replicated.  Fact-sized ranges size to the shard.

    ``local_valid`` is the rank's live row count, ``shard_tables`` maps
    column names to this rank's device tensors (fact columns: the rank's
    padded window; dimension columns: whole) and ``mesh`` carries the
    partitioned joins' collectives.  No fused-aggregate plan: the step
    reduces through ``segred``, as the JAX step does."""

    def __init__(self, store, device, local_valid, shard_tables, fact_count,
                 mesh=None):
        super().__init__(store, device)
        self.reset(shard_tables)
        self.local_valid = local_valid
        self.fact_count = fact_count
        self.mesh = mesh
        self.scatter_skeys = frozenset()
        self.replicate_skeys = frozenset()
        self.fullsrc_skeys = frozenset()
        self.full_tables = {}
        self.part_joins, self.part_pay, self.n_dev = {}, {}, 1
        self.part_arrays, self.part_meta = {}, {}
        self._shard_rows = self._start = self._padded = 0
        self._dim_cs = {}
        self._full_c = None

    def _full_eval(self, v: V.Vexp) -> Val:
        """Evaluate a node at full width from replicated inputs (identical
        on every rank) with a nested ordinary compiler."""
        if self._full_c is None:
            fc = Compiler(self.store, self.device)
            fc.reset(self.full_tables)
            self._full_c = fc
        return self._full_c._force(self._full_c.eval(v))

    def _full_width_window(self, v: V.Vexp) -> Val:
        """Full-width eval of a fact-domain-sized scatter, sliced to this
        rank's row window for fact-frame elementwise consumption."""
        full = self._full_eval(v)
        buf = torch.zeros(self._padded, dtype=full.data.dtype,
                          device=self.device)
        buf[:full.length] = full.data
        win = buf[self._start:self._start + self._shard_rows]
        return Val(data=_mask_tail(win, self.local_valid, self._shard_rows),
                   valid=self.local_valid, length=self._shard_rows)

    def _dim_c(self, tab: str) -> "_ShardCompiler":
        """Nested shard compiler over a PARTITIONED dim table's row shard:
        the build side of a dim-frame shuffle join (Q13's orders) — that
        table is never replicated.  Loads of ``tab`` read the local shard;
        other dim tables stay replicated; fact columns are unreachable
        (the classifier forbids them in dim-frame chains)."""
        dc = self._dim_cs.get(tab)
        if dc is None:
            t_count, srt = self.part_meta[tab]
            start = self.mesh.rank * srt
            lv = min(max(t_count - start, 0), srt)
            tables = dict(self.tables)
            tables.update({nm: a for nm, a in self.part_arrays.items()
                           if nm[0] == tab})
            dc = _ShardCompiler(self.store, self.device, lv, tables, t_count,
                                self.mesh)
            dc._shard_rows = srt
            dc._start = start
            dc._padded = srt * self.n_dev
            dc.n_dev = self.n_dev
            self._dim_cs[tab] = dc
        return dc

    def _keyed_local(self, vexp: V.Vexp, sent, loose: bool = False,
                     kdt=torch.int64):
        """Rank-local key vector for the shuffle join: invalid tail ->
        sentinel, rowid chains globalized (``loose`` also globalizes
        derived-frame position chains — distinctness-preserving payloads,
        see _frame_pos_chain).  ``kdt`` narrows exchange keys when the
        classifier proved the bounds fit."""
        skip = (set(self.part_pay) | self.fullsrc_skeys
                | self.replicate_skeys | self.scatter_skeys)
        og = None if _chain_through(vexp, skip) else \
            (_frame_pos_chain if loose else _rowid_chain)(
                vexp, self.fact_count)
        val = self._force(self.eval(vexp))
        data = val.data.to(torch.int64)
        if og:
            data = data + og * self._start
        idx = torch.arange(val.length, device=self.device)
        masked = torch.where(idx < val.valid, data,
                             torch.full((), sent, dtype=torch.int64,
                                        device=self.device))
        return masked.to(kdt)

    def _payload(self, spec) -> torch.Tensor:
        """One payload column, aligned with the local right frame: the
        gather-chain composition evaluated where all frames are local,
        then (for position-valued results) globalized by rstep*start."""
        chain = spec["chain"]
        val = self._force(self.eval(chain[0]))
        data = val.data
        for s in chain[1:]:
            sv = self._force(self.eval(s))
            data = sv.data[torch.clamp(data.to(torch.int64), 0,
                                       sv.length - 1)]
        og = (_frame_pos_chain if spec["loose"] else _rowid_chain)(
            chain[-1], self.fact_count)
        if og:
            data = data.to(torch.int64) + og * self._start
            if self.fact_count < 2**31:  # globalized positions stay int32
                data = data.to(torch.int32)
        return data

    def _part_join_art(self, key):
        """Run the distributed shuffle join for one (lkeys, rkeys) pair —
        once, shared by every side node and payload gather over it."""
        hit = self.join_cache.get(("part",) + key)
        if hit is not None:
            return hit
        dev = self.device
        pj = self.part_joins[key]
        caps = pj["caps"]
        rc = self._dim_c(pj["table"]) if pj["table"] else self
        kdt = torch.int32 if pj.get("k32") else torch.int64
        sent_r, sent_l = key_sents(kdt)
        lk = self._keyed_local(pj["lkeys"], sent_l, kdt=kdt)
        rk = rc._keyed_local(pj["rkeys"], sent_r, kdt=kdt)
        pays = [rc._payload(spec) for spec in pj["pays"]]
        hv = caps.get("heavy")
        r = shard_shuffle_join(
            lk, rk, pays, key_lo=pj["bounds"][0], key_hi=pj["bounds"][1],
            n_dev=self.n_dev, cap_r=caps["cap_r"], cap_l=caps["cap_l"],
            cap_pairs=caps["cap_pairs"],
            heavy_keys=(torch.as_tensor(hv["hk"], device=dev) if hv
                        else None),
            cap_hb=hv["cap_hb"] if hv else 0,
            cap_hp=hv["cap_hp"] if hv else 0, mesh=self.mesh)
        sel = _positions(r["pair_ok"], caps["cap_exp"]).to(torch.int64)
        npair = self._read(r["pair_ok"].sum(), "pair_total")
        lval = self._force(self.eval(pj["lkeys"]))
        art = dict(lidx=r["lidx"][sel], pays=[p[sel] for p in r["payloads"]],
                   cnt=r["cnt"], npair=npair, nl=lval.length,
                   lvalid=lval.valid, cap_exp=caps["cap_exp"],
                   cap_un=caps.get("cap_un", 0), outer=pj["outer"])
        if pj["outer"]:
            # this rank's unmatched probe rows, appended after its pairs
            # (the single-device outer layout, lower.py _eval_join_index)
            lmask = torch.arange(art["nl"], device=dev) < lval.valid
            un = (r["cnt"] == 0) & lmask
            art["un_sel"] = _positions(un, caps["cap_un"])
            art["n_un"] = self._read(un.sum(), "unmatched")
        self.join_cache[("part",) + key] = art
        return art

    def _outer_concat(self, art, pair_vals, un_vals):
        """[matched pairs | unmatched probe rows] prefix layout: pairs at
        0..npair, unmatched appended at npair..npair+n_un."""
        L = art["cap_exp"] + art["cap_un"]
        npair, n_un = art["npair"], art["n_un"]
        buf = torch.zeros(L, dtype=torch.int64, device=self.device)
        buf[:npair] = pair_vals[:npair].to(torch.int64)
        buf[npair:npair + n_un] = un_vals[:n_un].to(torch.int64)
        return buf, npair + n_un, L

    def _eval(self, v: V.Vexp):
        vx = v.vx
        dev = self.device
        if v.skey in self.scatter_skeys:
            return self._full_width_window(v)
        if v.skey in self.replicate_skeys:
            return self._full_eval(v)
        if v.skey in self.part_pay:
            # right-value gather of a partitioned join: the value arrived
            # as a payload column aligned with the local expansion rows
            key, i = self.part_pay[v.skey]
            art = self._part_join_art(key)
            dt = torch_dtype_for(v.info)
            if art["outer"]:  # unmatched rows carry null (0) right values
                zer = torch.zeros(art["cap_un"], dtype=torch.int64,
                                  device=dev)
                data, valid, L = self._outer_concat(art, art["pays"][i],
                                                    zer)
                return Val(data=_mask_tail(data.to(dt), valid, L),
                           valid=valid, length=L)
            data = _mask_tail(art["pays"][i].to(dt), art["npair"],
                              art["cap_exp"])
            return Val(data=data, valid=art["npair"],
                       length=art["cap_exp"])
        if (isinstance(vx, V.JoinIndex)
                and (vx.lkeys.skey, vx.rkeys.skey) in self.part_joins):
            key = (vx.lkeys.skey, vx.rkeys.skey)
            art = self._part_join_art(key)
            dt = torch_dtype_for(v.info)
            if vx.jside == V.JLEFT:
                data = _mask_tail(art["lidx"].to(dt), art["npair"],
                                  art["cap_exp"])
                return Val(data=data, valid=art["npair"],
                           length=art["cap_exp"])
            if vx.jside in (V.JSEMI, V.JANTI):
                lmask = torch.arange(art["nl"], device=dev) < art["lvalid"]
                has = art["cnt"] > 0
                keep = (has if vx.jside == V.JSEMI else ~has) & lmask
                sel = _sel_positions(keep, art["nl"])
                nz = keep.sum()
                return Val(data=_mask_tail(sel.to(dt), nz, art["nl"]),
                           valid=nz, length=art["nl"])
            if vx.jside == V.JOUTER_LEFT:
                data, valid, L = self._outer_concat(art, art["lidx"],
                                                    art["un_sel"])
                return Val(data=_mask_tail(data.to(dt), valid, L),
                           valid=valid, length=L)
            if vx.jside == V.JOUTER_VALID:
                ones = torch.ones(art["cap_exp"], dtype=torch.int64,
                                  device=dev)
                zer = torch.zeros(art["cap_un"], dtype=torch.int64,
                                  device=dev)
                data, valid, L = self._outer_concat(art, ones, zer)
                return Val(data=_mask_tail(data.to(dt), valid, L),
                           valid=valid, length=L)
            raise RuntimeError(
                f"partitioned join side {vx.jside} must be consumed "
                "through payload gathers")
        if v.skey in self.fullsrc_skeys:
            # positions are rank-local but their VALUES index the full
            # right frame of a join ('right' outputs): full-width source
            src = self._full_eval(vx.shsource)
            pos = self._force(self.eval(vx.shpos))
            dt = torch_dtype_for(v.info)
            p = torch.clamp(pos.data.to(torch.int64), 0, src.length - 1)
            data = _mask_tail(src.data[p].to(dt), pos.valid, pos.length)
            return Val(data=data, valid=pos.valid, length=pos.length)
        if isinstance(vx, V.Load):
            arr = self.tables[vx.name]
            n = arr.shape[-1]
            if v.info.count == self.fact_count:  # fact shard
                return Val(data=_mask_tail(arr, self.local_valid, n),
                           valid=self.local_valid, length=n)
            return Val(data=arr, valid=n, length=n)
        if isinstance(vx, V.RangeC) and vx.rcount == self.fact_count:
            # the fact table's row-id range sizes to the shard
            return Val(data=None, valid=self.local_valid,
                       length=self._shard_rows,
                       lazy_range=(vx.rmin, vx.rstep))
        if isinstance(vx, V.JoinIndex):
            # probe keys that are fact ROW POSITIONS (Q13 joins orders on
            # the customer rowid) evaluate locally; globalize them for the
            # probe only (the chain nodes keep their LOCAL values for
            # selection-composition uses elsewhere)
            og = _rowid_chain(vx.lkeys, self.fact_count)
            if og:
                lv = self._force(self.eval(vx.lkeys))
                data = lv.data + og * self._start
                prev = self.memo.get(vx.lkeys.skey)
                self.memo[vx.lkeys.skey] = Val(
                    data=_mask_tail(data.to(lv.data.dtype), lv.valid,
                                    lv.length),
                    valid=lv.valid, length=lv.length)
                try:
                    return super()._eval(v)
                finally:
                    self.memo[vx.lkeys.skey] = prev if prev is not None \
                        else lv
        return super()._eval(v)


def _rewrite_distinct_folds(vexps: List[V.Vexp]) -> List[V.Vexp]:
    """Decompose ``Fold(FDistinct, g, x)`` into the distributable
    groupby-of-groupby shape (MonetDB's own count(distinct) rewrite, the
    committed Q16 pattern): an inner stage grouped by the (group key,
    distinct values...) composite, then outer folds per group key.

    Because the shard algebra wants ONE shared innermost domain, every
    SIBLING fold on the same group key goes two-level as well — inner
    partial by the composite, outer combine over the inner frame
    (sum-of-sums, min-of-mins, choose-of-chooses; the FDistinct itself
    becomes an outer FDistinct over the per-composite value choices,
    where it deduplicates exactly).  Inner folds shard like any group-by
    (sparse composites ride the all_to_all shuffle-agg path); outer
    folds run in the host-side group stage, whose engine lowers
    FDistinct natively."""
    from .. import passes

    folds = _collect_folds(vexps)
    dists = [f for f in folds if f.vx.foldop == V.FDISTINCT]
    if not dists:
        return vexps
    fams = {}
    for d in dists:
        fams.setdefault(d.vx.fgroups.skey, []).append(d)
    plans = {}
    for gk, ds in fams.items():
        g = ds[0].vx.fgroups
        vals, seen = [], set()
        for d in ds:
            if d.vx.fdata.skey not in seen:
                seen.add(d.vx.fdata.skey)
                vals.append(d.vx.fdata)
        try:
            pair = g
            for vv in vals:
                pair = V.compose_keys(pair, vv)
        except AssertionError:
            raise NotDistributable(
                "count(distinct): composite (group, values) key exceeds "
                "the 64-bit budget")
        plans[gk] = V._group_ids(pair)

    def rule(vx):
        if not (isinstance(vx, V.Fold) and vx.foldop != V.FSEL):
            return None
        pids = plans.get(vx.fgroups.skey)
        if pids is None:
            return None
        base = V.complete(V.Fold(foldop=V.FCHOOSE, fgroups=pids,
                                 fdata=vx.fgroups, fmask=vx.fmask))
        outer_ids = V._group_ids(base)
        inner_op = V.FCHOOSE if vx.foldop == V.FDISTINCT else vx.foldop
        inner = V.complete(V.Fold(foldop=inner_op, fgroups=pids,
                                  fdata=vx.fdata, fmask=vx.fmask))
        return V.complete(V.Fold(foldop=vx.foldop, fgroups=outer_ids,
                                 fdata=inner))

    return passes.xform(rule, vexps)


class _Columns:
    """Store columns put on one device on first use, and kept there: the
    group stage's tables (it reads only the columns it reaches).  ``have``
    holds the columns already on the device whole."""

    def __init__(self, store: ColumnStore, device: torch.device, have):
        self.store, self.device, self._have = store, device, dict(have)

    def get(self, name, default=None):
        if name not in self.store.columns:
            return default
        hit = self._have.get(name)
        if hit is None:
            hit = self._have[name] = _to_device(self.store.columns[name],
                                                self.device)
        return hit

    def __getitem__(self, name):
        hit = self.get(name)
        if hit is None:
            raise KeyError(name)
        return hit


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(
        device)


def _segment_extreme(data: torch.Tensor, ids_ok: torch.Tensor, domain: int,
                     op: str) -> torch.Tensor:
    """[domain] maximum or minimum of ``data`` per id
    (``jax.ops.segment_max``/``segment_min``): rows whose id is ``domain``
    are left out, and empty ids hold the dtype's extremes."""
    info = torch.iinfo(data.dtype)
    out = torch.full((domain + 1,), info.min if op == "max" else info.max,
                     dtype=data.dtype, device=data.device)
    out.scatter_reduce_(0, ids_ok, data, "amax" if op == "max" else "amin")
    return out[:domain]


_COMBINE = {"sum": dist.psum, "max": dist.pmax, "min": dist.pmin}


@dataclass
class AutoDistributed:
    """A qualifying plan compiled for the mesh.  Every rank of ``mesh``
    builds it from the same plan and store, and every rank calls it."""

    cfg: Config
    store: ColumnStore
    vexps: List[V.Vexp]
    mesh: dist.Mesh

    def __post_init__(self):
        self._plan()
        # every rank decided the same from the same plan; from here on the
        # ranks exchange data
        self._put_inputs()
        # the group stage reads store columns at full width: it starts
        # from those this rank holds whole (every window is whole at world
        # size 1)
        whole = dict(self._full_arrays)
        if self.shard_rows == self.fact_count:
            whole.update(self._fact_arrays)
        whole.update({nm: a for nm, a in self._part_arrays.items()
                      if self.part_meta[nm[0]][0] == a.shape[0]})
        self._group_tables = _Columns(self.store, self.mesh.device, whole)
        if self.part_joins:
            c = self._shard_compiler()
            for pj in self.part_joins.values():  # classifier post-order
                if pj["caps"] is None:
                    pj["caps"] = self._part_join_caps(c, pj)

    def _plan(self):
        """The host-side analysis (identical on every rank, no data moved):
        classify the plan, raise ``NotDistributable`` for what the shard
        algebra cannot express, and plan the partitioned joins, the
        full-width regions and the row-id globalization."""
        self.vexps = _rewrite_distinct_folds(self.vexps)
        folds = _collect_folds(self.vexps)
        # ROWSET mode (VERDICT r4 item 4): plans with no aggregate stage
        # (pure select/project/join) distribute too — every output column
        # evaluates rank-locally over the row-sharded fact, and the edge
        # concatenates each rank's valid prefix in rank order (row frames
        # follow fact row order, so this IS the single-device row order).
        # The planning machinery below is root-agnostic: rowset mode plans
        # against the output vexps instead of folds.
        self.rowset = not folds
        if self.rowset:
            terminals = list(self.vexps)
            if not terminals:
                raise NotDistributable("empty plan")
            tcounts = {t.info.count for t in terminals}
            if len(tcounts) != 1:
                raise NotDistributable(
                    "rowset outputs on differing row frames")
            g0 = None
            domain = 1
            self.sparse = False
            multi = []
            roots = terminals
        else:
            roots = folds
        if folds:
            # single-group folds (bounds (0,0): global sums like Q11's
            # having threshold) coexist with one shared multi-group key;
            # they reduce into slot 0 of the shared domain and seed a
            # 1-row group frame
            multi = [f for f in folds if f.vx.fgroups.info.bounds != (0, 0)]
            g0 = (multi or folds)[0].vx.fgroups
            domain = g0.info.bounds[1] + 1
            self.sparse = domain > (1 << 20)
        same_keys = all(f.vx.fgroups.skey == g0.skey for f in multi)
        # differing key EXPRESSIONS are fine when every fold maps rows into
        # the same dense domain (Q12: the predicated fold keeps raw masked
        # groups while unpredicated folds group compacted rows) — the
        # per-fold occupancy vectors are cross-checked at run time
        self._check_occ = len(multi) > 0 and not same_keys
        if self._check_occ and (
                self.sparse or any(f.vx.fgroups.info.bounds != g0.info.bounds
                                   for f in multi)):
            raise NotDistributable("aggregates use different group keys")
        if self.sparse and (len(multi) != len(folds) or not same_keys):
            raise NotDistributable(
                "sparse group-by with heterogeneous fold keys")
        if folds and any(
                f.vx.fgroups.info.count != folds[0].vx.fgroups.info.count
                for f in folds):
            raise NotDistributable("folds on different row frames")
        if self.sparse:
            # the shuffle path combines every fold through one exchange, so
            # all folds must share the same row validity
            masks = {f.vx.fmask.skey if f.vx.fmask is not None else None
                     for f in folds}
            if len(masks) != 1:
                raise NotDistributable(
                    "sparse group-by with differing fold masks")
        # the fact table carries the plan's row axis: its row count equals
        # the fold input length bound (rowset mode: the output row bound);
        # when the row frame is a JOIN EXPANSION (Q13/Q17/Q2), the probe
        # (left) side of that join
        row_axis = (folds[0].vx.fgroups.info.count if folds
                    else roots[0].info.count)
        loads = sorted({nm for f in roots for nm in _loads_under(f)})
        tabs = {nm[0] for nm in loads}
        if not tabs:
            raise NotDistributable("aggregate stage reads no table")
        joins = [x for f in roots for x in _joins_under(f)]
        facts = {t for t in tabs
                 if self.store.table_count((t,)) == row_axis}
        fact_count = row_axis
        if not facts and joins:
            probes = {x.vx.lkeys.info.count for x in joins
                      if x.info.count == row_axis}
            if len(probes) == 1:
                fact_count = next(iter(probes))
                facts = {t for t in tabs
                         if self.store.table_count((t,)) == fact_count}
        if len(facts) != 1:
            raise NotDistributable(
                f"cannot identify a unique fact table among {tabs}")
        self.fact = next(iter(facts))
        self.fact_count = fact_count
        self.folds = folds
        self.domain = domain

        # fact-frame right sides run as distributed shuffle joins (hash-
        # partitioned build + probe routing) instead of replicating the
        # right side; MPLAN2VDL_NO_PART_JOIN=1 forces the replicated path
        part_joins, part_pay = {}, {}
        part_skip, part_roots = frozenset(), ()
        if joins and not self.sparse and os.environ.get(
                "MPLAN2VDL_NO_PART_JOIN", "0") in ("", "0"):
            part_joins, part_pay, part_skip, part_roots = _plan_part_joins(
                roots, self.fact, fact_count, self.store)
        self.part_joins, self.part_pay = part_joins, part_pay

        scatters, replicate, fullsrc, extra_full, _ = _plan_regions(
            roots, self.fact, fact_count, frozenset(part_joins),
            frozenset(part_skip), tuple(part_roots))
        if scatters and self.sparse:
            raise NotDistributable(
                "fact-domain scatter in a sparse group-by")
        if joins and self.sparse and os.environ.get(
                "MPLAN2VDL_NO_SPARSE_JOIN", "0") not in ("", "0"):
            # equijoins inside sparse group-bys compose with the
            # shuffle-aggregation exchange (rank-local probes against the
            # replicated right side feed locally pre-aggregated partials
            # into the all_to_all); opt-out flag only
            raise NotDistributable("equijoin in a sparse group-by")

        n = self.fact_count
        n_dev = self.mesh.size
        self.shard_rows = -(-n // n_dev)
        self.padded = self.shard_rows * n_dev
        self.loads = loads
        self.fact_loads = [nm for nm in self.loads if nm[0] == self.fact]
        # partitioned dim tables ship SHARDED; drop their replicated
        # copies unless a non-part region still reads them
        part_tabs = {pj["table"] for pj in part_joins.values()
                     if pj["table"]}
        outside = set(_loads_outside_part(
            roots, frozenset(part_joins), frozenset(part_skip))) \
            if part_tabs else set()
        self.part_loads = sorted({nm for nm in self.loads
                                  if nm[0] in part_tabs})
        self.part_meta = {
            pj["table"]: (pj["t_count"], -(-pj["t_count"] // n_dev))
            for pj in part_joins.values() if pj["table"]}
        self.dim_loads = [nm for nm in self.loads
                          if nm[0] != self.fact
                          and (nm[0] not in part_tabs or nm in outside)]
        self.extra_full = extra_full
        self.scatter_skeys = frozenset(scatters)
        self.replicate_skeys = frozenset(replicate)
        self.fullsrc_skeys = frozenset(fullsrc)
        self.per_owner = -(-domain // n_dev)
        self.cap = 2 * (self.shard_rows // n_dev) + 64
        self._cap_retries = 0

        # fold-boundary row-id handling: rank-local evaluation yields LOCAL
        # row positions for rowid-derived chains; the step adds
        # rstep*shard_start.  Representative-row FChoose (single-device
        # takes the FIRST row in row order) combines with min over the
        # globalized ids.  Row ids leaking through unrecognized shapes
        # (composite bit-packs) disqualify.
        # nodes whose VALUES are already global on every rank: full-width
        # evaluations (scatter windows, replicated frames, fullsrc gather
        # sources) and partitioned-join payload gathers (globalized at the
        # exchange) — position chains passing through them must NOT get a
        # second rstep*shard_start
        global_vals = frozenset(self.scatter_skeys | self.replicate_skeys
                                | self.fullsrc_skeys | set(part_pay))
        off_g, off_d = [], []
        for f in folds:
            # group keys are a DISTINCTNESS context: derived-frame position
            # chains globalize too (full-width frames are global already)
            full_g = _chain_through(f.vx.fgroups, global_vals)
            og = None if full_g else _frame_pos_chain(f.vx.fgroups,
                                                      fact_count)
            if og is None and not full_g and _rowid_leaks(
                    f.vx.fgroups, fact_count):
                raise NotDistributable("row-id values leak into group keys")
            od = None if _chain_through(f.vx.fdata, global_vals) \
                else _rowid_chain(f.vx.fdata, fact_count)
            if od is None and _rowid_leaks(f.vx.fdata, fact_count):
                raise NotDistributable("row-id values leak into fold data")
            if f.vx.fmask is not None and _rowid_leaks(
                    f.vx.fmask, fact_count, allow_chain=False):
                raise NotDistributable("row-id values inside a fold mask")
            off_g.append(og)
            off_d.append(od)
        self.off_g, self.off_d = tuple(off_g), tuple(off_d)
        rowid = tuple(od is not None and f.vx.foldop == V.FCHOOSE
                      for f, od in zip(folds, self.off_d))
        # FCHOOSE's contract is "any value of the group" (Vlite.hs:116);
        # the distributed combine uses max, which may pick a different
        # (equally valid) representative than single-device first-row
        # order when the chosen column is not functionally dependent on
        # the group key.  TPC-H FChoose columns are FD on the key, so
        # outputs still match; row-id chains combine with min to preserve
        # first-row semantics.
        self.fold_ops = tuple(
            "min" if rid else {V.FSUM: "sum", V.FMAX: "max", V.FMIN: "min",
                               V.FCHOOSE: "max"}[f.vx.foldop]
            for f, rid in zip(folds, rowid))

        # rowset mode: per-output row-id globalization multipliers (same
        # chain rules as fold data — local row positions get
        # rstep*shard_start at the output boundary)
        off_t = []
        for t in (self.vexps if self.rowset else ()):
            ot = None if _chain_through(t, global_vals) \
                else _rowid_chain(t, fact_count)
            if ot is None and _rowid_leaks(t, fact_count):
                raise NotDistributable("row-id values leak into outputs")
            off_t.append(ot)
        self.off_t = tuple(off_t)

    # ------------------------------------------------------------- inputs
    def _put_inputs(self):
        """This rank's device tensors, built once: the fact columns' row
        window, each partitioned dim table's window, and the replicated
        columns whole."""
        dev, rank = self.mesh.device, self.mesh.rank
        cols = self.store.columns
        self._fact_arrays = {
            nm: dist.shard_window(self.mesh, cols[nm], self.shard_rows)
            for nm in self.fact_loads}
        self._part_arrays = {
            nm: dist.shard_window(self.mesh, cols[nm],
                                  self.part_meta[nm[0]][1])
            for nm in self.part_loads}
        self._full_arrays = {nm: _to_device(cols[nm], dev)
                             for nm in self.dim_loads + self.extra_full}
        self._start = rank * self.shard_rows
        self._local_valid = min(max(self.fact_count - self._start, 0),
                                self.shard_rows)

    def _shard_compiler(self) -> _ShardCompiler:
        local = dict(self._fact_arrays)
        local.update({nm: self._full_arrays[nm] for nm in self.dim_loads})
        c = _ShardCompiler(self.store, self.mesh.device, self._local_valid,
                           local, self.fact_count, self.mesh)
        c._shard_rows = self.shard_rows
        c.scatter_skeys = self.scatter_skeys
        c.replicate_skeys = self.replicate_skeys
        c.fullsrc_skeys = self.fullsrc_skeys
        c.full_tables = self._full_arrays
        c._start = self._start
        c._padded = self.padded
        c.part_joins = self.part_joins
        c.part_pay = self.part_pay
        c.n_dev = self.mesh.size
        c.part_arrays = self._part_arrays
        c.part_meta = self.part_meta
        return c

    # ----------------------------------------------------------- capacities
    def _part_join_caps(self, c: _ShardCompiler, pj) -> dict:
        """Two counting rounds -> EXACT exchange capacities: round A =
        per-destination histograms of both key vectors (cap_l/cap_r);
        round B = the exchange itself, counts only (cap_pairs = largest
        (owner, source-rank) match block, cap_exp = largest per-probe-rank
        expansion).  Round 0 detects heavy keys first."""
        mesh, n_dev = self.mesh, self.mesh.size
        lk_v, rk_v, tab_ = pj["lkeys"], pj["rkeys"], pj["table"]
        klo, khi = pj["bounds"]
        kdt = torch.int32 if pj.get("k32") else torch.int64
        sent_r_, sent_l_ = key_sents(kdt)
        rc = c._dim_c(tab_) if tab_ else c
        lk = c._keyed_local(lk_v, sent_l_, kdt=kdt)
        rk = rc._keyed_local(rk_v, sent_r_, kdt=kdt)

        # round 0: heavy-hitter detection (skew-aware repartitioning).
        # Heavy keys leave the exchange — their build rows broadcast,
        # their probes match locally — so the exact capacities below stay
        # at uniform-keys size under skew.
        heavy = None
        hk_, rcnt_, nh_, chb_, chp_ = shard_heavy_detect(lk, rk, n_dev,
                                                         mesh=mesh)
        if int(nh_) > 0:
            heavy = dict(hk=hk_.cpu().numpy(), rcnt=rcnt_.cpu().numpy(),
                         cap_hb=max(int(chb_), 1), cap_hp=max(int(chp_), 1))
        hk_c = (torch.as_tensor(heavy["hk"], device=mesh.device)
                if heavy else None)
        rcnt_c = (torch.as_tensor(heavy["rcnt"], device=mesh.device)
                  if heavy else None)

        def mask_heavy(keys, sent):
            if hk_c is None:
                return keys
            _, hit = _member_lohi(keys, hk_c)
            return torch.where(hit, torch.full((), sent, dtype=keys.dtype,
                                               device=keys.device), keys)

        hl = dest_histogram(owner_dest(mask_heavy(lk, sent_l_), klo, khi,
                                       n_dev), n_dev)
        hr = dest_histogram(owner_dest(mask_heavy(rk, sent_r_), klo, khi,
                                       n_dev), n_dev)
        cap_l = max(int(dist.pmax(mesh, hl).max()), 1)
        cap_r = max(int(dist.pmax(mesh, hr).max()), 1)

        cap_pairs, cap_exp, cap_un, total, total_un, ovf = (
            int(x) for x in shard_join_count_stats(
                lk, rk, key_lo=klo, key_hi=khi, n_dev=n_dev, cap_r=cap_r,
                cap_l=cap_l, heavy_keys=hk_c, heavy_rcnt=rcnt_c, mesh=mesh))
        assert ovf == 0, "exact-capacity exchange overflowed"
        return dict(cap_l=cap_l, cap_r=cap_r,
                    cap_pairs=max(cap_pairs, 1),
                    cap_exp=max(cap_exp, 1),
                    cap_un=max(cap_un, 1) if pj["outer"] else 0,
                    heavy=heavy,
                    total=total + (total_un if pj["outer"] else 0))

    # ---------------------------------------------------------------- steps
    def _fold_rows(self, c, f, og):
        """(group ids int64, valid rows, row count) of one fold's input on
        this rank; row-id keys globalized."""
        vx = f.vx
        g = c._force(c.eval(vx.fgroups))
        nloc = g.length
        valid = torch.arange(nloc, device=c.device) < g.valid
        if vx.fmask is not None:
            m = c._force(c.eval(vx.fmask))
            valid = valid & (m.data[:nloc] != 0)
        gids = g.data.to(torch.int64)
        if og:
            gids = gids + og * c._start  # globalize row-id keys
        return gids, valid, nloc

    def _fold_data(self, c, f, od, nloc):
        d = c._force(c.eval(f.vx.fdata))
        dt = torch_dtype_for(f.info)
        data = d.data[:nloc].to(dt)
        if od:
            data = data + od * c._start
        return data

    def _sparse_step(self, c):
        """Local pre-aggregation, the all_to_all to each key's owner and
        the owner combine (``shard_shuffle_combine``), for every fold in
        one exchange.  Returns this rank's owner keys and values, and the
        overflow count summed over the ranks."""
        gk0, valid, nloc = self._fold_rows(c, self.folds[0], self.off_g[0])
        keys = torch.where(valid, gk0, _SENT)
        vals = [self._fold_data(c, f, od, nloc)
                for f, od in zip(self.folds, self.off_d)]
        # a frame longer than the shard (a join expansion) may hold more
        # local groups than shard_rows
        gk, gvals, overflow = shard_shuffle_combine(
            keys, vals, self.fold_ops, max(self.shard_rows, nloc),
            self.mesh.size, self.per_owner, self.cap, self.mesh)
        return gk, gvals, int(dist.psum(self.mesh, overflow))

    def _dense_step(self, c):
        """Each fold's dense per-domain partial on this rank, combined over
        the ranks (sum/max/min all-reduce), and each fold's occupancy
        (rows per group id) summed over the ranks."""
        domain = self.domain
        outs, occ_locals = [], []
        for f, opname, og, od in zip(self.folds, self.fold_ops, self.off_g,
                                     self.off_d):
            gids, valid, nloc = self._fold_rows(c, f, og)
            ids = torch.clamp(gids, 0, domain - 1)
            ids_ok = torch.where(valid, ids, domain)
            data = self._fold_data(c, f, od, nloc)
            if domain <= segred.SMALL_DOMAIN:
                dense, occ_local = segred.masked_group_reduce_with_counts(
                    data, ids_ok, domain, opname)
            else:
                # one sort of the ids gives the counts, and the sums as
                # prefix-sum differences (wrapping as segment_sum does)
                sums, occ_local = dist.dense_sums(
                    [data] if opname == "sum" else [], ids_ok, domain)
                dense = (sums[0].to(data.dtype) if sums else
                         _segment_extreme(data, ids_ok, domain, opname))
            # widen before the cross-rank sum: per-rank counts fit int32,
            # global totals may not
            occ_locals.append(occ_local.to(torch.int64))
            outs.append(_COMBINE[opname](self.mesh, dense))
        return outs, [dist.psum(self.mesh, o) for o in occ_locals]

    def _rowset_step(self, c):
        """Each output's valid prefix on this rank (row ids globalized),
        gathered from every rank in rank order."""
        cols = []
        for t, ot in zip(self.vexps, self.off_t):
            val = c._force(c.eval(t))
            d = val.data
            if ot:
                d = d + ot * c._start
            keep = torch.arange(d.shape[0], device=d.device) < val.valid
            rows, = dist.all_gather_rows(self.mesh, [d], keep)
            cols.append((t.name, t.info.dtype, rows))
        return cols

    def __call__(self):
        """Run the plan on this rank; every rank returns the same
        ``(name, dtype, rows)`` list."""
        c = self._shard_compiler()
        if self.rowset:
            return self._rowset_step(c)
        g = Compiler(self.store, self.mesh.device)
        # the group-level stage may gather representative columns through
        # fold-produced masks (Q10's key outputs); it reads store columns
        # at full width, put on the device as it reaches them
        g.reset(self._group_tables)
        dev = self.mesh.device
        if self.sparse:
            while True:
                gk, gvals, overflow = self._sparse_step(c)
                if not overflow:
                    break
                # skew: some owner received more partials than the bucket
                # capacity; every rank doubles it (the sum is the same on
                # all of them) and runs the step again (bounded retries)
                if self._cap_retries >= 3:
                    raise RuntimeError(
                        f"shuffle bucket overflow ({overflow} partials) "
                        "after capacity retries — key distribution is "
                        "pathologically skewed")
                self._cap_retries += 1
                self.cap = self.cap * 2
            # each owner's live rows, in rank order (the owners' key
            # ranges ascend with the rank), stay on the device
            live = dist.all_gather_rows(self.mesh, gvals, gk < _SENT,
                                        host=False)
            ngroups = live[0].shape[0] if live else 0
            n_slots = self.mesh.size * self.mesh.size * self.cap
            for f, flat in zip(self.folds, live):
                L_out = min(f.info.count, n_slots)
                buf = torch.zeros(L_out, dtype=flat.dtype, device=dev)
                k = min(ngroups, L_out)
                buf[:k] = flat[:k]
                g.memo[f.skey] = Val(data=buf, valid=ngroups, length=L_out)
        else:
            dense_list, occ_list = self._dense_step(c)
            if self._check_occ:
                # folds used different key expressions over the same dense
                # domain: sound only if they agree on which groups exist
                pats = [o > 0 for f, o in zip(self.folds, occ_list)
                        if f.vx.fgroups.info.bounds != (0, 0)]
                if any(not torch.equal(pats[0], p) for p in pats[1:]):
                    raise NotDistributable(
                        "folds disagree on occupied groups")
            for f, dense, occ in zip(self.folds, dense_list, occ_list):
                sel = torch.nonzero(occ > 0).reshape(-1)
                ngroups = sel.shape[0]
                L_out = min(self.domain, f.info.count)
                buf = torch.zeros(L_out, dtype=dense.dtype, device=dev)
                take = dense[sel[:L_out]]
                buf[:take.shape[0]] = take
                g.memo[f.skey] = Val(data=buf, valid=ngroups, length=L_out)
        del c
        vals = [g._force(g.eval(v)) for v in self.vexps]
        cols = []
        for v, val in zip(self.vexps, vals):
            nv = int(val.valid)
            cols.append((v.name, v.info.dtype, val.data[:nv].cpu().numpy()))
        return cols

    def describe(self) -> str:
        """Human-readable distribution plan (SURVEY §5 observability):
        what shards, what replicates, which joins exchange."""
        n_dev = self.mesh.size
        lines = [f"fact table: {self.fact} ({self.fact_count} rows, "
                 f"{self.shard_rows} rows/shard x {n_dev} shards)"]
        lines.append("sharded fact columns: "
                     + ", ".join(nm[1] for nm in self.fact_loads))
        if self.part_loads:
            lines.append("sharded (partitioned-join) dim columns: "
                         + ", ".join(f"{nm[0]}.{nm[1]}"
                                     for nm in self.part_loads))
        if self.dim_loads:
            lines.append("replicated dim columns: "
                         + ", ".join(f"{nm[0]}.{nm[1]}"
                                     for nm in self.dim_loads))
        if self.extra_full:
            lines.append("replicated fact columns (full-width regions): "
                         + ", ".join(nm[1] for nm in self.extra_full))
        for key, pj in self.part_joins.items():
            caps = pj["caps"] or {}
            lines.append(
                f"partitioned shuffle join {key}: "
                f"right={'fact frame' if pj['table'] is None else pj['table']}"
                f"{' OUTER' if pj['outer'] else ''}"
                f" keys={'int32' if pj.get('k32') else 'int64'}"
                f" pairs={caps.get('total', '?')}"
                f" caps(l/r/pairs/exp)={caps.get('cap_l', '?')}/"
                f"{caps.get('cap_r', '?')}/{caps.get('cap_pairs', '?')}/"
                f"{caps.get('cap_exp', '?')}")
        lines.append(f"group domain: {self.domain} "
                     f"({'sparse all_to_all shuffle' if self.sparse else 'dense psum partials'}), "
                     f"{len(self.folds)} distributed fold(s)")
        return "\n".join(lines)

    def result(self):
        """Run and wrap the output like the single-device engine's
        ``QueryResult`` (same decoding / printing surface)."""
        cols = self()
        return QueryResult(names=[nm for nm, _, _ in cols],
                           dtypes=[dt for _, dt, _ in cols],
                           columns=[c for _, _, c in cols])


def distribute(cfg: Config, store: ColumnStore, vexps: List[V.Vexp],
               mesh: dist.Mesh) -> AutoDistributed:
    return AutoDistributed(cfg=cfg, store=store, vexps=vexps, mesh=mesh)
