"""VIR rewrite passes (reference Vlite.hs:1292-1417).

The pass engine is a bottom-up memoized rewriter that preserves top-level
output names.  Passes:

* redundant_range  — RangeV-of-RangeV collapse (Vlite.hs:1295-1299)
* algebraic_identities — x&x=x, x|x=x, x&0=0, x|0=x, shift-by-0, zero-shift,
  gather/scatter by an identity range (Vlite.hs:1301-1330)
* lowering — Max/Min/Neq into compare+arith combos (Vlite.hs:1332-1340).
  The TPU engine implements Min/Max/Neq natively, so this pass exists for
  VDL-conformance emission only and is *off* in the engine pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from . import mplan as M
from .vir import (Binop, CrossProduct, DictMap, Fold, GATHER, JoinIndex, Like, Load,
                  Partition, RangeC, RangeV, SCATTER, Semisort, Shuffle,
                  SortPerm, Vexp, VShuffle, Vx, complete, eq_, gt_,
                  if_then_else, lt_, ones_, sub_)

Rule = Callable[[Vx], Optional[Vexp]]


def _is_const_range(v: Vexp, val: int) -> bool:
    return isinstance(v.vx, RangeV) and v.vx.rmin == val and v.vx.rstep == 0


def redundant_range(vx: Vx) -> Optional[Vexp]:
    if isinstance(vx, RangeV) and isinstance(vx.rref.vx, RangeV):
        return complete(RangeV(rmin=vx.rmin, rstep=vx.rstep,
                               rref=vx.rref.vx.rref))
    return None


def algebraic_identities(vx: Vx) -> Optional[Vexp]:
    if isinstance(vx, Binop):
        op, l, r = vx.binop, vx.left, vx.right
        if op in (M.BITAND, M.BITOR) and l == r:
            return l
        if op == M.BITAND and _is_const_range(l, 0):
            return l
        if op == M.BITAND and _is_const_range(r, 0):
            return r
        if op == M.BITOR and _is_const_range(l, 0):
            return r
        if op == M.BITOR and _is_const_range(r, 0):
            return l
        if op == M.BITSHIFT and _is_const_range(l, 0):
            return l  # zeros stay constant
        if op == M.BITSHIFT and _is_const_range(r, 0):
            return l  # no-op shift
    if isinstance(vx, Shuffle) and vx.shop == SCATTER:
        p = vx.shpos.vx
        if isinstance(p, RangeV) and p.rmin == 0 and p.rstep == 1:
            return vx.shsource
    if isinstance(vx, Shuffle) and vx.shop == GATHER:
        p = vx.shpos.vx
        if (isinstance(p, RangeV) and p.rmin == 0 and p.rstep == 1
                and p.rref == vx.shsource):
            return vx.shsource
    return None


def lowering(vx: Vx) -> Optional[Vexp]:
    if isinstance(vx, Binop):
        op, l, r = vx.binop, vx.left, vx.right
        if op == M.MAX:
            return if_then_else(gt_(l, r), l, r)
        if op == M.MIN:
            return if_then_else(lt_(l, r), l, r)
        if op == M.NEQ:
            return sub_(ones_(l), eq_(l, r))
    return None


def _transform(rule: Rule, v: Vexp, memo: Dict[int, Vexp]) -> Vexp:
    """Vlite.hs:1358-1417, memoized on the structural key."""
    hit = memo.get(v.skey)
    if hit is not None:
        if v.name is not None and hit.name != v.name:
            hit = hit.with_(name=v.name)
        return hit

    vx = v.vx
    if isinstance(vx, Load):
        ans = v  # metadata for Load needs the catalog; keep node intact
    else:
        rec = lambda c: _transform(rule, c, memo)
        if isinstance(vx, CrossProduct):
            new = CrossProduct(left=rec(vx.left), right=rec(vx.right),
                               variant=vx.variant)
        elif isinstance(vx, RangeC):
            new = vx
        elif isinstance(vx, Semisort):
            new = Semisort(sdata=rec(vx.sdata))
        elif isinstance(vx, SortPerm):
            new = SortPerm(keys=tuple(rec(k) for k in vx.keys),
                           descs=vx.descs)
        elif isinstance(vx, RangeV):
            new = RangeV(rmin=vx.rmin, rstep=vx.rstep, rref=rec(vx.rref))
        elif isinstance(vx, Binop):
            new = Binop(binop=vx.binop, left=rec(vx.left), right=rec(vx.right))
        elif isinstance(vx, Shuffle):
            new = Shuffle(shop=vx.shop, shsource=rec(vx.shsource),
                          shpos=rec(vx.shpos),
                          shshape=rec(vx.shshape) if vx.shshape else None)
        elif isinstance(vx, Fold):
            new = Fold(foldop=vx.foldop, fgroups=rec(vx.fgroups),
                       fdata=rec(vx.fdata),
                       fmask=rec(vx.fmask) if vx.fmask is not None else None)
        elif isinstance(vx, Partition):
            new = Partition(pivots=rec(vx.pivots), pdata=rec(vx.pdata))
        elif isinstance(vx, Like):
            new = Like(ldata=rec(vx.ldata), lpattern=vx.lpattern,
                       lcol=vx.lcol)
        elif isinstance(vx, DictMap):
            new = DictMap(ldata=rec(vx.ldata), lcol=vx.lcol,
                          mapping=vx.mapping, derived=vx.derived)
        elif isinstance(vx, VShuffle):
            new = VShuffle(varg=rec(vx.varg))
        elif isinstance(vx, JoinIndex):
            new = JoinIndex(lkeys=rec(vx.lkeys), rkeys=rec(vx.rkeys),
                            jside=vx.jside)
        else:
            raise TypeError(vx)
        fired = rule(new)
        anon = complete(new) if fired is None else fired
        # preserve name/comment/info across the rewrite (Vlite.hs:1365)
        ans = anon.with_(name=v.name, comment=v.comment, info=v.info)
    memo[v.skey] = ans
    return ans


def xform(rule: Rule, vexps: List[Vexp]) -> List[Vexp]:
    """Apply a rule to a DAG, preserving top-level names (Vlite.hs:1351-1356)."""
    memo: Dict[int, Vexp] = {}
    out = []
    for v in vexps:
        new = _transform(rule, v, memo)
        out.append(new.with_(name=v.name))
    return out


def redundant_range_pass(vs: List[Vexp]) -> List[Vexp]:
    return xform(redundant_range, vs)


def algebraic_identities_pass(vs: List[Vexp]) -> List[Vexp]:
    return xform(algebraic_identities, vs)


def lowering_pass(vs: List[Vexp]) -> List[Vexp]:
    return xform(lowering, vs)


# --------------------------------------------------------------- predication
def _fsel_pos(v: Vexp) -> bool:
    return isinstance(v.vx, Fold) and v.vx.foldop == "FSel"


def _ungather(v: Vexp, pos_skey: int, pos_src_len_ref: Vexp):
    """Rewrite an elementwise tree over ``gather(X, sel)`` leaves into the
    same tree over the unfiltered ``X`` (None when the tree reads anything
    else).  Constants sized by a gathered vector re-size to the source."""
    vx = v.vx
    if isinstance(vx, Shuffle) and vx.shop == GATHER \
            and vx.shpos.skey == pos_skey:
        return vx.shsource
    if isinstance(vx, RangeV):
        inner = _ungather(vx.rref, pos_skey, pos_src_len_ref)
        if inner is None:
            return None
        return complete(RangeV(rmin=vx.rmin, rstep=vx.rstep, rref=inner))
    if isinstance(vx, Binop):
        l = _ungather(vx.left, pos_skey, pos_src_len_ref)
        r = _ungather(vx.right, pos_skey, pos_src_len_ref)
        if l is None or r is None:
            return None
        return complete(Binop(binop=vx.binop, left=l, right=r))
    if isinstance(vx, Partition):
        inner = _ungather(vx.pdata, pos_skey, pos_src_len_ref)
        if inner is None:
            return None
        return complete(Partition(pivots=vx.pivots, pdata=inner))
    if isinstance(vx, (Like, DictMap)):
        inner = _ungather(vx.ldata, pos_skey, pos_src_len_ref)
        if inner is None:
            return None
        return complete(type(vx)(**{**{f.name: getattr(vx, f.name)
                                       for f in __import__("dataclasses").fields(vx)},
                                    "ldata": inner}))
    if isinstance(vx, Shuffle) and vx.shop == SCATTER:
        # join-mask scatter whose TARGET is the compacted frame: its
        # positions are compacted ranks routed through the rank map
        # ``scatter(range_over(sel), sel)`` (deduce_masks' FK mask algebra,
        # Vlite.hs:1248-1282).  Retarget to the RAW frame by scattering at
        # the pre-rank positions.  Sound because the caller ANDs the
        # result with the compaction predicate ``b``: writes that land on
        # raw rows outside the selection are masked back off.
        p = vx.shpos
        if (isinstance(p.vx, Shuffle) and p.vx.shop == GATHER
                and isinstance(p.vx.shsource.vx, Shuffle)
                and p.vx.shsource.vx.shop == SCATTER
                and isinstance(p.vx.shsource.vx.shsource.vx, RangeV)
                and p.vx.shsource.vx.shsource.vx.rmin == 0
                and p.vx.shsource.vx.shsource.vx.rstep == 1
                and _subtree_has(p.vx.shsource.vx.shpos, pos_skey)):
            return complete(Shuffle(shop=SCATTER, shsource=vx.shsource,
                                    shpos=p.vx.shpos,
                                    shshape=pos_src_len_ref))
    return None


def _subtree_has(v: Vexp, skey: int, _seen=None) -> bool:
    if _seen is None:
        _seen = set()
    if v.skey in _seen:
        return False
    _seen.add(v.skey)
    if v.skey == skey:
        return True
    kids = [getattr(v.vx, f.name) for f in dataclasses.fields(v.vx)
            if isinstance(getattr(v.vx, f.name), Vexp)]
    if isinstance(v.vx, SortPerm):
        kids += list(v.vx.keys)
    return any(_subtree_has(c, skey, _seen) for c in kids)


def _find_fsel_gather(v: Vexp):
    """First gather-through-FSel leaf in an elementwise tree."""
    vx = v.vx
    if isinstance(vx, Shuffle) and vx.shop == GATHER and _fsel_pos(vx.shpos):
        return vx.shpos
    if isinstance(vx, RangeV):
        return _find_fsel_gather(vx.rref)
    if isinstance(vx, Binop):
        return (_find_fsel_gather(vx.left)
                or _find_fsel_gather(vx.right))
    if isinstance(vx, Partition):
        return _find_fsel_gather(vx.pdata)
    if isinstance(vx, (Like, DictMap)):
        return _find_fsel_gather(vx.ldata)
    return None


def predication(vx: Vx) -> Optional[Vexp]:
    """Fold over compact-then-gather chains -> masked fold over the raw
    columns.  Replaces ``agg(gather(x, FoldSelect(b)))`` with
    ``agg(x | mask=b)``: no selection vector, no gathers — one predicated
    scan, the TPU-native filter+aggregate."""
    if not (isinstance(vx, Fold) and vx.foldop != "FSel"):
        return None
    pos = _find_fsel_gather(vx.fdata) or _find_fsel_gather(vx.fgroups)
    if pos is None:
        return None
    b = pos.vx.fdata  # the boolean the FoldSelect compacted
    d2 = _ungather(vx.fdata, pos.skey, b)
    g2 = _ungather(vx.fgroups, pos.skey, b)
    if d2 is None or g2 is None:
        return None
    mask = b
    if vx.fmask is not None:
        m2 = _ungather(vx.fmask, pos.skey, b)
        if m2 is None:
            return None
        mask = complete(Binop(binop=M.LOGAND, left=m2, right=b))
    return complete(Fold(foldop=vx.foldop, fgroups=g2, fdata=d2,
                         fmask=mask))


def gather_composition(vx: Vx) -> Optional[Vexp]:
    """gather(gather(X, p1), p2) -> gather(X, gather(p1, p2)).

    Join/select pipelines gather every column at every level; composing
    the index vectors first means each column is fetched ONCE at final
    cardinality, and the composed index CSEs across all columns of the
    level (a gather's cost scales with the elements it moves, so halving
    gather traffic halves join cost)."""
    if (isinstance(vx, Shuffle) and vx.shop == GATHER
            and isinstance(vx.shsource.vx, Shuffle)
            and vx.shsource.vx.shop == GATHER
            and vx.shshape is None and vx.shsource.vx.shshape is None):
        inner = vx.shsource.vx
        composed = complete(Shuffle(shop=GATHER, shsource=inner.shpos,
                                    shpos=vx.shpos))
        return complete(Shuffle(shop=GATHER, shsource=inner.shsource,
                                shpos=composed))
    return None


def gather_composition_pass(vs: List[Vexp]) -> List[Vexp]:
    for _ in range(8):
        new = xform(gather_composition, vs)
        if [v.skey for v in new] == [v.skey for v in vs]:
            return new
        vs = new
    return vs


def predication_pass(vs: List[Vexp]) -> List[Vexp]:
    """Apply predication to a fixpoint (stacked selects peel one gather
    level per iteration)."""
    for _ in range(8):
        new = xform(predication, vs)
        if [v.skey for v in new] == [v.skey for v in vs]:
            return new
        vs = new
    return vs


def engine_passes(vs: List[Vexp]) -> List[Vexp]:
    """Cleanup pipeline for the TPU engine (MainFuns.hs:184-186 minus the
    Max/Min lowering, which the engine executes natively), plus the
    predication and gather-composition rewrites."""
    vs = algebraic_identities_pass(redundant_range_pass(vs))
    # alternate to a joint fixpoint: composing gather chains exposes the
    # rank-map scatter idiom that predication's fmask retargeting matches
    for _ in range(4):
        new = gather_composition_pass(predication_pass(vs))
        if [v.skey for v in new] == [v.skey for v in vs]:
            break
        vs = new
    return vs


def reference_passes(vs: List[Vexp]) -> List[Vexp]:
    """The reference's full ``-c`` pipeline, for conformance emission."""
    return algebraic_identities_pass(lowering_pass(redundant_range_pass(vs)))
