"""Fusion planning: route families of dense-domain folds that share one
(group, mask) pair through the fused multi-aggregate kernel.

Matches the aggregate shapes the limb kernel supports (multiagg.py):
``sum(base * prod(const +- col))`` with non-negative bounded values, and
``choose(col)`` as a masked max.  Everything else stays on the engine's
normal dense/sorted fold paths.  The planner is purely structural — it
inspects the post-predication Vexp DAG, so any query whose aggregate
stage looks like TPC-H Q1 (several folds over one masked scan) fuses
automatically.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .. import vir as V
from ..names import Name
from .kernels.multiagg import AggSpec

MAX_DOMAIN = 16
MIN_FAMILY = 3  # fusing fewer folds isn't worth the kernel dispatch
_FMAX15 = (1 << 15) - 1


def _const_of(v: V.Vexp) -> Optional[int]:
    vx = v.vx
    if isinstance(vx, V.RangeV) and vx.rstep == 0:
        return vx.rmin
    if isinstance(vx, V.Binop):
        l, r = _const_of(vx.left), _const_of(vx.right)
        if l is None or r is None:
            return None
        return {"Mul": lambda: l * r, "Add": lambda: l + r,
                "Sub": lambda: l - r}.get(vx.binop, lambda: None)()
    return None


def _factor_of(v: V.Vexp):
    """(const, sign, load_name_or_None) with value in [0, 2^15), or None."""
    lo, hi = v.info.bounds
    if lo < 0 or hi > _FMAX15:
        return None
    c = _const_of(v)
    if c is not None:
        return (c, 0, None)
    vx = v.vx
    if isinstance(vx, V.Load):
        return (0, 1, vx.name)
    if isinstance(vx, V.Binop) and vx.binop in ("Add", "Sub"):
        for a, b, sign_b in ((vx.left, vx.right, -1 if vx.binop == "Sub"
                              else 1),):
            ca = _const_of(a)
            if ca is not None and isinstance(b.vx, V.Load):
                return (ca, sign_b, b.vx.name)
            cb = _const_of(b)
            if (cb is not None and isinstance(a.vx, V.Load)
                    and vx.binop == "Add"):
                return (cb, 1, a.vx.name)
    return None


def _spec_of(fdata: V.Vexp):
    """(base_name_or_None, factors, bits) or None (sum shapes only)."""
    lo, hi = fdata.info.bounds
    if lo < 0:
        return None
    # peel the Mul chain
    leaves: List[V.Vexp] = []
    stack = [fdata]
    while stack:
        v = stack.pop()
        if isinstance(v.vx, V.Binop) and v.vx.binop == "Mul":
            stack.append(v.vx.left)
            stack.append(v.vx.right)
        else:
            leaves.append(v)
    base: Optional[Name] = None
    factors: List[Tuple[int, int, Optional[Name]]] = []
    const_mult = 1
    for v in leaves:
        c = _const_of(v)
        if c is not None:
            const_mult *= c
            continue
        if (base is None and isinstance(v.vx, V.Load)
                and 0 <= v.info.bounds[0]
                and v.info.bounds[1] <= 2**31 - 1):
            base = v.vx.name
            continue
        f = _factor_of(v)
        if f is None:
            return None
        factors.append(f)
    if const_mult != 1:
        if not (0 <= const_mult <= _FMAX15):
            return None
        factors.append((const_mult, 0, None))
    bits = max(1, int(hi).bit_length())
    return base, tuple(factors), bits


@dataclass
class Family:
    """One fused kernel invocation: folds sharing (fgroups, fmask)."""

    fgroups: V.Vexp
    fmask: Optional[V.Vexp]
    domain: int
    folds: List[V.Vexp]
    specs: List[AggSpec]
    load_names: List[Name]


def plan_fusions(vexps: List[V.Vexp]) -> Dict[int, Tuple[int, int]]:
    """Returns ({fold_skey: (family_idx, agg_idx)}, [Family, ...])."""
    from ..parallel.auto import _collect_folds  # innermost-fold walker

    folds = _collect_folds(vexps)
    groups: Dict[tuple, list] = {}
    for f in folds:
        vx = f.vx
        dom = vx.fgroups.info.bounds[1] + 1
        if dom > MAX_DOMAIN or vx.fgroups.info.bounds[0] != 0:
            continue
        key = (vx.fgroups.skey,
               vx.fmask.skey if vx.fmask is not None else None)
        groups.setdefault(key, []).append(f)

    fold_map: Dict[int, Tuple[int, int]] = {}
    families: List[Family] = []
    for key, fam_folds in groups.items():
        cands = []
        for f in fam_folds:
            vx = f.vx
            if vx.foldop == V.FSUM:
                s = _spec_of(vx.fdata)
                if s is not None:
                    base, factors, bits = s
                    cands.append((f, base, factors, bits, "sum"))
            elif vx.foldop == V.FCHOOSE:
                d = vx.fdata
                if (isinstance(d.vx, V.Load) and d.info.bounds[0] >= 0
                        and d.info.bounds[1] <= 2**31 - 1):
                    cands.append((f, d.vx.name, (), 31, "max"))
        if len(cands) < MIN_FAMILY:
            continue
        names: List[Name] = []

        def idx_of(nm):
            if nm not in names:
                names.append(nm)
            return names.index(nm)

        specs, fs = [], []
        for f, base, factors, bits, op in cands:
            specs.append(AggSpec(
                base=None if base is None else idx_of(base),
                factors=tuple((c, s, 0 if nm is None else idx_of(nm))
                              for (c, s, nm) in factors),
                bits=bits, op=op))
            fs.append(f)
        fam = Family(fgroups=fs[0].vx.fgroups, fmask=fs[0].vx.fmask,
                     domain=fs[0].vx.fgroups.info.bounds[1] + 1,
                     folds=fs, specs=specs, load_names=names)
        fam_idx = len(families)
        families.append(fam)
        for a, f in enumerate(fs):
            fold_map[f.skey] = (fam_idx, a)
    return fold_map, families
