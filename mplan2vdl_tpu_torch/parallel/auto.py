"""Plan analysis shared with the distribution layer.

Holds ``_collect_folds``, which ``engine/fuse.py`` imports from here as it
does in the JAX package; the distributed executor itself is not ported
yet."""

from __future__ import annotations

from typing import List

from .. import vir as V
from ..engine.lower import _children


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
