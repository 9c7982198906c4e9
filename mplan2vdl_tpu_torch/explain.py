"""Structured plan dumps — the framework's observability surface
(SURVEY.md §5: the reference had only Debug.Trace prints and ``--metadata``
comments; here every compilation stage can be rendered).

``explain_vexps`` prints the vector-IR DAG as an indented tree with the
static metadata that drives compilation (count bounds, value bounds,
physical dtype, uniqueness, lineage).
"""

from __future__ import annotations

from typing import List, Set

from . import vir as V
from .engine.lower import _children, dtype_for
from .names import name_str


def _label(v: V.Vexp) -> str:
    vx = v.vx
    kind = type(vx).__name__
    extra = ""
    if isinstance(vx, V.Load):
        extra = f" {name_str(vx.name)}"
    elif isinstance(vx, V.Binop):
        extra = f" {vx.binop}"
    elif isinstance(vx, V.Fold):
        extra = f" {vx.foldop}" + (" masked" if vx.fmask is not None else "")
    elif isinstance(vx, V.Shuffle):
        extra = f" {vx.shop}"
    elif isinstance(vx, (V.RangeV, V.RangeC)):
        extra = f" min={vx.rmin} step={vx.rstep}"
    elif isinstance(vx, V.JoinIndex):
        extra = f" {vx.jside}"
    elif isinstance(vx, V.Like):
        extra = f" {vx.lpattern!r}"
    elif isinstance(vx, V.SortPerm):
        extra = " " + ",".join("desc" if d else "asc" for d in vx.descs)
    return kind + extra


def explain_vexps(vexps: List[V.Vexp], max_depth: int = 30) -> str:
    lines: List[str] = []
    seen: Set[int] = set()

    def go(v: V.Vexp, depth: int):
        ind = "  " * depth
        dt = dtype_for(v.info).__name__ if hasattr(dtype_for(v.info), "__name__") \
            else str(dtype_for(v.info))
        meta = (f"#{v.skey} count<={v.info.count} bounds={v.info.bounds} "
                f"{dt}")
        if v.quant == V.UNIQUE:
            meta += " unique"
        if v.lineage is not None:
            meta += f" lineage={name_str(v.lineage.col)}"
        nm = f" as {name_str(v.name)}" if v.name else ""
        lines.append(f"{ind}{_label(v)}{nm}  [{meta}]")
        if v.skey in seen:
            lines[-1] += "  (shared, see above)"
            return
        seen.add(v.skey)
        if depth < max_depth:
            for c in _children(v.vx):
                go(c, depth + 1)

    for i, v in enumerate(vexps):
        lines.append(f"-- output {i}: {name_str(v.name) if v.name else '?'}")
        go(v, 1)
    return "\n".join(lines)
