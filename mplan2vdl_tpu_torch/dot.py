"""Graphviz visualization of plan trees (reference src/Dot.hs + TreeParser.y).

Like the reference, ``--dot`` re-parses the plan with the PERMISSIVE tree
grammar (fe/tree_parser.py) keeping arg lists as raw strings, so any plan
can be visualized — including ones the strict grammar or codegen rejects
(TreeParser.y:106-111).  ``to_dot_string`` still renders a strict parse
tree for callers that already hold one.  Layout per Dot.hs:44-61:
relational operators as nodes, argument lists as blue boxes.
"""

from __future__ import annotations

from typing import List

from .fe import plan_parser as P
from .fe import tree_parser as T


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def _expr_text(e: P.Expr) -> str:
    inner = e.expr
    if isinstance(inner, P.Ref):
        return ".".join(inner.name)
    if isinstance(inner, P.Literal):
        return f'{inner.tspec.tname} "{inner.rep}"'
    if isinstance(inner, P.Call):
        return ".".join(inner.fname) + "(...)"
    if isinstance(inner, P.Cast):
        return f"{inner.tspec.tname}[...]"
    if isinstance(inner, P.Infix):
        return f"{_expr_text(inner.left)} {inner.op} {_expr_text(inner.right)}"
    return type(inner).__name__


def to_dot_string(rel: P.Rel) -> str:
    lines: List[str] = ["digraph plan {", "  node [shape=box];"]
    counter = [0]

    def fresh() -> int:
        counter[0] += 1
        return counter[0]

    def walk(r: P.Rel) -> int:
        me = fresh()
        if isinstance(r, P.Leaf):
            lines.append(
                f'  n{me} [label="table {_esc(".".join(r.source))}"];')
            args = fresh()
            cols = ", ".join(_expr_text(c) for c in r.columns)
            lines.append(
                f'  n{args} [label="{_esc(cols)}", color=blue,'
                f' fontcolor=blue];')
            lines.append(f"  n{me} -> n{args};")
            return me
        lines.append(f'  n{me} [label="{_esc(r.relop)}"];')
        for ch in r.children:
            c = walk(ch)
            lines.append(f"  n{me} -> n{c};")
        for arglist in r.arg_lists:
            a = fresh()
            txt = ", ".join(_expr_text(x) for x in arglist) or "(empty)"
            lines.append(
                f'  n{a} [label="{_esc(txt)}", color=blue, fontcolor=blue];')
            lines.append(f"  n{me} -> n{a};")
        return me

    walk(rel)
    lines.append("}")
    return "\n".join(lines)


def tree_to_dot_string(rel: T.TRel) -> str:
    """Render a permissive TRel (raw arg strings) as graphviz text."""
    lines: List[str] = ["digraph plan {", "  node [shape=box];"]
    counter = [0]

    def fresh() -> int:
        counter[0] += 1
        return counter[0]

    def walk(r: T.TRel) -> int:
        me = fresh()
        if isinstance(r, T.TLeaf):
            lines.append(
                f'  n{me} [label="table {_esc(".".join(r.source))}"];')
            args = fresh()
            lines.append(
                f'  n{args} [label="{_esc(r.columns)}", color=blue,'
                f' fontcolor=blue];')
            lines.append(f"  n{me} -> n{args};")
            return me
        lines.append(f'  n{me} [label="{_esc(r.relop)}"];')
        for ch in r.children:
            c = walk(ch)
            lines.append(f"  n{me} -> n{c};")
        for raw in r.arg_lists:
            a = fresh()
            lines.append(
                f'  n{a} [label="{_esc(raw or "(empty)")}", color=blue,'
                f' fontcolor=blue];')
            lines.append(f"  n{me} -> n{a};")
        return me

    walk(rel)
    lines.append("}")
    return "\n".join(lines)


def plan_text_to_dot(text: str) -> str:
    """The --dot entry: permissive re-parse + render (MainFuns.hs:165-170)."""
    return tree_to_dot_string(T.parse(text))
