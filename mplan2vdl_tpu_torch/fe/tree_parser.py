"""Permissive plan re-parse for visualization (reference src/TreeParser.y).

The strict plan grammar rejects plans it cannot compile (unknown
operators, exotic scalar forms); the reference keeps a SECOND, permissive
grammar just for ``--dot`` that only recovers the tree shape and keeps
every bracketed argument list as a raw string (TreeParser.y:50-88,
TRel at :106-111).  Any plan MonetDB prints can therefore be visualized,
including ones the compiler refuses.

Grammar mirrored here (TreeParser.y):
  TLeaf  : 'table' '(' QualifiedName ')' '[' TExt ']' 'COUNT'   (:57-59)
  TNode  : identifier+ '(' TTree (',' TTree)* ')' ('[' TExt ']')+ (:69-82)
  TExt   : raw token run, nested '[...]' reassembled inline      (:84-99)
``NOT NULL`` and ``HASHCOL`` vanish from arg text (:95-96); ``sys.``
prefixes are dropped from leaf names (:135-137).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple, Union

from . import lexer as L


@dataclass
class TLeaf:
    source: Tuple[str, ...]
    columns: str


@dataclass
class TNode:
    relop: str
    children: List["TRel"] = field(default_factory=list)
    arg_lists: List[str] = field(default_factory=list)


TRel = Union[TLeaf, TNode]


class TreeParseError(ValueError):
    pass


class _P:
    def __init__(self, toks: List[L.Tok]):
        self.toks = toks
        self.i = 0

    def peek(self, ahead: int = 0) -> L.Tok:
        j = self.i + ahead
        if j >= len(self.toks):
            raise TreeParseError("unexpected EOF")
        return self.toks[j]

    def at_end(self) -> bool:
        return self.i >= len(self.toks)

    def take(self, kind: str = None) -> L.Tok:
        t = self.peek()
        if kind is not None and t.kind != kind:
            raise TreeParseError(f"expected {kind}, got {t!r}")
        self.i += 1
        return t

    # ---- TExt: reassemble raw tokens until the closing bracket (:84-99)
    def raw_until_rbrack(self) -> str:
        parts: List[str] = []
        while True:
            t = self.peek()
            if t.kind == L.RBRACK:
                self.take()
                return " ".join(parts)
            if t.kind == L.LBRACK:  # TNested (:99-100)
                self.take()
                parts.append("[ " + self.raw_until_rbrack() + " ]")
                continue
            self.take()
            if t.kind == L.LIT:
                parts.append(f'"{t.text}"')
            elif t.kind == L.DOT:
                # dots belong in names (:88): glue to the previous part
                if parts and self.peek().kind in (L.WORD, L.NUM):
                    parts[-1] += "." + self.take().text
                else:
                    parts.append(".")
            elif t.text in ("NOT NULL", "HASHCOL"):  # dropped (:95-96)
                continue
            else:
                parts.append(t.text)

    def qualified_name(self) -> Tuple[str, ...]:
        segs = [self.take(L.WORD).text]
        while not self.at_end() and self.peek().kind == L.DOT:
            self.take()
            segs.append(self.take(L.WORD).text)
        if segs[0] == "sys":  # dropsys (:135-137)
            segs = segs[1:]
        return tuple(segs)

    def tree(self) -> TRel:
        t = self.peek()
        if (t.kind == L.WORD and t.text == "table"
                and self.peek(1).kind == L.LPAREN):
            self.take()
            self.take(L.LPAREN)
            name = self.qualified_name()
            self.take(L.RPAREN)
            self.take(L.LBRACK)
            cols = self.raw_until_rbrack()
            cnt = self.take(L.WORD)
            if cnt.text != "COUNT":
                raise TreeParseError(f"expected COUNT, got {cnt!r}")
            return TLeaf(source=name, columns=cols)
        # TNode: one or more identifiers name the operator (:69-74)
        idents = [self.take(L.WORD).text]
        while self.peek().kind == L.WORD:
            idents.append(self.take().text)
        self.take(L.LPAREN)
        children = [self.tree()]
        while self.peek().kind == L.COMMA:
            self.take()
            children.append(self.tree())
        self.take(L.RPAREN)
        arg_lists: List[str] = []
        while not self.at_end() and self.peek().kind == L.LBRACK:
            self.take()
            arg_lists.append(self.raw_until_rbrack())
        if not arg_lists:
            raise TreeParseError("node needs at least one [args] list")
        return TNode(relop=" ".join(idents), children=children,
                     arg_lists=arg_lists)


def parse(text: str) -> TRel:
    """Parse a (comment-stripped) plan permissively into a TRel."""
    p = _P(L.scan(text))
    t = p.tree()
    if not p.at_end():
        raise TreeParseError(f"trailing tokens from {p.peek()!r}")
    return t
