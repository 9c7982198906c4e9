"""Recursive-descent parser for MonetDB "mplan" plan text.

Implements the grammar of reference src/Parser.y (LALR there; the grammar is
LL-friendly with one token of lookahead plus a small amount of
disambiguation between qualified names, calls, and typespec casts/literals).

Tree shape (Parser.y:230-284):
  Rel      = Leaf{source, columns} | Node{relop, children, arg_lists}
  Expr     = (ScalarExpr, alias)
  ScalarExpr = Ref | Call | Cast | Literal | Infix | Interval | Filter | In | Nested
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from ..names import Name, drop_sys
from ..mtypes import TypeSpec
from . import lexer
from .lexer import (COMMA, DOT, LBRACK, LIT, LPAREN, NUM, RBRACK, RPAREN,
                    Tok, WORD)

# words that the token stream treats specially (Parser.y:48-62); they are not
# usable as identifiers inside expressions.
KEYWORDS = frozenset([
    "COUNT", "NOT NULL", "HASHCOL", "JOINIDX", "HASHIDX", "FETCH", "ASC",
    "FILTER", "in", "notin", "no nil", "table", "as",
])


# ----------------------------------------------------------------------- AST
@dataclass(frozen=True)
class Attr:
    kind: str  # notnull | asc | hashcol | hashidx | fetch | joinidx
    name: Optional[Name] = None  # joinidx target


@dataclass(frozen=True)
class Ref:
    name: Name
    attrs: Tuple[Attr, ...] = ()


@dataclass(frozen=True)
class Literal:
    tspec: TypeSpec
    rep: str


@dataclass(frozen=True)
class Call:
    fname: Name
    args: Tuple["Expr", ...]
    # MonetDB's DISTINCT-aggregate call modifier (`sys.count unique no nil
    # (col)`); extension — the reference grammar has no such token
    unique: bool = False


@dataclass(frozen=True)
class Cast:
    tspec: TypeSpec
    value: "Expr"


@dataclass(frozen=True)
class Infix:
    op: str
    left: "Expr"
    right: "Expr"


@dataclass(frozen=True)
class Interval:
    """Three-operand chain ``a <= x < b`` (Parser.y:143-152)."""

    first: "Expr"
    firstop: str
    middle: "Expr"
    secondop: str
    last: "Expr"


@dataclass(frozen=True)
class Filter:
    """``X FILTER like (pattern, escape)`` (Parser.y:202-206)."""

    arg: "Expr"
    oper: str
    negated: bool
    pattern: "Expr"
    escape: "ScalarExpr"


@dataclass(frozen=True)
class In:
    arg: "Expr"
    negated: bool
    set: Tuple["Expr", ...]


@dataclass(frozen=True)
class Nested:
    """Parenthesized conjunct list (Parser.y:197)."""

    exprs: Tuple["Expr", ...]


ScalarExpr = Union[Ref, Literal, Call, Cast, Infix, Interval, Filter, In, Nested]


@dataclass(frozen=True)
class Expr:
    expr: ScalarExpr
    alias: Optional[Name] = None


@dataclass(frozen=True)
class Leaf:
    source: Name
    columns: Tuple[Expr, ...]


@dataclass(frozen=True)
class Node:
    relop: str
    children: Tuple["Rel", ...]
    arg_lists: Tuple[Tuple[Expr, ...], ...]


Rel = Union[Leaf, Node]


class ParseError(ValueError):
    pass


class _P:
    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0

    # ------------------------------------------------------------- utilities
    def peek(self, k: int = 0) -> Optional[Tok]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def at_word(self, text: str, k: int = 0) -> bool:
        t = self.peek(k)
        return t is not None and t.kind == WORD and t.text == text

    def at_ident(self, k: int = 0) -> bool:
        t = self.peek(k)
        return t is not None and t.kind == WORD and t.text not in KEYWORDS

    def next(self) -> Tok:
        t = self.peek()
        if t is None:
            raise ParseError("unexpected EOF")
        self.i += 1
        return t

    def expect(self, kind: str, text: Optional[str] = None) -> Tok:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise ParseError(f"expected {text or kind}, got {t}")
        return t

    # ------------------------------------------------------------------ rels
    def parse_rel(self) -> Rel:
        if self.at_word("table") and self.peek(1) and self.peek(1).kind == LPAREN:
            return self.parse_leaf()
        return self.parse_node()

    def parse_leaf(self) -> Leaf:
        self.expect(WORD, "table")
        self.expect(LPAREN)
        source = self.parse_qname()
        self.expect(RPAREN)
        self.expect(LBRACK)
        cols = self.parse_expr_list(allow_empty=False)
        self.expect(RBRACK)
        self.expect(WORD, "COUNT")
        return Leaf(source=source, columns=tuple(cols))

    def parse_node(self) -> Node:
        words = []
        while self.at_ident():
            words.append(self.next().text)
        if not words:
            raise ParseError(f"expected relational operator at {self.peek()}")
        relop = " ".join(words)
        self.expect(LPAREN)
        children = [self.parse_rel()]
        while self.peek() and self.peek().kind == COMMA:
            self.next()
            children.append(self.parse_rel())
        self.expect(RPAREN)
        arg_lists = []
        while self.peek() and self.peek().kind == LBRACK:
            self.next()
            args = self.parse_expr_list(allow_empty=True)
            self.expect(RBRACK)
            arg_lists.append(tuple(args))
        if not arg_lists:
            raise ParseError(f"node {relop} needs at least one bracket list")
        return Node(relop=relop, children=tuple(children),
                    arg_lists=tuple(arg_lists))

    # ----------------------------------------------------------- expressions
    def parse_expr_list(self, allow_empty: bool) -> List[Expr]:
        out: List[Expr] = []
        t = self.peek()
        if t is None or t.kind in (RBRACK, RPAREN):
            if allow_empty:
                return out
            raise ParseError(f"empty expression list at {t}")
        out.append(self.parse_expr())
        while self.peek() and self.peek().kind == COMMA:
            self.next()
            out.append(self.parse_expr())
        return out

    def parse_expr(self) -> Expr:
        """ExprNoComma: ExprBind (ident ExprBind (ident ExprBind)?)?  (Parser.y:140-152)."""
        e1 = self.parse_expr_bind()
        if self.at_ident():
            op1 = self.next().text
            e2 = self.parse_expr_bind()
            if self.at_ident():
                op2 = self.next().text
                e3 = self.parse_expr_bind()
                return Expr(Interval(e1, op1, e2, op2, e3))
            return Expr(Infix(op1, e1, e2))
        return e1

    def parse_expr_bind(self) -> Expr:
        """BasicExpr with optional alias, plus the FILTER/IN postfixes.

        FilterExpr and InExpr take an ExprBind argument (Parser.y:203-212),
        so an alias binds tighter than the postfix.
        """
        base = self.parse_primary()
        alias: Optional[Name] = None
        while True:
            if self.at_word("as"):
                self.next()
                alias = self.parse_qname()
            elif self.at_word("FILTER") or (self.at_word("!") and self.at_word("FILTER", 1)):
                negated = False
                if self.at_word("!"):
                    self.next()
                    negated = True
                self.expect(WORD, "FILTER")
                oper = self.next().text
                self.expect(LPAREN)
                pattern = self.parse_expr()
                self.expect(COMMA)
                escape = self.parse_primary()
                self.expect(RPAREN)
                base = Filter(arg=Expr(base, alias), oper=oper,
                              negated=negated, pattern=pattern, escape=escape)
                alias = None
            elif self.at_word("in") or self.at_word("notin"):
                negated = self.next().text == "notin"
                self.expect(LPAREN)
                elems = self.parse_expr_list(allow_empty=True)
                self.expect(RPAREN)
                base = In(arg=Expr(base, alias), negated=negated,
                          set=tuple(elems))
                alias = None
            else:
                return Expr(base, alias)

    def parse_attrs(self) -> Tuple[Attr, ...]:
        out = []
        while True:
            if self.at_word("NOT NULL"):
                self.next()
                out.append(Attr("notnull"))
            elif self.at_word("ASC"):
                self.next()
                out.append(Attr("asc"))
            elif self.at_word("HASHCOL"):
                self.next()
                out.append(Attr("hashcol"))
            elif self.at_word("HASHIDX"):
                self.next()
                out.append(Attr("hashidx"))
            elif self.at_word("FETCH"):
                self.next()
                out.append(Attr("fetch"))
            elif self.at_word("JOINIDX"):
                self.next()
                out.append(Attr("joinidx", self.parse_qname()))
            else:
                return tuple(out)

    def parse_qname(self) -> Name:
        parts = [self.next_ident()]
        while self.peek() and self.peek().kind == DOT:
            self.next()
            parts.append(self.next_ident())
        return drop_sys(parts)

    def next_ident(self) -> str:
        t = self.next()
        if t.kind != WORD or t.text in KEYWORDS:
            raise ParseError(f"expected identifier, got {t}")
        return t.text

    def parse_primary(self) -> ScalarExpr:
        """BasicExprBare (Parser.y:184-197).

        Disambiguation after an initial identifier run:
          ident(.ident)* '(' NUM,... ')' LIT        -> Literal with typespec
          ident(.ident)* '(' NUM,... ')' '['        -> Cast with typespec
          ident '[' / ident LIT                     -> Cast / Literal (no params)
          ident(.ident)* 'no nil'? '(' ... ')'      -> Call
          otherwise                                  -> Ref + attrs
        """
        t = self.peek()
        if t is None:
            raise ParseError("unexpected EOF in expression")
        if t.kind == LPAREN:
            self.next()
            exprs = self.parse_expr_list(allow_empty=False)
            self.expect(RPAREN)
            return Nested(tuple(exprs))
        name = self.parse_qname()
        nxt = self.peek()
        if nxt is not None and nxt.kind == LPAREN:
            # peek: all-number params followed by LIT or '[' means a typespec
            save = self.i
            self.next()
            params: List[int] = []
            ok = True
            if self.peek() and self.peek().kind == NUM:
                params.append(int(self.next().text))
                while self.peek() and self.peek().kind == COMMA:
                    self.next()
                    if self.peek() and self.peek().kind == NUM:
                        params.append(int(self.next().text))
                    else:
                        ok = False
                        break
            else:
                ok = False
            if ok and self.peek() and self.peek().kind == RPAREN:
                after = self.peek(1)
                if after is not None and after.kind in (LIT, LBRACK):
                    self.next()  # consume RPAREN
                    ts = TypeSpec(".".join(name), tuple(params))
                    return self.finish_typespec(ts)
            # not a typespec: it is a call
            self.i = save
            self.expect(LPAREN)
            args = self.parse_expr_list(allow_empty=True)
            self.expect(RPAREN)
            self.parse_attrs()
            return Call(fname=name, args=tuple(args))
        if nxt is not None and nxt.kind == WORD and nxt.text in ("no nil",
                                                                 "unique"):
            uniq = False
            if self.peek().text == "unique":  # distinct-aggregate modifier
                self.next()
                uniq = True
            if (self.peek() is not None and self.peek().kind == WORD
                    and self.peek().text == "no nil"):
                self.next()
            self.expect(LPAREN)
            args = self.parse_expr_list(allow_empty=True)
            self.expect(RPAREN)
            self.parse_attrs()
            return Call(fname=name, args=tuple(args), unique=uniq)
        if nxt is not None and nxt.kind in (LIT, LBRACK) and len(name) == 1:
            ts = TypeSpec(name[0])
            return self.finish_typespec(ts)
        attrs = self.parse_attrs()
        return Ref(name=name, attrs=attrs)

    def finish_typespec(self, ts: TypeSpec) -> ScalarExpr:
        t = self.peek()
        if t is not None and t.kind == LIT:
            self.next()
            return Literal(tspec=ts, rep=t.text)
        self.expect(LBRACK)
        inner = self.parse_expr()
        self.expect(RBRACK)
        return Cast(tspec=ts, value=inner)


def parse(text: str) -> Rel:
    """Parse plan text (comment lines must already be stripped)."""
    toks = lexer.scan(text)
    p = _P(toks)
    rel = p.parse_rel()
    if p.peek() is not None:
        raise ParseError(f"trailing tokens after plan: {p.peek()}")
    return rel


def from_file(path: str) -> Rel:
    with open(path) as f:
        return parse(lexer.strip_plan_comments(f.read()))
