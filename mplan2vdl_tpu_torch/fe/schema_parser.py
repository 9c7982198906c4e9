"""Parser for ``msqldump -D`` DDL dumps (reference src/SchemaParser.y).

Recognizes::

    SET SCHEMA "sys";
    CREATE TABLE "sys"."name" (
        "col" TYPE(params)  NOT NULL,
        ...,
        CONSTRAINT "cname" PRIMARY KEY ("c1", "c2"),
        CONSTRAINT "cname" FOREIGN KEY ("c1") REFERENCES "sys"."tab" ("r1")
    );

Every table must declare a primary key; foreign keys follow it
(SchemaParser.y:70-78).  Quotes and the ``sys.`` prefix are stripped
(SchemaParser.y:158-169).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..names import Name, drop_sys
from ..mtypes import TypeSpec
from . import lexer
from .lexer import (COMMA, DOT, LIT, LPAREN, NUM, RPAREN, SEMI, Tok, WORD)


@dataclass(frozen=True)
class PKey:
    cols: Tuple[Name, ...]
    constraint: Name


@dataclass(frozen=True)
class FKey:
    references: Name  # referenced table
    colmap: Tuple[Tuple[Name, Name], ...]  # (local, remote) column pairs
    constraint: Name


@dataclass(frozen=True)
class Table:
    name: Name
    columns: Tuple[Tuple[Name, TypeSpec], ...]
    pkey: PKey
    fkeys: Tuple[FKey, ...]


class SchemaError(ValueError):
    pass


class _P:
    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0

    def peek(self, k: int = 0) -> Optional[Tok]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> Tok:
        t = self.peek()
        if t is None:
            raise SchemaError("unexpected EOF in schema")
        self.i += 1
        return t

    def expect(self, kind: str, text: Optional[str] = None) -> Tok:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise SchemaError(f"expected {text or kind}, got {t}")
        return t

    def at_word(self, text: str, k: int = 0) -> bool:
        t = self.peek(k)
        return t is not None and t.kind == WORD and t.text == text

    def quoted_name(self) -> Name:
        """``"sys"."tab"`` or ``"col"`` -> sys-stripped name tuple."""
        parts = [self.expect(LIT).text]
        while self.peek() and self.peek().kind == DOT:
            self.next()
            parts.append(self.expect(LIT).text)
        return drop_sys(parts)

    def quoted_col_list(self) -> Tuple[Name, ...]:
        self.expect(LPAREN)
        cols = [self.quoted_name()]
        while self.peek() and self.peek().kind == COMMA:
            self.next()
            cols.append(self.quoted_name())
        self.expect(RPAREN)
        return tuple(cols)

    def parse_typespec(self) -> TypeSpec:
        tname = self.expect(WORD).text
        params: List[int] = []
        if self.peek() and self.peek().kind == LPAREN:
            self.next()
            params.append(int(self.expect(NUM).text))
            while self.peek() and self.peek().kind == COMMA:
                self.next()
                params.append(int(self.expect(NUM).text))
            self.expect(RPAREN)
        return TypeSpec(tname, tuple(params))

    def skip_col_attrs(self) -> None:
        # NOT NULL / DEFAULT ... — skip words until ',' or ')'
        depth = 0
        while True:
            t = self.peek()
            if t is None:
                return
            if depth == 0 and t.kind in (COMMA, RPAREN):
                return
            if t.kind == LPAREN:
                depth += 1
            elif t.kind == RPAREN:
                depth -= 1
            self.next()

    def parse_table(self) -> Table:
        self.expect(WORD, "CREATE TABLE")
        name = self.quoted_name()
        self.expect(LPAREN)
        columns: List[Tuple[Name, TypeSpec]] = []
        pkey: Optional[PKey] = None
        fkeys: List[FKey] = []
        while True:
            t = self.peek()
            if t is None:
                raise SchemaError("unexpected EOF in table body")
            if t.kind == WORD and t.text == "CONSTRAINT":
                self.next()
                cname = self.quoted_name()
                if self.at_word("PRIMARY KEY"):
                    self.next()
                    cols = self.quoted_col_list()
                    if pkey is not None:
                        raise SchemaError(f"table {name}: two primary keys")
                    pkey = PKey(cols=cols, constraint=cname)
                elif self.at_word("FOREIGN KEY"):
                    self.next()
                    local = self.quoted_col_list()
                    self.expect(WORD, "REFERENCES")
                    reftab = self.quoted_name()
                    remote = self.quoted_col_list()
                    if len(local) != len(remote):
                        raise SchemaError(f"fk arity mismatch in {cname}")
                    fkeys.append(FKey(references=reftab,
                                      colmap=tuple(zip(local, remote)),
                                      constraint=cname))
                else:
                    raise SchemaError(f"unknown constraint kind at {self.peek()}")
            elif t.kind == LIT:
                colname = self.quoted_name()
                ts = self.parse_typespec()
                self.skip_col_attrs()
                columns.append((colname, ts))
            else:
                raise SchemaError(f"unexpected token in table body: {t}")
            t = self.peek()
            if t is not None and t.kind == COMMA:
                self.next()
                continue
            break
        self.expect(RPAREN)
        self.expect(SEMI)
        if pkey is None:
            raise SchemaError(f"table {name} has no primary key")
        return Table(name=name, columns=tuple(columns), pkey=pkey,
                     fkeys=tuple(fkeys))

    def parse_schema(self) -> List[Table]:
        tables: List[Table] = []
        while self.peek() is not None:
            if self.at_word("SET"):
                # SET SCHEMA "sys";
                while self.peek() is not None and self.peek().kind != SEMI:
                    self.next()
                self.expect(SEMI)
                continue
            tables.append(self.parse_table())
        return tables


def parse(text: str) -> List[Table]:
    # the dump begins with '-- msqldump ...' comment lines
    clean = "\n".join("" if ln.lstrip().startswith("--") else ln
                      for ln in text.split("\n"))
    return _P(lexer.scan(clean)).parse_schema()


def from_file(path: str) -> List[Table]:
    with open(path) as f:
        return parse(f.read())
