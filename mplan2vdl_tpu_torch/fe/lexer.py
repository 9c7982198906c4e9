"""Tokenizer shared by the plan parser and the schema parser.

Token semantics of reference src/Scanner.x:
  * whitespace AND vertical bars are skipped (Scanner.x:27)
  * brackets, parens, comma, dot, semicolon are single-char tokens
  * quoted strings are ValueLiterals (quotes kept off)
  * digit runs are NumberLiterals (arbitrary precision)
  * the multi-word keywords "NOT NULL", "no nil", "PRIMARY KEY",
    "FOREIGN KEY", "CREATE TABLE" and the two-char "!=" lex as single Words
    (Scanner.x:41-46)
  * everything else: maximal runs of [a-zA-Z0-9<>=!_%] are Words
    (names may embed relational chars, e.g. ``sys.<=``; Scanner.x:21-23)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

# token kinds
LBRACK, RBRACK, LPAREN, RPAREN = "LBRACK", "RBRACK", "LPAREN", "RPAREN"
COMMA, DOT, SEMI = "COMMA", "DOT", "SEMI"
LIT, NUM, WORD = "LIT", "NUM", "WORD"

_PUNCT = {"[": LBRACK, "]": RBRACK, "(": LPAREN, ")": RPAREN,
          ",": COMMA, ".": DOT, ";": SEMI}

_MULTIWORD = ("NOT NULL", "no nil", "PRIMARY KEY", "FOREIGN KEY",
              "CREATE TABLE", "!=")

_NAME_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789<>=!_%"
)


@dataclass(frozen=True)
class Tok:
    kind: str
    text: str
    line: int
    col: int

    def __repr__(self) -> str:  # compact for parser error messages
        return f"{self.text!r}@{self.line}:{self.col}"


class LexError(ValueError):
    pass


def scan(text: str) -> List[Tok]:
    toks: List[Tok] = []
    i, n = 0, len(text)
    line, linestart = 1, 0
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
            linestart = i
            continue
        if c.isspace() or c == "|":
            i += 1
            continue
        col = i - linestart + 1
        if c in _PUNCT:
            toks.append(Tok(_PUNCT[c], c, line, col))
            i += 1
            continue
        if c == '"':
            j = text.find('"', i + 1)
            if j < 0:
                raise LexError(f"unterminated string literal at {line}:{col}")
            toks.append(Tok(LIT, text[i + 1:j], line, col))
            i = j + 1
            continue
        hit = next((mw for mw in _MULTIWORD if text.startswith(mw, i)), None)
        if hit is not None:
            # a multiword keyword must not be a prefix of a longer name run
            end = i + len(hit)
            if hit == "!=" or end >= n or text[end] not in _NAME_CHARS:
                toks.append(Tok(WORD, hit, line, col))
                i = end
                continue
        if c in _NAME_CHARS:
            j = i
            while j < n and text[j] in _NAME_CHARS:
                j += 1
            run = text[i:j]
            kind = NUM if run.isdigit() else WORD
            toks.append(Tok(kind, run, line, col))
            i = j
            continue
        raise LexError(f"unexpected character {c!r} at {line}:{col}")
    return toks


def strip_plan_comments(text: str) -> str:
    """Drop comment lines, preserving line numbers (MainFuns.hs:83-96).

    Lines whose first character is ``#``, ``%``, ``[`` or that start with
    ``--`` are blanked (the reference keeps them as empty lines so token
    positions still line up).
    """
    out = []
    for ln in text.split("\n"):
        s = ln.lstrip()
        if s[:1] in ("#", "%", "[") or s[:2] == "--":
            out.append("")
        else:
            out.append(ln)
    return "\n".join(out)
