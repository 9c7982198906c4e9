"""Dotted names and the suffix-resolving name table.

Names are tuples of path segments, e.g. ``("lineitem", "l_orderkey")``.
The NameTable resolves *unambiguous suffixes*: a lookup of
``("l_orderkey",)`` finds ``("lineitem", "l_orderkey")`` as long as exactly
one inserted name ends with that suffix.  (Semantics of reference
src/Name.hs:94-126: entries are keyed on reversed segment lists; a query
matches when the reversed query is a prefix of exactly one reversed key.)
"""

from __future__ import annotations

from typing import Generic, Iterable, Iterator, Optional, Tuple, TypeVar

Name = Tuple[str, ...]

V = TypeVar("V")


def name_str(n: Name) -> str:
    return ".".join(n)


def concat_name(a: Name, b: Name) -> Name:
    return a + b


def get_last(n: Name) -> Name:
    return (n[-1],)


def drop_sys(parts: Iterable[str]) -> Name:
    """Strip the optional leading ``sys`` schema qualifier (Parser.y:310-313)."""
    parts = tuple(parts)
    if parts and parts[0] == "sys":
        return parts[1:]
    return parts


class AmbiguousName(KeyError):
    pass


class NameTable(Generic[V]):
    """Ordered map keyed on reversed name segments with suffix lookup.

    Reference src/Name.hs stores reversed segment lists in an ordered map and
    uses lookupGE to find suffix matches.  Python dicts are small here (tens
    to hundreds of entries per scope), so we simply scan for suffix matches
    and keep a dict for exact hits.
    """

    __slots__ = ("_m",)

    def __init__(self) -> None:
        self._m: dict[Name, V] = {}

    def insert(self, n: Name, v: V) -> None:
        """Strict insert: collision is an error (Name.hs:114-120)."""
        if n in self._m:
            raise KeyError(f"scope already has {name_str(n)}")
        self._m[n] = v

    def insert_weak(self, n: Name, v: V) -> None:
        """Overwriting insert (Name.hs:123-126)."""
        self._m[n] = v

    def lookup(self, n: Name) -> Tuple[Name, V]:
        """Resolve ``n`` as an unambiguous suffix of an inserted name.

        Raises KeyError when absent, AmbiguousName when several names end
        with the suffix (Name.hs:94-112).
        """
        exact = self._m.get(n)
        if exact is not None or n in self._m:
            # an exact hit may still be a prefix-ambiguous situation in the
            # reference encoding, but exact full-name matches take priority
            # only when no other name has this as a strict suffix; mirror the
            # reference by checking all suffix matches.
            pass
        matches = [(k, v) for k, v in self._m.items() if k[-len(n):] == n]
        if not matches:
            raise KeyError(f"no name: {name_str(n)} in scope: {self.names()}")
        if len(matches) > 1:
            cands = ", ".join(name_str(k) for k, _ in matches)
            raise AmbiguousName(
                f"ambiguous name resolution for {name_str(n)}: {cands} all match"
            )
        return matches[0]

    def lookup_opt(self, n: Name) -> Optional[Tuple[Name, V]]:
        try:
            return self.lookup(n)
        except AmbiguousName:
            raise
        except KeyError:
            return None

    def __contains__(self, n: Name) -> bool:
        return self.lookup_opt(n) is not None

    def items(self) -> Iterator[Tuple[Name, V]]:
        return iter(self._m.items())

    def names(self) -> list[str]:
        return [name_str(k) for k in self._m]

    def __len__(self) -> int:
        return len(self._m)

    @classmethod
    def from_items(cls, prs: Iterable[Tuple[Name, V]]) -> "NameTable[V]":
        t: NameTable[V] = cls()
        for n, v in prs:
            t.insert_weak(n, v)
        return t
