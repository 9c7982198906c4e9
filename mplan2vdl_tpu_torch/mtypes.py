"""The three type layers of the framework (semantics of reference src/Types.hs).

* MType — surface MonetDB types appearing in plans and schemas (Types.hs:109-125)
* SType — storage types; everything is an integer: int32, int64, or a scaled
  decimal held in an int64 (Types.hs:66-70)
* DType — display semantics: decimal point position, string dictionary
  decoder, or date (Types.hs:76-80)

On TPU the SType additionally drives the physical dtype choice (int32 when
the value bounds fit, int64 otherwise) — the catalog's static bounds make
this decision exact per vector.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

from .names import Name


# ---------------------------------------------------------------- storage types
@dataclass(frozen=True)
class SDecimal:
    precision: int
    scale: int


@dataclass(frozen=True)
class SInt32:
    pass


@dataclass(frozen=True)
class SInt64:
    pass


SType = Union[SDecimal, SInt32, SInt64]

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
INT64_MIN, INT64_MAX = -(2**63), 2**63 - 1


def size_of(st: SType) -> int:
    return 4 if isinstance(st, SInt32) else 8


def bounds_of(st: SType) -> Tuple[int, int]:
    if isinstance(st, SInt32):
        return (INT32_MIN, INT32_MAX)
    return (INT64_MIN, INT64_MAX)


def within_bounds(b: Tuple[int, int], st: SType) -> bool:
    lo, hi = bounds_of(st)
    l, u = b
    return lo <= l <= u <= hi


# ---------------------------------------------------------------- display types
@dataclass(frozen=True)
class DDecimal:
    point: int


@dataclass(frozen=True)
class DString:
    decoder: Name  # the table column whose dictionary decodes these codes


@dataclass(frozen=True)
class DDate:
    pass


DType = Union[DDecimal, DString, DDate]


# ---------------------------------------------------------------- surface types
@dataclass(frozen=True)
class MType:
    """A resolved MonetDB surface type (Types.hs:109-125 collapsed to one record)."""

    kind: str  # tinyint|smallint|int|bigint|date|millisec|month|double|oid|char|varchar|decimal|boolean
    p1: int = 0  # char/varchar length; decimal precision; sec_interval param
    p2: int = 0  # decimal scale


@dataclass(frozen=True)
class TypeSpec:
    tname: str
    tparams: Tuple[int, ...] = ()


def resolve_type_spec(ts: TypeSpec) -> MType:
    """Typespec text -> MType (Types.hs:156-173)."""
    name = ts.tname.lower()
    ps = ts.tparams
    if name in ("int", "integer") and not ps:
        return MType("int")
    if name == "tinyint" and not ps:
        return MType("tinyint")
    if name == "smallint" and not ps:
        return MType("smallint")
    if name == "bigint" and not ps:
        return MType("bigint")
    if name == "date" and not ps:
        return MType("date")
    if name == "char":
        return MType("char", ps[0] if ps else -1)
    if name == "varchar" and len(ps) == 1:
        return MType("varchar", ps[0])
    if name == "decimal" and len(ps) == 2:
        return MType("decimal", ps[0], ps[1])
    if name == "sec_interval" and len(ps) == 1:
        return MType("millisec", ps[0])  # expressed in milliseconds
    if name == "month_interval" and not ps:
        return MType("month")
    if name == "double":
        # ``double(53,1)[...]`` casts appear in Q17; the params carry the
        # IEEE mantissa width and are irrelevant here (the reference only
        # accepts a bare ``double`` and fails on Q17; extension).
        return MType("double")
    if name == "real" and not ps:
        return MType("double")
    if name == "boolean" and not ps:
        return MType("boolean")
    if name == "oid" and not ps:
        return MType("oid")
    raise ValueError(f"unsupported typespec: {ts}")


def stype_of_mtype(mt: MType) -> SType:
    """Types.hs:129-140."""
    k = mt.kind
    if k in ("int", "smallint", "tinyint", "date"):
        return SInt32()
    if k in ("oid", "char", "varchar", "bigint"):
        return SInt64()
    if k == "decimal":
        return SDecimal(mt.p1, mt.p2)
    raise ValueError(f"no storage type for surface type {mt}")


def dtype_of_mtype(mt: MType, nm: Name) -> DType:
    """Types.hs:142-153."""
    k = mt.kind
    if k in ("int", "smallint", "tinyint", "bigint", "oid"):
        return DDecimal(0)
    if k == "decimal":
        return DDecimal(mt.p2)
    if k == "date":
        return DDate()
    if k in ("char", "varchar"):
        return DString(nm)
    raise ValueError(f"no display type for surface type {mt}")
