"""TPC-H tables from a seed, made with torch on the device.

The same tables, columns, value distributions and dictionaries as the
dbgen-lite generator the engine ships (``engine/datagen.py``, frozen in
``tests/frozen_datagen.py``), drawn with a ``torch.Generator`` on the card
in a few large calls instead of numpy on the host.  Numbers are the
engine's integer encodings: scaled decimals, day counts since 0000-01-01
and dictionary codes.  The dictionaries are small and made on the host from
the same seed.

Every call with the same ``(sf, seed, device)`` gives the same tables, so
the reference can make them again after the measured window instead of
holding a second copy through it.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

Col = Tuple[str, str]

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONT_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cream",
    "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral",
    "forest", "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
    "honeydew", "hot", "indian", "ivory", "khaki", "lace", "lavender",
    "lawn", "lemon", "light", "lime", "linen", "magenta", "maroon",
    "medium", "metallic", "midnight", "mint", "misty", "moccasin", "navajo",
    "navy", "olive", "orange", "orchid", "pale", "papaya", "peach", "peru",
    "pink", "plum", "powder", "puff", "purple", "red", "rose", "rosy",
    "royal", "saddle", "salmon", "sandy", "seashell", "sienna", "sky",
    "slate", "smoke", "snow", "spring", "steel", "tan", "thistle", "tomato",
    "turquoise", "violet", "wheat", "white", "yellow",
]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB",
             "AIR REG"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]
ORDERPRIORITY = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                 "5-LOW"]
MKTSEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
               "HOUSEHOLD"]
COMMENT_WORDS = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "deposits",
    "requests", "accounts", "packages", "foxes", "ideas", "theodolites",
    "pinto", "beans", "instructions", "dependencies", "excuses", "platelets",
    "asymptotes", "courts", "dolphins", "multipliers", "sauternes", "warhorses",
]


def day(y: int, m: int, d: int) -> int:
    """Days since 0000-01-01 (proleptic Gregorian), the engine's dates."""
    return datetime.date(y, m, d).toordinal() + 365


DATE_LO = day(1992, 1, 1)
DATE_HI = day(1998, 8, 2)
CUTOFF = day(1995, 6, 17)


@dataclass
class Tables:
    """Columns on one device (int32 unless a value needs int64) and the
    dictionary of each string column (code -> string)."""

    sf: float
    seed: int
    cols: Dict[Col, torch.Tensor] = field(default_factory=dict)
    decoders: Dict[Col, Dict[int, str]] = field(default_factory=dict)

    def rows(self, tab: str) -> int:
        return next(len(v) for (t, _), v in self.cols.items() if t == tab)

    def code(self, col: Col, s: str) -> int:
        return next(c for c, v in self.decoders[col].items() if v == s)


def sizes(sf: float) -> Dict[str, int]:
    """Rows of the tables whose size the scale factor fixes."""
    return {"part": max(int(200_000 * sf), 20),
            "supplier": max(int(10_000 * sf), 10),
            "customer": max(int(150_000 * sf), 15),
            "orders": max(int(1_500_000 * sf), 150)}


def _comment_vocab(rng, vocab_size: int, special: str = None,
                   special_rate: float = 0.0) -> Dict[int, str]:
    vocab = {}
    for i in range(vocab_size):
        w = rng.choice(COMMENT_WORDS, size=4)
        s = " ".join(w.tolist())
        if special and rng.random() < special_rate:
            a, b = special.split(" ", 1)
            s = f"{w[0]} {a} {w[1]} {b} {w[2]}"
        vocab[i] = f"{s} {i}"
    return vocab


def _strings(values) -> Tuple[np.ndarray, Dict[int, str]]:
    """Codes in sorted string order, as the store's ``add_strings``."""
    uniq, codes = np.unique(np.asarray(values, dtype=object),
                            return_inverse=True)
    return codes.reshape(-1), dict(enumerate(uniq.tolist()))


def generate(sf: float, seed: int, device) -> Tables:
    """The eight TPC-H tables at scale factor ``sf`` from ``seed``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    rng = np.random.default_rng(int(seed))
    i32, i64 = torch.int32, torch.int64

    def randint(lo, hi, n, dtype=i32):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=dtype)

    def rand(n):
        return torch.rand(n, generator=g, device=dev)

    def arange(lo, hi):
        return torch.arange(lo, hi, device=dev, dtype=i32)

    t = Tables(sf=sf, seed=int(seed))

    def put(tab, col, data, decoder=None):
        t.cols[(tab, col)] = (torch.as_tensor(data, device=dev)
                              .to(i32 if data.dtype != i64 else i64))
        if decoder is not None:
            t.decoders[(tab, col)] = decoder

    n = sizes(sf)
    n_part, n_supp, n_cust, n_ord = (n["part"], n["supplier"], n["customer"],
                                     n["orders"])

    # ---- region / nation
    put("region", "r_regionkey", arange(0, 5))
    put("region", "r_name", *_strings(REGIONS))
    put("region", "r_comment",
        *_strings([f"region comment {i}" for i in range(5)]))
    put("nation", "n_nationkey", arange(0, 25))
    put("nation", "n_name", *_strings([nm for nm, _ in NATIONS]))
    put("nation", "n_regionkey", np.array([r for _, r in NATIONS]))
    put("nation", "n_comment",
        *_strings([f"nation comment {i}" for i in range(25)]))

    # ---- part
    pk = arange(1, n_part + 1)
    put("part", "p_partkey", pk)
    name_vocab = min(max(n_part // 8, 200), 20000)
    c5 = rng.integers(0, len(COLORS), size=(name_vocab, 5))
    put("part", "p_name", randint(0, name_vocab, n_part),
        {i: " ".join(COLORS[j] for j in row) for i, row in enumerate(c5)})
    mfgr = randint(1, 6, n_part)
    put("part", "p_mfgr", mfgr - 1,
        {i: f"Manufacturer#{i + 1}" for i in range(5)})
    put("part", "p_brand", mfgr * 10 + randint(1, 6, n_part),
        {b: f"Brand#{b}" for b in range(11, 56)})
    put("part", "p_type", randint(0, 150, n_part),
        {a * 25 + b * 5 + c: f"{TYPE_S1[a]} {TYPE_S2[b]} {TYPE_S3[c]}"
         for a in range(6) for b in range(5) for c in range(5)})
    put("part", "p_size", randint(1, 51, n_part))
    put("part", "p_container", randint(0, 40, n_part),
        {a * 8 + b: f"{CONT_S1[a]} {CONT_S2[b]}"
         for a in range(5) for b in range(8)})
    retail = 90000 + (pk % 20001) + 100 * (pk % 1000) % 110000
    put("part", "p_retailprice", retail)
    put("part", "p_comment", randint(0, 200, n_part),
        _comment_vocab(rng, 200))

    # ---- supplier
    sk = arange(1, n_supp + 1)
    put("supplier", "s_suppkey", sk)
    put("supplier", "s_name", sk % 1024,
        {i: f"Supplier#{i:09d}" for i in range(1024)})
    put("supplier", "s_address", (sk * 7) % 1024,
        {i: f"supp addr {i}" for i in range(1024)})
    put("supplier", "s_nationkey", randint(0, 25, n_supp))
    put("supplier", "s_phone", *_phones(randint, n_supp))
    put("supplier", "s_acctbal", randint(-99999, 1000000, n_supp))
    vocab = max(200, n_supp // 10)
    put("supplier", "s_comment", randint(0, vocab, n_supp),
        _comment_vocab(rng, vocab, "Customer Complaints", 0.02))

    # ---- partsupp: 4 suppliers per part
    step = max(n_supp // 4, 1)
    put("partsupp", "ps_partkey", pk.repeat_interleave(4))
    put("partsupp", "ps_suppkey",
        ((pk[:, None] - 1 + step * torch.arange(4, device=dev, dtype=i32))
         % n_supp + 1).reshape(-1))
    put("partsupp", "ps_availqty", randint(1, 10000, 4 * n_part))
    put("partsupp", "ps_supplycost", randint(100, 100001, 4 * n_part))
    put("partsupp", "ps_comment", randint(0, 200, 4 * n_part),
        _comment_vocab(rng, 200))

    # ---- customer
    ck = arange(1, n_cust + 1)
    put("customer", "c_custkey", ck)
    put("customer", "c_name", ck % 1024,
        {i: f"Customer#{i:09d}" for i in range(1024)})
    put("customer", "c_address", (ck * 13) % 1024,
        {i: f"cust addr {i}" for i in range(1024)})
    put("customer", "c_nationkey", randint(0, 25, n_cust))
    put("customer", "c_phone", *_phones(randint, n_cust))
    put("customer", "c_acctbal", randint(-99999, 1000000, n_cust))
    put("customer", "c_mktsegment", randint(0, 5, n_cust),
        dict(enumerate(MKTSEGMENTS)))
    put("customer", "c_comment", randint(0, 500, n_cust),
        _comment_vocab(rng, 500))

    # ---- orders; a third of customers place none (custkey % 3 == 0)
    ok = arange(1, n_ord + 1)
    put("orders", "o_orderkey", ok)
    ocust = randint(1, n_cust + 1, n_ord)
    ocust = torch.where(ocust % 3 == 0, ocust % n_cust + 1, ocust)
    ocust = torch.where(ocust % 3 == 0, (ocust + 1) % n_cust + 1, ocust)
    put("orders", "o_custkey", ocust)
    odate = randint(DATE_LO, DATE_HI - 151, n_ord)
    put("orders", "o_orderdate", odate)
    put("orders", "o_shippriority", torch.zeros(n_ord, dtype=i32,
                                                device=dev))
    put("orders", "o_orderpriority", randint(0, 5, n_ord),
        dict(enumerate(ORDERPRIORITY)))
    put("orders", "o_clerk", randint(0, 1024, n_ord),
        {i: f"Clerk#{i:09d}" for i in range(1024)})
    put("orders", "o_comment", randint(0, 2000, n_ord),
        _comment_vocab(rng, 2000, "special requests", 0.05))

    # ---- lineitem: 1-7 lines per order
    nlines = randint(1, 8, n_ord)
    l_ok = ok.repeat_interleave(nlines)
    n_li = l_ok.shape[0]
    starts = torch.cumsum(nlines, 0, dtype=i32) - nlines
    l_ln = (torch.arange(n_li, device=dev, dtype=i32)
            - starts.repeat_interleave(nlines) + 1)
    l_od = odate.repeat_interleave(nlines)
    l_pk = randint(1, n_part + 1, n_li)
    l_sk = (l_pk - 1 + randint(0, 4, n_li) * step) % n_supp + 1
    qty = randint(1, 51, n_li)
    # a sprinkle of jumbo orders so Q18's sum(l_quantity) > 300 selects rows
    jumbo = rand(n_ord) < 0.02
    qty = torch.where(jumbo[l_ok - 1], randint(45, 51, n_li), qty)
    eprice = qty * retail[l_pk - 1]
    put("lineitem", "l_orderkey", l_ok)
    put("lineitem", "l_partkey", l_pk)
    put("lineitem", "l_suppkey", l_sk)
    put("lineitem", "l_linenumber", l_ln)
    put("lineitem", "l_quantity", qty * 100)
    put("lineitem", "l_extendedprice", eprice)
    disc = randint(0, 11, n_li)
    tax = randint(0, 9, n_li)
    put("lineitem", "l_discount", disc)
    put("lineitem", "l_tax", tax)
    ship = l_od + randint(1, 122, n_li)
    commit = l_od + randint(30, 91, n_li)
    receipt = ship + randint(1, 31, n_li)
    put("lineitem", "l_shipdate", ship)
    put("lineitem", "l_commitdate", commit)
    put("lineitem", "l_receiptdate", receipt)
    put("lineitem", "l_returnflag",
        torch.where(receipt <= CUTOFF, randint(0, 2, n_li), 2),
        {0: "R", 1: "A", 2: "N"})
    put("lineitem", "l_linestatus", (ship > CUTOFF).to(i32),
        {0: "F", 1: "O"})
    put("lineitem", "l_shipinstruct", randint(0, 4, n_li),
        dict(enumerate(SHIPINSTRUCT)))
    put("lineitem", "l_shipmode", randint(0, len(SHIPMODES), n_li),
        dict(enumerate(SHIPMODES)))
    put("lineitem", "l_comment", randint(0, 1000, n_li),
        _comment_vocab(rng, 1000))

    # o_totalprice: consistent with the lineitems
    net = (eprice.to(i64) * (100 - disc) * (100 + tax)) // 10000
    totals = torch.zeros(n_ord, dtype=i64, device=dev)
    totals.index_add_(0, (l_ok - 1).to(i64), net)
    put("orders", "o_totalprice", totals.to(i32))
    put("orders", "o_orderstatus", (rand(n_ord) < 0.5).to(i32),
        {0: "O", 1: "F"})
    return t


def _phones(randint, n: int, nsuffix: int = 997):
    """Phones ``<cc>-<suffix>`` with cc = 10 + a random nation, as codes
    that combine cc and a suffix id, and the dictionary of the codes
    drawn."""
    codes = (10 + randint(0, 25, n)) * nsuffix + randint(0, nsuffix, n)
    dec = {}
    for code in torch.unique(codes).tolist():
        c, sfx = divmod(code, nsuffix)
        dec[code] = f"{c}-{100 + sfx % 900}-{200 + sfx % 800}-{1000 + sfx}"
    return codes, dec
