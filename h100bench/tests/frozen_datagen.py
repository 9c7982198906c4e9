"""A frozen copy of the engine's numpy generator (``engine/datagen.py``
``generate``), the yardstick ``gen.py``'s tables are held to: the same
tables, columns, dictionaries and value distributions.  Only the store is
replaced by ``Store``, which keeps each column as given (int64) and its
dictionary; the join-index columns are left out."""

from __future__ import annotations

import numpy as np


class Store:
    """The columns (``(table, column)`` -> int64 array) and dictionaries
    of one generated database."""

    def __init__(self):
        self.columns, self.decoders = {}, {}

    def add(self, tab, col, data):
        self.columns[(tab, col)] = np.asarray(data, dtype=np.int64)

    def add_strings(self, tab, col, values):
        uniq, codes = np.unique(np.asarray(values, dtype=object),
                                return_inverse=True)
        self.columns[(tab, col)] = codes.reshape(-1).astype(np.int64)
        self.decoders[(tab, col)] = dict(enumerate(uniq.tolist()))

    def add_categorical(self, tab, col, codes, decoder):
        self.columns[(tab, col)] = np.asarray(codes, dtype=np.int64)
        self.decoders[(tab, col)] = dict(decoder)


# ---------------------------------------------------------------- vocabularies
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

# (nation, region index) — the standard TPC-H nation table
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
             "AIR REG"]  # Q19 compares against 'AIR REG'
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

# day-count anchors (days since 0000-01-01, proleptic Gregorian)
import datetime


def _day(y, m, d):
    return datetime.date(y, m, d).toordinal() + 365


DATE_LO = _day(1992, 1, 1)
DATE_HI = _day(1998, 8, 2)


def _comment_codes(rng, n: int, vocab_size: int, special: str = None,
                   special_rate: float = 0.0):
    """A bounded-vocabulary comment column as (codes, decoder): vocab_size
    distinct strings assigned randomly, optionally splicing a '<a> ... <b>'
    special pattern.  No per-row Python strings — scales to SF100."""
    vocab = []
    for i in range(vocab_size):
        w = rng.choice(COMMENT_WORDS, size=4)
        s = " ".join(w.tolist())
        if special and rng.random() < special_rate:
            a, b = special.split(" ", 1)
            s = f"{w[0]} {a} {w[1]} {b} {w[2]}"
        vocab.append(f"{s} {i}")
    codes = rng.integers(0, vocab_size, size=n)
    return codes, dict(enumerate(vocab))


def _id_codes(prefix: str, n: int, vocab: int = 1024):
    """Opaque per-row strings (names/addresses) as a bounded dictionary; no
    query applies LIKE to these, so a modest vocabulary is sufficient."""
    return None, {i: f"{prefix}{i:09d}" for i in range(vocab)}


def _phone_codes(rng, nat: np.ndarray, nsuffix: int = 997):
    """Phones '<cc>-<suffix>' with cc = 10 + a random nation; codes combine
    cc and a suffix id so Q22's substring-prefix classes stay meaningful."""
    cc = 10 + rng.integers(0, 25, size=len(nat))
    suf = rng.integers(0, nsuffix, size=len(nat))
    codes = cc * nsuffix + suf
    dec = {}
    for code in np.unique(codes):
        c, sfx = divmod(int(code), nsuffix)
        dec[int(code)] = f"{c}-{100 + sfx % 900}-{200 + sfx % 800}-{1000 + sfx}"
    return codes, dec



def generate(sf: float, seed: int = 0) -> "Store":
    rng = np.random.default_rng(seed)
    store = Store()

    n_part = max(int(200_000 * sf), 20)
    n_supp = max(int(10_000 * sf), 10)
    n_cust = max(int(150_000 * sf), 15)
    n_ord = max(int(1_500_000 * sf), 150)

    # ---- region / nation
    store.add("region", "r_regionkey", np.arange(5))
    store.add_strings("region", "r_name", np.array(REGIONS))
    store.add_strings("region", "r_comment",
                      np.array([f"region comment {i}" for i in range(5)]))
    store.add("nation", "n_nationkey", np.arange(25))
    store.add_strings("nation", "n_name", np.array([n for n, _ in NATIONS]))
    store.add("nation", "n_regionkey", np.array([r for _, r in NATIONS]))
    store.add_strings("nation", "n_comment",
                      np.array([f"nation comment {i}" for i in range(25)]))

    # ---- part
    pk = np.arange(1, n_part + 1)
    store.add("part", "p_partkey", pk)
    name_vocab = min(max(n_part // 8, 200), 20000)
    c5 = rng.integers(0, len(COLORS), size=(name_vocab, 5))
    pn_dec = {i: " ".join(COLORS[j] for j in row) for i, row in enumerate(c5)}
    store.add_categorical("part", "p_name",
                          rng.integers(0, name_vocab, size=n_part), pn_dec)
    mfgr = rng.integers(1, 6, size=n_part)
    store.add_categorical("part", "p_mfgr", mfgr - 1,
                          {i: f"Manufacturer#{i+1}" for i in range(5)})
    brand = mfgr * 10 + rng.integers(1, 6, size=n_part)
    store.add_categorical("part", "p_brand", brand,
                          {b: f"Brand#{b}" for b in range(11, 56)})
    tcode = rng.integers(0, 150, size=n_part)
    tdec = {a * 25 + b * 5 + c: f"{TYPE_S1[a]} {TYPE_S2[b]} {TYPE_S3[c]}"
            for a in range(6) for b in range(5) for c in range(5)}
    store.add_categorical("part", "p_type", tcode, tdec)
    store.add("part", "p_size", rng.integers(1, 51, size=n_part))
    store.add_categorical("part", "p_container",
                          rng.integers(0, 40, size=n_part),
                          {a * 8 + b: f"{CONT_S1[a]} {CONT_S2[b]}"
                           for a in range(5) for b in range(8)})
    retail = 90000 + (pk % 20001) + 100 * (pk % 1000) % 110000
    store.add("part", "p_retailprice", retail)
    cc, cd = _comment_codes(rng, n_part, 200)
    store.add_categorical("part", "p_comment", cc, cd)

    # ---- supplier
    sk = np.arange(1, n_supp + 1)
    store.add("supplier", "s_suppkey", sk)
    _, sdec = _id_codes("Supplier#", n_supp)
    store.add_categorical("supplier", "s_name", sk % 1024, sdec)
    store.add_categorical("supplier", "s_address", (sk * 7) % 1024,
                          {i: f"supp addr {i}" for i in range(1024)})
    s_nat = rng.integers(0, 25, size=n_supp)
    store.add("supplier", "s_nationkey", s_nat)
    pc, pd = _phone_codes(rng, s_nat)
    store.add_categorical("supplier", "s_phone", pc, pd)
    store.add("supplier", "s_acctbal",
              rng.integers(-99999, 1000000, size=n_supp))
    cc, cd = _comment_codes(rng, n_supp, max(200, n_supp // 10),
                            special="Customer Complaints", special_rate=0.02)
    store.add_categorical("supplier", "s_comment", cc, cd)

    # ---- partsupp: 4 suppliers per part
    step = max(n_supp // 4, 1)
    ps_p = np.repeat(pk, 4)
    ps_s = np.empty(n_part * 4, dtype=np.int64)
    for i in range(4):
        ps_s[i::4] = (pk - 1 + i * step) % n_supp + 1
    store.add("partsupp", "ps_partkey", ps_p)
    store.add("partsupp", "ps_suppkey", ps_s)
    store.add("partsupp", "ps_availqty",
              rng.integers(1, 10000, size=n_part * 4))
    store.add("partsupp", "ps_supplycost",
              rng.integers(100, 100001, size=n_part * 4))
    cc, cd = _comment_codes(rng, n_part * 4, 200)
    store.add_categorical("partsupp", "ps_comment", cc, cd)

    # ---- customer
    ck = np.arange(1, n_cust + 1)
    store.add("customer", "c_custkey", ck)
    _, cdec = _id_codes("Customer#", n_cust)
    store.add_categorical("customer", "c_name", ck % 1024, cdec)
    store.add_categorical("customer", "c_address", (ck * 13) % 1024,
                          {i: f"cust addr {i}" for i in range(1024)})
    c_nat = rng.integers(0, 25, size=n_cust)
    store.add("customer", "c_nationkey", c_nat)
    pc, pd = _phone_codes(rng, c_nat)
    store.add_categorical("customer", "c_phone", pc, pd)
    store.add("customer", "c_acctbal",
              rng.integers(-99999, 1000000, size=n_cust))
    store.add_categorical("customer", "c_mktsegment",
                          rng.integers(0, 5, size=n_cust),
                          dict(enumerate(MKTSEGMENTS)))
    cc, cd = _comment_codes(rng, n_cust, 500)
    store.add_categorical("customer", "c_comment", cc, cd)

    # ---- orders
    ok = np.arange(1, n_ord + 1)
    store.add("orders", "o_orderkey", ok)
    # a third of customers never place orders (TPC-H: custkey % 3 == 0),
    # keeping the Q13/Q22 no-orders paths meaningful
    ocust = rng.integers(1, n_cust + 1, size=n_ord)
    ocust = np.where(ocust % 3 == 0, (ocust % n_cust) + 1, ocust)
    ocust = np.where(ocust % 3 == 0, ((ocust + 1) % n_cust) + 1, ocust)
    store.add("orders", "o_custkey", ocust)
    odate = rng.integers(DATE_LO, DATE_HI - 151, size=n_ord)
    store.add("orders", "o_orderdate", odate)
    store.add("orders", "o_shippriority", np.zeros(n_ord, dtype=np.int64))
    store.add_categorical("orders", "o_orderpriority",
                          rng.integers(0, 5, size=n_ord),
                          dict(enumerate(ORDERPRIORITY)))
    store.add_categorical("orders", "o_clerk",
                          rng.integers(0, 1024, size=n_ord),
                          {i: f"Clerk#{i:09d}" for i in range(1024)})
    cc, cd = _comment_codes(rng, n_ord, 2000, special="special requests",
                            special_rate=0.05)
    store.add_categorical("orders", "o_comment", cc, cd)

    # ---- lineitem: 1-7 lines per order
    nlines = rng.integers(1, 8, size=n_ord)
    l_ok = np.repeat(ok, nlines)
    l_od = np.repeat(odate, nlines)
    n_li = len(l_ok)
    l_ln = np.concatenate([np.arange(1, k + 1) for k in nlines])
    l_pk = rng.integers(1, n_part + 1, size=n_li)
    which = rng.integers(0, 4, size=n_li)
    l_sk = (l_pk - 1 + which * step) % n_supp + 1
    qty = rng.integers(1, 51, size=n_li)
    # a sprinkle of jumbo orders so Q18's sum(l_quantity) > 300 selects rows
    jumbo = rng.random(n_ord) < 0.02
    qty = np.where(jumbo[l_ok - 1], rng.integers(45, 51, size=n_li), qty)
    price_of_part = retail  # indexed by partkey-1
    eprice = qty * price_of_part[l_pk - 1]
    store.add("lineitem", "l_orderkey", l_ok)
    store.add("lineitem", "l_partkey", l_pk)
    store.add("lineitem", "l_suppkey", l_sk)
    store.add("lineitem", "l_linenumber", l_ln)
    store.add("lineitem", "l_quantity", qty * 100)
    store.add("lineitem", "l_extendedprice", eprice)
    store.add("lineitem", "l_discount", rng.integers(0, 11, size=n_li))
    store.add("lineitem", "l_tax", rng.integers(0, 9, size=n_li))
    ship = l_od + rng.integers(1, 122, size=n_li)
    commit = l_od + rng.integers(30, 91, size=n_li)
    receipt = ship + rng.integers(1, 31, size=n_li)
    store.add("lineitem", "l_shipdate", ship)
    store.add("lineitem", "l_commitdate", commit)
    store.add("lineitem", "l_receiptdate", receipt)
    cutoff = _day(1995, 6, 17)
    rf = np.where(receipt <= cutoff,
                  rng.integers(0, 2, size=n_li),  # 0=R 1=A
                  2)  # N
    store.add_categorical("lineitem", "l_returnflag", rf,
                          {0: "R", 1: "A", 2: "N"})
    store.add_categorical("lineitem", "l_linestatus",
                          (ship > cutoff).astype(np.int64),
                          {0: "F", 1: "O"})
    store.add_categorical("lineitem", "l_shipinstruct",
                          rng.integers(0, 4, size=n_li),
                          dict(enumerate(SHIPINSTRUCT)))
    store.add_categorical("lineitem", "l_shipmode",
                          rng.integers(0, len(SHIPMODES), size=n_li),
                          dict(enumerate(SHIPMODES)))
    cc, cd = _comment_codes(rng, n_li, 1000)
    store.add_categorical("lineitem", "l_comment", cc, cd)

    # o_totalprice: consistent with lineitems (sum extprice*(1+tax)*(1-disc))
    disc = store.columns[("lineitem", "l_discount")]
    tax = store.columns[("lineitem", "l_tax")]
    net = (eprice * (100 - disc) * (100 + tax)) // 10000
    totals = np.zeros(n_ord + 1, dtype=np.int64)
    np.add.at(totals, l_ok, net)
    store.add("orders", "o_totalprice", totals[1:])
    store.add_categorical("orders", "o_orderstatus",
                          (rng.random(n_ord) < 0.5).astype(np.int64),
                          {0: "O", 1: "F"})

    return store
