"""Distributed shuffle equijoin: hash-partitioned build + probe routing.

The port of ``mplan2vdl_tpu/parallel/shuffle_join.py`` over a
``torch.distributed`` group (``dist.Mesh``); every rank runs the same calls
on its own rows:

  build exchange:  each rank routes its LOCAL right rows (key + payload
                   columns) to the key's owner rank — one all-to-all per
                   array; after it, each owner holds exactly its share of
                   the whole right side
  probe exchange:  each rank routes its local left (probe) keys, tagged
                   with their bucket slot, to the same owners
  owner match:     sort the received right set once; binary-search every
                   received probe key (the single-device engine's
                   sort-merge core); expand match pairs grouped by the
                   probe's SOURCE rank
  route back:      per-probe-row match counts and the expanded pairs
                   (right payloads attached) return to the probe rank, so
                   downstream work stays rank-local; semi/anti/outer
                   variants derive from the returned counts

Every shape is fixed up front: per-destination bucket capacities are set
before the exchange and overflow is DETECTED (an all-reduced counter) so
the caller can retry with doubled capacity (``ShuffleJoin.__call__``
does).  Heavy-hitter keys take a broadcast path instead (see below).

Every host decision (the retry, the heavy plan) reads values all-reduced
over the ranks, so every rank takes the same branch and reaches the same
collectives.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import partial
from typing import List, Sequence

import numpy as np
import torch

from ..engine import mergesearch, scan
from . import dist

SENT_R = 2**62      # invalid right key: sorts after all keys
SENT_L = 2**62 - 1  # invalid left key: never equals a right key

MASK32 = 0xFFFFFFFF


def key_sents(dtype):
    """(SENT_R, SENT_L) for a key dtype.  int32 keys (bounds permitting)
    halve the exchange's key bytes."""
    if dtype == torch.int32:
        return 2**31 - 1, 2**31 - 2
    return SENT_R, SENT_L


def _fused_all_to_all(arrays, mesh):
    """The build keys, build payloads and probe keys are independent, so
    their exchanges CAN combine into one collective per dtype group
    (MPLAN2VDL_FUSED_EXCHANGE=1: concatenate along the bucket axis, one
    all-to-all, slice).  Default: one all-to-all per array."""
    if os.environ.get("MPLAN2VDL_FUSED_EXCHANGE", "0") in ("", "0"):
        return [dist.all_to_all(mesh, a) for a in arrays]
    groups: dict = {}
    for i, a in enumerate(arrays):
        groups.setdefault(a.dtype, []).append(i)
    out = [None] * len(arrays)
    for idxs in groups.values():
        if len(idxs) == 1:
            out[idxs[0]] = dist.all_to_all(mesh, arrays[idxs[0]])
            continue
        widths = [int(arrays[i].shape[1]) for i in idxs]
        ex = dist.all_to_all(mesh, torch.cat([arrays[i] for i in idxs], 1))
        for i, part in zip(idxs, torch.split(ex, widths, dim=1)):
            out[i] = part
    return out


def _bucket(dest, n_dev, cap, arrays, fills):
    """Scatter rows into (n_dev, cap) per-destination buckets.

    ``dest`` in [0, n_dev]; n_dev = drop.  Rows past a bucket's capacity
    overwrite its last slot and are counted in ``overflow`` (the caller
    retries with doubled cap, so the corruption never escapes)."""
    order, ds, within = dist.sort_by_dest(dest, n_dev + 1)
    live = ds < n_dev
    overflow = ((within >= cap) & live).sum()
    slot = torch.where(live, ds * cap + torch.clamp(within, max=cap - 1),
                       n_dev * cap)
    outs = []
    for a, fill in zip(arrays, fills):
        buf = torch.full((n_dev * cap + 1,), fill, dtype=a.dtype,
                         device=a.device)
        buf[slot] = a[order]
        outs.append(buf[:n_dev * cap].reshape(n_dev, cap))
    return outs, overflow


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32): two 16-bit halves of
    ``c``, so no int64 product overflows (uint32 wraparound arithmetic)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _hash32(keys):
    """Fibonacci multiply + xor-shift of the key's low 32 bits (JAX's
    ``astype(uint32)``), as int64 in [0, 2^32)."""
    h = _mul32(keys.to(torch.int64) & MASK32, 0x9E3779B1)
    return h ^ (h >> 16)


def owner_dest(keys, key_lo, key_hi, n_dev):
    """HASH-partition owner of each key; invalid (>= SENT_L) -> n_dev.

    Hashing instead of key-range splitting: equal-width ranges from
    catalog bounds hotspot one owner whenever the live keys cluster in a
    narrow band.  key_lo/key_hi are kept for signature stability; only the
    sentinel check uses the dtype."""
    _, sent_l = key_sents(keys.dtype)
    d = (_hash32(keys) % n_dev).to(keys.dtype)
    return torch.where(keys < sent_l, d, n_dev)


def dest_histogram(dest, n_dev):
    """Rows per destination (n_dev,), dropped rows excluded."""
    return torch.bincount(torch.clamp(dest.to(torch.int64), 0, n_dev),
                          minlength=n_dev + 1)[:n_dev]


# --------------------------------------------------------------- skew/heavy
# A heavy-hitter key sends ALL its build rows and ALL its probes to one
# hash owner; capacity-doubling retries then inflate EVERY rank's buffers
# to fit that one owner's load.  Skew-aware plan: detect heavy keys in the
# counting round, BROADCAST their build rows to every rank (all-gather of a
# small exact-capacity buffer), and match their probes LOCALLY — heavy
# probes never enter the exchange, so no owner hotspots.


def _member_lohi(keys, hs):
    """(lo, hit) of each key against a small sorted sentinel-padded table
    ``hs`` (the replicated heavy-key list)."""
    lo = torch.searchsorted(hs, keys.to(hs.dtype))
    i = torch.clamp(lo, max=hs.shape[0] - 1)
    return i, hs[i] == keys


def shard_heavy_detect(lkeys, rkeys, n_dev, H=16, min_cnt=64, frac=0.5,
                       *, mesh: dist.Mesh):
    """Heavy-hitter detection round (rank-side).

    Each rank sorts its local keys once per side, takes its top-``H``
    keys by run length as candidates, and all-gathers them; exact GLOBAL
    per-candidate counts come from local searchsorted + all-reduce.  A key
    is heavy when its global count on either side exceeds
    max(min_cnt, frac * total_side / n_dev), or its pair product alone
    would blow one owner's pair block.

    Returns (heavy_sorted (2*H*n_dev,) sentinel-padded ascending,
             rcnt_sorted  global BUILD count aligned with heavy_sorted,
             n_heavy, cap_hb, cap_hp) where cap_hb = max local heavy
    build rows on any rank and cap_hp = max local heavy pairs on any
    rank — both EXACT, so the heavy path needs no capacity retries."""
    sent_r, sent_l = key_sents(lkeys.dtype)
    big = sent_r  # sorts after every real key on either side
    ls = torch.sort(lkeys).values
    rs = torch.sort(rkeys).values

    def top_keys(s, sent):
        n = s.shape[0]
        start = torch.ones(n, dtype=torch.bool, device=s.device)
        start[1:] = s[1:] != s[:-1]
        rid = scan.cumsum_flags(start) - 1
        per_run = torch.bincount(rid, minlength=n)
        cnt = torch.where(start & (s < sent), per_run[rid], 0)
        # lax.top_k: the largest counts, the lower index first on ties
        pos = torch.sort(cnt, descending=True, stable=True).indices[:H]
        keys = s[pos]
        if n < H:  # tiny shard: pad candidates to the static width
            keys = torch.cat([keys, torch.full((H - n,), big,
                                               dtype=s.dtype,
                                               device=s.device)])
        return keys

    cand = torch.cat([top_keys(ls, sent_l), top_keys(rs, sent_r)])
    allc = torch.sort(dist.all_gather(mesh, cand).reshape(-1)).values
    dup = torch.zeros(allc.shape[0], dtype=torch.bool, device=allc.device)
    dup[1:] = allc[1:] == allc[:-1]
    allc = torch.sort(torch.where(dup | (allc >= sent_l), big, allc)).values

    def counts(sorted_side):
        lo, hi = mergesearch.lo_hi(sorted_side, allc)
        return hi - lo

    lc_loc, rc_loc = counts(ls), counts(rs)
    lc_g = dist.psum(mesh, lc_loc)
    rc_g = dist.psum(mesh, rc_loc)
    total_l = dist.psum(mesh, (lkeys < sent_l).sum())
    total_r = dist.psum(mesh, (rkeys < sent_r).sum())
    f = int(frac * 1024)
    th_l = torch.clamp(total_l * f // (1024 * n_dev), min=min_cnt)
    th_r = torch.clamp(total_r * f // (1024 * n_dev), min=min_cnt)
    # a key is ALSO heavy when its pair product alone would blow one
    # owner's per-source pair block: all lc*rc pairs of a key land on a
    # single owner in the exchange plan
    th_p = torch.clamp(torch.maximum(total_l, total_r) * f // (1024 * n_dev),
                       min=min_cnt)
    heavy = (((lc_g >= th_l) | (rc_g >= th_r) | (lc_g * rc_g >= th_p))
             & (allc < sent_l))
    # the heavy keys are distinct and the rest carry zeros, so the order
    # among equal sort keys cannot show
    hk_s, order = torch.sort(torch.where(heavy, allc, big), stable=True)
    rc_s = torch.where(heavy, rc_g, 0)[order]
    lc_ls = torch.where(heavy, lc_loc, 0)[order]
    rc_ls = torch.where(heavy, rc_loc, 0)[order]
    n_heavy = heavy.sum()
    cap_hb = dist.pmax(mesh, rc_ls.sum())
    cap_hp = dist.pmax(mesh, (lc_ls * rc_s).sum())
    return hk_s, rc_s, n_heavy, cap_hb, cap_hp


def _extract_heavy(keys, payloads, hmask, cap_hb, sent):
    """Compact this rank's heavy build rows into a (cap_hb,) buffer
    (exact-capacity, overflow counted for the retry contract)."""
    pos = scan.cumsum_flags(hmask) - 1
    slot = torch.where(hmask, torch.clamp(pos, max=cap_hb - 1), cap_hb)
    ovr = torch.clamp(hmask.sum() - cap_hb, min=0)
    outs = []
    for a, fill in zip([keys] + list(payloads),
                       [sent] + [0] * len(payloads)):
        buf = torch.full((cap_hb + 1,), fill, dtype=a.dtype, device=a.device)
        buf[slot] = a
        outs.append(buf[:cap_hb])
    return outs, ovr


def _expand(cnt, lo, n_pairs, m):
    """Pair expansion of one or more blocks of probe rows (the last axis):
    pair ``k`` of a block belongs to the probe row ``j`` whose cumulative
    count first passes ``k`` and reads sorted build row ``lo[j] + k -
    base``.  Returns (probe row, build row, ok, pairs past ``n_pairs``)."""
    cum = torch.cumsum(cnt, -1)
    total = cum[..., -1]
    k = torch.arange(n_pairs, device=cnt.device).expand(
        *cnt.shape[:-1], n_pairs).contiguous()
    j = torch.searchsorted(cum, k, right=True)
    j_c = torch.clamp(j, 0, cnt.shape[-1] - 1)
    base = torch.gather(cum, -1, j_c) - torch.gather(cnt, -1, j_c)
    rpos = torch.clamp(torch.gather(lo, -1, j_c) + (k - base), 0, m - 1)
    ok = k < torch.clamp(total, max=n_pairs).unsqueeze(-1)
    return j_c, rpos, ok, torch.clamp(total - n_pairs, min=0)


def _heavy_local_match(lkeys, lheavy, hb_keys, hb_pays, cap_hp):
    """Match this rank's heavy probes against the broadcast heavy build
    set — all local, no exchange, so heavy work stays where the probe
    rows already live."""
    _, sent_l = key_sents(lkeys.dtype)
    kb = hb_keys.shape[0]
    hbs, order = torch.sort(hb_keys, stable=True)
    hbp = [p[order] for p in hb_pays]
    lkh = torch.where(lheavy, lkeys, sent_l)
    lo, hi = mergesearch.lo_hi(hbs, lkh)
    cnt_h = hi - lo  # sentinel probes count 0
    j_c, rpos, ok, ovr = _expand(cnt_h, lo, cap_hp, kb)
    return dict(lidx=j_c, ok=ok, pays=[p[rpos] for p in hbp],
                cnt=cnt_h, overflow=ovr)


def shard_join_count_stats(lkeys, rkeys, *, key_lo, key_hi, n_dev,
                           cap_r, cap_l, heavy_keys=None, heavy_rcnt=None,
                           mesh: dist.Mesh):
    """Exchange-count round (no pair expansion): the exact capacities the
    main join program needs.  Returns, all-reduced over the ranks,
    (max pairs in any (owner, source-rank) block  -> cap_pairs,
     max pairs landing on any probe rank          -> cap_exp,
     max UNMATCHED probe rows on any rank         -> cap_un (outer),
     global pair total, global unmatched total, exchange overflow).

    With ``heavy_keys`` (sorted sentinel-padded, + aligned global build
    counts ``heavy_rcnt`` from shard_heavy_detect), heavy rows are
    EXCLUDED from the exchange (they take the broadcast-local path in
    shard_shuffle_join); unmatched accounting still sees the heavy
    matches."""
    nl = lkeys.shape[0]
    dev = lkeys.device
    sent_r, sent_l = key_sents(lkeys.dtype)
    lvalid = lkeys < sent_l
    heavy_cnt_row = torch.zeros(nl, dtype=torch.int64, device=dev)
    if heavy_keys is not None:
        hi_l, hit_l = _member_lohi(lkeys, heavy_keys)
        heavy_cnt_row = torch.where(hit_l & lvalid, heavy_rcnt[hi_l], 0)
        lkeys = torch.where(hit_l, sent_l, lkeys)
        _, hit_r = _member_lohi(rkeys, heavy_keys)
        rkeys = torch.where(hit_r, sent_r, rkeys)
    (bk,), ovr_r = _bucket(owner_dest(rkeys, key_lo, key_hi, n_dev),
                           n_dev, cap_r, [rkeys], [sent_r])
    (lk_b, lidx_b), ovr_l = _bucket(
        owner_dest(lkeys, key_lo, key_hi, n_dev), n_dev, cap_l,
        [lkeys, torch.arange(nl, device=dev)], [sent_l, nl])
    rk_own = dist.all_to_all(mesh, bk).reshape(-1)
    lk_own = dist.all_to_all(mesh, lk_b)
    lo, hi = mergesearch.lo_hi(torch.sort(rk_own).values, lk_own.reshape(-1))
    cnt_own = (hi - lo).reshape(n_dev, cap_l)
    totals_src = cnt_own.sum(1)  # per source rank, at this owner
    cnt_back = dist.all_to_all(mesh, cnt_own)
    my_total = cnt_back.sum()
    # per-local-row counts -> unmatched VALID probe rows on this rank
    # (heavy probes count via their key's global build count)
    cnt = torch.zeros(nl + 1, dtype=torch.int64, device=dev).index_add_(
        0, lidx_b.reshape(-1), cnt_back.reshape(-1))[:nl] + heavy_cnt_row
    my_un = ((cnt == 0) & lvalid).sum()
    my_heavy = heavy_cnt_row.sum()  # heavy pairs stay on this rank
    return (dist.pmax(mesh, totals_src.max()),
            dist.pmax(mesh, my_total + my_heavy),
            dist.pmax(mesh, my_un),
            dist.psum(mesh, totals_src.sum() + my_heavy),
            dist.psum(mesh, my_un),
            dist.psum(mesh, ovr_r + ovr_l))


def shard_shuffle_join(lkeys, rkeys, rpayloads, *, key_lo, key_hi, n_dev,
                       cap_r, cap_l, cap_pairs, heavy_keys=None,
                       cap_hb=0, cap_hp=0, mesh: dist.Mesh):
    """The rank-side join body; every rank of ``mesh`` calls it.

    ``lkeys``/``rkeys``: this rank's local probe/build keys, invalid rows
    pre-set to SENT_L/SENT_R.  ``rpayloads``: columns riding with each
    right row (at minimum its global right position).

    ``heavy_keys`` (sorted, sentinel-padded, replicated — from
    shard_heavy_detect) activates the skew path: heavy BUILD rows are
    extracted into a (cap_hb,) buffer and all-gathered (broadcast join),
    heavy PROBES match against that broadcast set locally and never enter
    the exchange.  Heavy pairs are appended after the exchange pairs
    (cap_hp extra slots per rank).

    Returns dict:
      lidx       (n_dev*cap_pairs + cap_hp,) local probe row of each pair
      pair_ok    bool mask of real pairs
      payloads   right payload value per pair
      cnt        (len(lkeys),) per-local-probe-row global match count
      overflow   scalar: total dropped rows across all exchanges
                 (all-reduced, so every rank sees the same value)
    """
    sent_r, sent_l = key_sents(lkeys.dtype)
    heavy = None
    ovr_h = torch.zeros((), dtype=torch.int64, device=lkeys.device)
    if heavy_keys is not None:
        # the pad value in heavy_keys is a sentinel, so AND with validity
        # (an invalid row must never ride the broadcast buffer)
        _, lheavy = _member_lohi(lkeys, heavy_keys)
        lheavy = lheavy & (lkeys < sent_l)
        _, rheavy = _member_lohi(rkeys, heavy_keys)
        rheavy = rheavy & (rkeys < sent_r)
        (hb_k, *hb_p), ovr_hb = _extract_heavy(rkeys, rpayloads, rheavy,
                                               cap_hb, sent_r)
        hb_keys = dist.all_gather(mesh, hb_k).reshape(-1)
        hb_pays = [dist.all_gather(mesh, p).reshape(-1) for p in hb_p]
        heavy = _heavy_local_match(lkeys, lheavy, hb_keys, hb_pays, cap_hp)
        ovr_h = ovr_hb + heavy["overflow"]
        # the exchange sees sentinels where the broadcast path took over
        lkeys = torch.where(lheavy, sent_l, lkeys)
        rkeys = torch.where(rheavy, sent_r, rkeys)
    S = _pipeline_stages()
    if S > 1:
        # pipelined exchange (opt-in): keys are split into S hash
        # sub-ranges and each runs the full exchange→sort→probe→route-back
        # chain on its own, ~1/S of the caps each (margin +64); sub-range
        # skew is caught by the normal overflow retry
        sub_l = _subrange_id(lkeys, n_dev, S)
        sub_r = _subrange_id(rkeys, n_dev, S)
        caps = [max(-(-c // S) + 64, 128)
                for c in (cap_r, cap_l, cap_pairs)]
        parts = []
        for s in range(S):
            lk_s = torch.where(sub_l == s, lkeys, sent_l)
            rk_s = torch.where(sub_r == s, rkeys, sent_r)
            parts.append(_exchange_match(
                lk_s, rk_s, rpayloads, key_lo=key_lo, key_hi=key_hi,
                n_dev=n_dev, cap_r=caps[0], cap_l=caps[1],
                cap_pairs=caps[2], mesh=mesh))
        lidx_out = torch.cat([p[0] for p in parts])
        pair_ok = torch.cat([p[1] for p in parts])
        pays_out = [torch.cat(cols) for cols in zip(*[p[2] for p in parts])]
        cnt = sum(p[3] for p in parts)
        ovr_x = sum(p[4] for p in parts)
    else:
        lidx_out, pair_ok, pays_out, cnt, ovr_x = _exchange_match(
            lkeys, rkeys, rpayloads, key_lo=key_lo, key_hi=key_hi,
            n_dev=n_dev, cap_r=cap_r, cap_l=cap_l, cap_pairs=cap_pairs,
            mesh=mesh)
    overflow = dist.psum(mesh, ovr_x + ovr_h)
    if heavy is not None:  # broadcast-path pairs appended per rank
        lidx_out = torch.cat(
            [lidx_out, torch.where(heavy["ok"], heavy["lidx"], 0)])
        pair_ok = torch.cat([pair_ok, heavy["ok"]])
        pays_out = [torch.cat([p, hp.to(p.dtype)])
                    for p, hp in zip(pays_out, heavy["pays"])]
        cnt = cnt + heavy["cnt"]
    return dict(lidx=lidx_out, pair_ok=pair_ok, payloads=pays_out,
                cnt=cnt, overflow=overflow)


def _pipeline_stages() -> int:
    """MPLAN2VDL_PIPELINE_EXCHANGE=S splits the join exchange into S
    independent hash sub-ranges (0/1 = off, the single exchange).  Read at
    each call."""
    try:
        return max(int(os.environ.get(
            "MPLAN2VDL_PIPELINE_EXCHANGE", "0")), 1)
    except ValueError:
        return 1


def _subrange_id(keys, n_dev, S):
    """Pipeline sub-range of each key, decorrelated from the owner hash
    (owner_dest uses h % n_dev; this uses a second multiplicative mix),
    so every (owner, sub-range) cell sees ~1/(n_dev*S) of the keys.
    Invalid (sentinel) keys map to S — outside every sub-range.  int32."""
    _, sent_l = key_sents(keys.dtype)
    h2 = _mul32(_hash32(keys) // n_dev, 0x85EBCA6B)
    h2 = h2 ^ (h2 >> 13)
    s = (h2 % S).to(torch.int32)
    return torch.where(keys < sent_l, s, S)


def _exchange_match(lkeys, rkeys, rpayloads, *, key_lo, key_hi, n_dev,
                    cap_r, cap_l, cap_pairs, mesh: dist.Mesh):
    """One complete exchange→owner-sort-merge→expand→route-back chain
    over the given key set (sentinel rows ignored).  Returns
    (lidx (n_dev*cap_pairs,), pair_ok, payload list, per-local-row cnt,
    local overflow — NOT yet all-reduced)."""
    sent_r, sent_l = key_sents(lkeys.dtype)
    dev = lkeys.device
    # ---- build + probe exchange: right rows to their key's owner and
    # left keys (tagged with local row) to the same owners
    nl = lkeys.shape[0]
    (bk, *bps), ovr_r = _bucket(
        owner_dest(rkeys, key_lo, key_hi, n_dev), n_dev, cap_r,
        [rkeys] + list(rpayloads), [sent_r] + [0] * len(rpayloads))
    (lk_b, lidx_b), ovr_l = _bucket(
        owner_dest(lkeys, key_lo, key_hi, n_dev), n_dev, cap_l,
        [lkeys, torch.arange(nl, device=dev)], [sent_l, nl])
    bk_x, lk_own, *bps_x = _fused_all_to_all([bk, lk_b] + list(bps), mesh)
    # lk_own: (n_dev=src, cap_l)

    # ---- owner-side sort-merge: one sort of the owned right rows, the
    # payloads permuted with it (stable; JAX's one-key sort is not, so
    # pairs within one key compare as multisets)
    rs, order = torch.sort(bk_x.reshape(-1), stable=True)
    rp_sorted = [b.reshape(-1)[order] for b in bps_x]
    m = rs.shape[0]
    lo, hi = mergesearch.lo_hi(rs, lk_own.reshape(-1))
    lo = lo.reshape(n_dev, cap_l)
    cnt_own = hi.reshape(n_dev, cap_l) - lo  # SENT_L probes: cnt 0

    # ---- expand pairs per SOURCE rank (each row block returns home)
    slot_p, rpos_p, ok_p, dropped = _expand(cnt_own, lo, cap_pairs, m)
    ovr_p = dropped.sum()
    pay_p = [p[rpos_p] for p in rp_sorted]  # (n_dev, cap_pairs) each

    # ---- route back: counts and pairs land on the probe rank
    cnt_back, slot_back, *pay_back = _fused_all_to_all(
        [cnt_own, torch.where(ok_p, slot_p, cap_l)] + pay_p, mesh)
    # cnt_back: (n_dev=owner, cap_l); slot_back invalid slots -> cap_l

    # per-local-row count: each probe row went to exactly ONE owner, so a
    # scatter-add over bucket slots reassembles it (the fill row nl is the
    # dump slot)
    cnt = torch.zeros(nl + 1, dtype=torch.int64, device=dev).index_add_(
        0, lidx_b.reshape(-1), cnt_back.reshape(-1))[:nl]
    # pair probe rows: bucket slot -> the local row this rank put there
    lidx_pad = torch.cat(
        [lidx_b, torch.full((n_dev, 1), nl, dtype=torch.int64, device=dev)],
        dim=1)
    lidx_pairs = torch.gather(lidx_pad, 1,
                              torch.clamp(slot_back, max=cap_l)).reshape(-1)
    pair_ok = (slot_back.reshape(-1) < cap_l) & (lidx_pairs < nl)

    lidx_out = torch.where(pair_ok, lidx_pairs, 0)
    pays_out = [p.reshape(-1) for p in pay_back]
    return lidx_out, pair_ok, pays_out, cnt, ovr_r + ovr_l + ovr_p


@dataclass
class ShuffleJoin:
    """Distributed equijoin over pre-sharded keys.

    ``key_bounds``: (lo, hi] key value range from catalog bounds.
    ``n_payload`` right columns ride the exchange (ship the global right
    position to reconstruct pairs).  Capacities start at a uniform-keys
    estimate and double on overflow.
    """

    mesh: dist.Mesh
    shard_rows_l: int
    shard_rows_r: int
    key_bounds: tuple
    n_payload: int = 1
    cap_scale: int = field(default=1)
    heavy: bool = True  # skew-aware broadcast path for heavy-hitter keys
    _heavy_plan: tuple = field(default=None, repr=False)

    def _detect(self, lkeys, rkeys):
        """Heavy-hitter round: returns None (no heavy keys) or
        (heavy_keys ndarray, cap_hb, cap_hp), the same on every rank."""
        hk, _, n_heavy, cap_hb, cap_hp = shard_heavy_detect(
            lkeys, rkeys, self.mesh.size, mesh=self.mesh)
        if int(n_heavy) == 0:
            return None
        return hk.cpu().numpy(), max(int(cap_hb), 1), max(int(cap_hp), 1)

    def _build(self):
        n_dev = self.mesh.size
        s = self.cap_scale
        cap_r = s * (2 * -(-self.shard_rows_r // n_dev) + 64)
        cap_l = s * (2 * -(-self.shard_rows_l // n_dev) + 64)
        cap_pairs = s * (2 * -(-max(self.shard_rows_l,
                                    self.shard_rows_r) // n_dev) + 64)
        lo, hi = self.key_bounds
        hplan = self._heavy_plan
        hk = (torch.as_tensor(hplan[0], device=self.mesh.device)
              if hplan else None)
        cap_hb, cap_hp = (hplan[1], hplan[2]) if hplan else (0, 0)
        self._caps = (cap_r, cap_l, cap_pairs)
        return partial(shard_shuffle_join, key_lo=lo, key_hi=hi,
                       n_dev=n_dev, cap_r=cap_r, cap_l=cap_l,
                       cap_pairs=cap_pairs, heavy_keys=hk, cap_hb=cap_hb,
                       cap_hp=cap_hp, mesh=self.mesh)

    def __call__(self, lkeys: torch.Tensor, rkeys: torch.Tensor,
                 rpayloads: Sequence[torch.Tensor]):
        """This rank's keys and payloads in; every rank gets the per-rank
        numpy views: (lidx (n_dev, cap_pairs [+cap_hp]), pair_ok, cnt
        (n_dev, shard_rows_l), payload list).  Heavy keys take the
        broadcast path; residual overflow doubles capacities."""
        if self.heavy and self._heavy_plan is None:
            self._heavy_plan = self._detect(lkeys, rkeys) or ()
        for _ in range(8):
            step = self._build()
            r = step(lkeys, rkeys, list(rpayloads))
            if int(r["overflow"]) == 0:
                return self._gather(r)
            self.cap_scale *= 2
        raise RuntimeError(
            "shuffle join exchange overflow after capacity retries — "
            "key distribution is pathologically skewed")

    def _gather(self, r):
        """Every rank's result of one join, stacked in rank order."""
        mesh = self.mesh

        def rows(x):
            return dist.all_gather(mesh, x).cpu().numpy()

        pays: List[np.ndarray] = [rows(p) for p in r["payloads"]]
        return (rows(r["lidx"]), rows(r["pair_ok"].to(torch.int8)) != 0,
                rows(r["cnt"]), pays)
