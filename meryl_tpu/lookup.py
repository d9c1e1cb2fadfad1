"""Batched exact k-mer lookup: the merylExactLookup equivalent.

The reference builds an in-RAM table per database and probes one kmer
at a time from worker threads (interface at /root/repo/SURVEY.md §2.3;
call sites /root/reference/src/meryl-lookup/meryl-lookup.C:40-100,
dump.C:123-155, existence.C:81-110).  This design instead
keeps the database as device-resident sorted plane arrays plus a
prefix-offset table, and answers *batches* of queries with a vectorized
multiword binary search — one kernel invocation per sequence chunk
instead of one hash probe per kmer.

value(kmer) == 0 means absent, matching the reference contract.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import kmer as km
from .db import MerylDB
from .ops import multiword as mw

U32 = jnp.uint32


def _prefix_bits_for(n_kmers: int, k: int) -> int:
    """Table of 2^B offsets; aim for ~4 kmers per prefix slot."""
    b = max(1, int(n_kmers).bit_length() - 2)
    return min(b, 2 * k, 22)


def _top_bits_np(hi: np.ndarray, lo: np.ndarray, k: int, b: int) -> np.ndarray:
    """Top b bits of each 2k-bit kmer (host)."""
    shift = 2 * k - b
    hi = np.asarray(hi, np.uint64)     # no copy when already u64
    lo = np.asarray(lo, np.uint64)
    if 2 * k <= 64:
        return (lo >> np.uint64(shift)).astype(np.uint64)
    if shift >= 64:
        return (hi >> np.uint64(shift - 64)).astype(np.uint64)
    nhi = 2 * k - 64
    out = hi << np.uint64(b - nhi)
    out |= lo >> np.uint64(shift)
    return out


def _top_bits_planes(planes, k: int, b: int):
    """Top b bits of each kmer from uint32 planes (device, int32 result).

    b <= 22 so the result fits int32."""
    top_bit = 2 * k - 1
    top_plane = top_bit // 32
    used = 2 * k - 32 * top_plane
    if used >= b:
        v = (planes[top_plane] >> U32(used - b))
        return (v & U32((1 << b) - 1)).astype(jnp.int32)
    need = b - used
    hi = planes[top_plane] & ((U32(1) << U32(used)) - U32(1))
    lo = planes[top_plane - 1] >> U32(32 - need)
    return ((hi.astype(jnp.int32) << need) | lo.astype(jnp.int32))


def _lower_bound(db_planes, offsets, q_planes, k: int, b: int,
                 iters: int):
    """Prefix-bucketed vectorized lower-bound over sorted multiword
    keys (traced helper shared by the value lookup here and the rank
    lookup in tools/position_lookup.py).

    db_planes: P arrays (N,) ascending
    offsets:   (2^b + 1,) int32 start offsets per b-bit prefix
    q_planes:  P arrays (Q,)
    -> (idx, found): clipped lower-bound rank per query, and whether
       the key at idx equals the query (caller ANDs its own validity).
    """
    pref = _top_bits_planes(q_planes, k, b)
    pref = jnp.clip(pref, 0, (1 << b) - 1)
    lo = offsets[pref]
    hi = offsets[pref + 1]
    end = hi
    for _ in range(iters):
        mid = (lo + hi) >> 1
        key = [jnp.take(p, mid, mode="clip") for p in db_planes]
        less = mw.lt(key, q_planes)
        active = lo < hi
        lo = jnp.where(active & less, mid + 1, lo)
        hi = jnp.where(active & ~less, mid, hi)
    n = db_planes[0].shape[0]
    idx = jnp.minimum(lo, n - 1)
    key = [jnp.take(p, idx, mode="clip") for p in db_planes]
    found = mw.eq(key, q_planes) & (lo < end)
    return idx, found


@functools.partial(jax.jit, static_argnames=("k", "b", "iters"))
def _query_kernel(db_planes, db_values, offsets, q_planes, valid,
                  k: int, b: int, iters: int):
    """Value of each query kmer; 0 where absent or invalid."""
    idx, found = _lower_bound(db_planes, offsets, q_planes, k, b, iters)
    return jnp.where(found & valid,
                     jnp.take(db_values, idx, mode="clip"), U32(0))


@jax.jit
def _join_kernel(db_planes, db_values, q_planes, q_valid):
    """Sort-merge join: values of query kmers against the sorted DB.

    Instead of binary searches (gathers) this concatenates [db,
    queries], radix-sorts once (db entries sort before their equal
    queries via stable order), and broadcasts each run's leading db
    value to its queries with a first-value segmented scan.  Returns
    values in the SORTED order plus each entry's original query index
    (host reorders).
    """
    from .ops import segscan

    P = len(db_planes)
    N = db_planes[0].shape[0]
    Q = q_planes[0].shape[0]
    planes = [jnp.concatenate([d, jnp.where(q_valid, q, ~jnp.uint32(0))])
              for d, q in zip(db_planes, q_planes)]
    is_db = jnp.concatenate([jnp.ones((N,), jnp.uint32),
                             jnp.zeros((Q,), jnp.uint32)])
    vals = jnp.concatenate([db_values, jnp.zeros((Q,), jnp.uint32)])
    qidx = jnp.concatenate([
        jnp.full((N,), Q, jnp.uint32),
        jax.lax.broadcasted_iota(jnp.uint32, (Q, 1), 0).reshape(Q)])

    keys = [planes[p] for p in range(P - 1, -1, -1)]
    srt = jax.lax.sort(tuple(keys) + (is_db, vals, qidx),
                       num_keys=P, is_stable=True)
    splanes = [srt[P - 1 - p] for p in range(P)]
    s_isdb, s_vals, s_qidx = srt[P], srt[P + 1], srt[P + 2]

    from .ops.multiword import run_starts
    start = run_starts(splanes)

    # broadcast the run-FIRST (value, is_db) to every run element
    first_val, first_db = segscan.seg_scan(
        lambda a, b: a, (s_vals, s_isdb), start)
    out = jnp.where((s_isdb == 0) & (first_db == 1), first_val, U32(0))
    return out, s_qidx


# ---- routed-join bulk lookup ----
#
# The binary search above pays iters x P gathers per query.  For LARGE
# query batches a gather-free formulation is the alternative: route
# queries to the DB's prefix buckets with one cheap row-batched 1-key
# sort + one rank scan + one stable flag-compaction, transpose the
# fixed-capacity cells so each bucket group's queries sit next to that
# group's (pre-grouped) DB entries, sort each group row once, and read
# each query's value from its immediate predecessor (the DB entry sorts
# directly before its equal queries; duplicate queries forward-fill on
# the host).  No gathers, no scatters, no segmented broadcasts — only
# row-batched sorts.
#
# Queries whose (row, bucket) cell overflows its static capacity are
# returned by index and answered exactly by the binary-search fallback
# (rare: capacity is sized from the DB's own bucket skew).

def _route_join_kernel_impl(gplanes, gvalues, q_planes, n_valid,
                            pad_key, pad_planes, cfg,
                            exists_only=False):
    k, P, b, B, G, SUB, LDB, R0, L0, c = cfg
    D = B * c

    SENTQ = U32(0xFFFFFFFF)

    # query ids are generated on device (slab order): uploading an
    # explicit index array costs 4 bytes/query of host->device link
    iot0 = jax.lax.broadcasted_iota(U32, (R0, L0), 1) \
        + jax.lax.broadcasted_iota(U32, (R0, L0), 0) * U32(L0)
    q_qidx = jnp.where(iot0 < n_valid.astype(U32), iot0, SENTQ)

    # ---- routing: group queries by top-b-bit bucket ----
    # sort 1 (reals only): queries by bucket prefix
    pref = _top_bits_planes(q_planes, k, b).astype(U32)  # (R0, L0)
    srt = jax.lax.sort((pref,) + tuple(q_planes) + (q_qidx,),
                       num_keys=1, dimension=-1)
    pref1, planes1, qidx1 = srt[0], list(srt[1:1 + P]), srt[1 + P]

    # per-query rank within its bucket segment: own position minus the
    # segment start's position via a plain cummax (associative_scan
    # with a custom monoid compiles pathologically at this size)
    seg_start = jnp.concatenate(
        [jnp.ones((R0, 1), bool),
         pref1[:, 1:] != pref1[:, :-1]], axis=1)
    iot = jax.lax.broadcasted_iota(jnp.int32, (R0, L0), 1)
    seg_base = jax.lax.cummax(jnp.where(seg_start, iot, -1), axis=1)
    kept_q = (iot - seg_base) < c

    # per-(row, bucket) query counts: vectorized binary search over the
    # row-sorted prefixes — R0 x (B+1) x log2(L0) tiny gathers (a one-
    # hot histogram would materialize an (R0, L0, B) int8 through
    # device memory); pads fill cell slot j of a bucket
    # with n kept queries iff j >= min(n, c)
    tgt = jax.lax.broadcasted_iota(U32, (R0, B + 1), 1)
    lo_b = jnp.zeros((R0, B + 1), jnp.int32)
    hi_b = jnp.full((R0, B + 1), L0, jnp.int32)
    for _ in range(int(L0).bit_length()):
        mid = (lo_b + hi_b) >> 1
        v = jnp.take_along_axis(pref1, jnp.minimum(mid, L0 - 1), axis=1)
        # `active` guard is LOAD-BEARING (see ops/accum.py:_route_core):
        # without it a fully-valid row diverges to lo = L0 + 1 on the
        # end boundary, overcounting the last bucket and misaligning
        # the pad fill by one slot
        active = lo_b < hi_b
        less = v < tgt
        lo_b = jnp.where(active & less, mid + 1, lo_b)
        hi_b = jnp.where(active & ~less, mid, hi_b)
    n_bucket = lo_b[:, 1:] - lo_b[:, :-1]  # (R0, B)
    pad_rank = jax.lax.broadcasted_iota(jnp.int32, (B, c), 1).reshape(D)
    n_slot = jnp.repeat(n_bucket, c, axis=1)  # (R0, D), static repeat
    kept_p = pad_rank[None, :] >= jnp.minimum(n_slot, c)

    # sort 2: one compaction sort of [reals ++ pads] keyed by
    # (bucket if kept else INF): kept counts are exactly c per bucket,
    # so the leading D slots ARE the bucket-major cells
    key2 = jnp.concatenate(
        [jnp.where(kept_q, pref1, SENTQ),
         jnp.where(kept_p, jnp.broadcast_to(pad_key, (R0, D)), SENTQ)],
        axis=1)
    planes2 = [jnp.concatenate(
        [planes1[p], jnp.broadcast_to(pad_planes[p], (R0, D))], axis=1)
        for p in range(P)]
    qidx2 = jnp.concatenate(
        [qidx1, jnp.full((R0, D), SENTQ, U32)], axis=1)
    srt2 = jax.lax.sort((key2,) + tuple(planes2) + (qidx2,),
                        num_keys=1, dimension=-1, is_stable=True)
    cells_planes = [s[:, :D] for s in srt2[1:1 + P]]
    cells_qidx = srt2[1 + P][:, :D]
    tail_qidx = srt2[1 + P][:, D:]
    n_ovf = jnp.sum((tail_qidx != SENTQ).astype(jnp.int32))

    # ---- align cells with DB groups: (R0, D) -> (G, SUB*c*R0) ----
    CQ = SUB * c * R0
    cells_planes = [p.T.reshape(G, CQ) for p in cells_planes]
    cells_qidx = cells_qidx.T.reshape(G, CQ)

    # ---- per-group join: kind 0 = DB entry, 1 = query, 3 = padding;
    # kind and qidx pack into ONE u32 sort key (kind << 22 | qidx,
    # qidx <= 2^21): every extra array in a 7.8M-element sort is paid
    # for in HBM traffic
    QMASK = U32((1 << 22) - 1)
    db_pk = jnp.where(gvalues > U32(0), U32(0), U32(3) << U32(22)) | QMASK
    q_pk = jnp.where(cells_qidx != SENTQ,
                     (U32(1) << U32(22)) | cells_qidx,
                     (U32(3) << U32(22)) | QMASK)
    packed = jnp.concatenate([db_pk, q_pk], axis=1)
    jplanes = [jnp.concatenate([gplanes[p], cells_planes[p]], axis=1)
               for p in range(P)]
    jval = jnp.concatenate(
        [gvalues, jnp.zeros((G, CQ), U32)], axis=1)

    keys = tuple(jplanes[p] for p in range(P - 1, -1, -1)) + (packed,)
    srt3 = jax.lax.sort(keys + (jval,), num_keys=P + 1, dimension=-1)
    splanes = [srt3[P - 1 - p] for p in range(P)]
    packed3, val3 = srt3[P], srt3[P + 1]
    kind3 = packed3 >> U32(22)

    # ---- 1-step lookback: the DB entry sorts immediately before its
    # equal queries; further equal queries chain as duplicates
    def prev(x, fill):
        return jnp.concatenate(
            [jnp.full((G, 1), fill, x.dtype), x[:, :-1]], axis=1)

    eq_prev = None
    for p in splanes:
        e = p == prev(p, 0xFFFFFFFE)
        eq_prev = e if eq_prev is None else (eq_prev & e)
    pk = prev(kind3, U32(3))
    is_q = kind3 == U32(1)
    out_val = jnp.where(is_q & (pk == U32(0)) & eq_prev,
                        prev(val3, U32(0)), U32(0))
    dup = is_q & (pk == U32(1)) & eq_prev
    out_qidx = jnp.where(
        is_q, (packed3 & QMASK) | jnp.where(dup, U32(1) << U32(31),
                                            U32(0)), SENTQ)

    # compact query results to each row's front before download: the
    # join rows are ~75% DB entries and padding, and every byte pays
    # the device->host link (this slice is 3x smaller than the raw
    # join).  Existence-style
    # callers (screening: the dominant meryl-lookup workload) only
    # need a found bit, which packs with qidx+dup into ONE array —
    # a 2-array compaction sort and half the download bytes.
    flag = jnp.where(is_q, U32(0), U32(1))
    if exists_only:
        packed = jnp.where(
            is_q,
            (packed3 & U32((1 << 21) - 1))
            | jnp.where(out_val > U32(0), U32(1) << U32(22), U32(0))
            | jnp.where(dup, U32(1) << U32(31), U32(0)),
            SENTQ)
        srt4 = jax.lax.sort((flag, packed), num_keys=1, dimension=-1,
                            is_stable=True)
        return srt4[1][:, :CQ], n_ovf, tail_qidx
    srt4 = jax.lax.sort((flag, out_val, out_qidx),
                        num_keys=1, dimension=-1, is_stable=True)
    out_val = srt4[1][:, :CQ]
    out_qidx = srt4[2][:, :CQ]
    return out_val, out_qidx, n_ovf, tail_qidx


_route_join_kernel = jax.jit(_route_join_kernel_impl,
                             static_argnames=("cfg", "exists_only"))


class ExactLookup:
    """Device-resident exact lookup table for one database.

    Mirrors merylExactLookup: load(db, minV, maxV), value(), exists(),
    nKmers().  Batched query methods take plane lists + validity masks.
    """

    def __init__(self, db: MerylDB, min_value: int = 0,
                 max_value: int = km.VALUE_MAX):
        self.db = db
        self.k = db.k
        self.P = km.num_planes(self.k)
        hi, lo, counts = db.load_all()
        if min_value > 0 or max_value < km.VALUE_MAX:
            keep = (counts >= min_value) & (counts <= max_value)
            hi, lo, counts = hi[keep], lo[keep], counts[keep]
        self._n = len(counts)
        self.B = _prefix_bits_for(max(self._n, 1), self.k)
        pref = _top_bits_np(hi, lo, self.k, self.B)
        offsets = np.searchsorted(
            pref, np.arange((1 << self.B) + 1, dtype=np.uint64)).astype(np.int32)
        planes = km.planes_from_hilo(hi, lo, self.P)
        if self._n == 0:  # keep kernels shape-happy
            planes = [np.zeros(1, np.uint32) for _ in range(self.P)]
            counts = np.zeros(1, np.uint32)
        # device residency gate: a table past the HBM budget stays
        # host-resident — bulk queries run the SEGMENTED grid join
        # (ops/bacjoin.py, streamed through HBM) and point probes the
        # host searchsorted path.  The reference's equivalent limit is
        # host RAM (merylExactLookup loads the whole table).
        from .budget import budget_bytes
        dev_budget = budget_bytes("lookup")
        self._device_resident = (
            (self.P * 4 + 4) * max(self._n, 1)
            + 4 * (1 << self.B) <= dev_budget)
        if self._device_resident:
            self._offsets = jnp.asarray(offsets)
            self._planes = [jnp.asarray(p) for p in planes]
            self._values = jnp.asarray(
                np.ascontiguousarray(counts, np.uint32))
        else:
            self._offsets = self._planes = self._values = None
        max_range = int((offsets[1:] - offsets[:-1]).max()) if self._n else 1
        self._iters = max(1, int(max_range).bit_length())
        # host copies for the lazily-built routed-join layout
        self._np_hi, self._np_lo = hi, lo
        self._np_counts = np.ascontiguousarray(counts, np.uint32)
        self._grouped = None
        self._bacj = None

    def n_kmers(self) -> int:
        return self._n

    def estimate_memory_bytes(self) -> int:
        """Device-memory footprint of the loaded table (the reference's
        estimateMemoryUsage reports RAM for its table the same way)."""
        return (self.P * 4 + 4) * max(self._n, 1) + 4 * (1 << self.B)

    def values_batch(self, q_planes, valid):
        """q_planes: P device arrays, valid: bool mask -> uint32 values."""
        if not self._device_resident:
            qhi, qlo = km.hilo_from_planes(
                [np.asarray(p) for p in q_planes])
            out = self.values_host(qhi, qlo)
            out[~np.asarray(valid)] = 0
            return out
        return _query_kernel(self._planes, self._values, self._offsets,
                             q_planes, valid, self.k, self.B, self._iters)

    def values_host(self, qhi: np.ndarray, qlo: np.ndarray) -> np.ndarray:
        """Host-side exact probe against the sorted (hi, lo) arrays:
        the fallback when the table exceeds the device budget (point
        probes + the segmented join's exception hatches).  Vectorized
        searchsorted for 2k <= 64; two-stage for wider keys."""
        n = self._n
        out = np.zeros(len(qlo), np.uint32)
        if n == 0:
            return out
        if 2 * self.k <= 64:
            idx = np.searchsorted(self._np_lo, qlo)
            ok = idx < n
            ii = np.minimum(idx, n - 1)
            ok &= self._np_lo[ii] == qlo
            out[ok] = self._np_counts[ii[ok]]
            return out
        # hi plane narrows the range; lo resolves within it.  Keys are
        # sorted lexicographically so each hi value is one contiguous
        # run — loop over the DISTINCT query hi values (bounded by
        # 2^(2k-64) and by Q) with a vectorized lo search per run.
        idx = np.empty(len(qlo), np.int64)
        for h in np.unique(qhi):
            m = qhi == h
            a = np.searchsorted(self._np_hi, h, "left")
            b = np.searchsorted(self._np_hi, h, "right")
            idx[m] = a + np.searchsorted(self._np_lo[a:b], qlo[m])
        ok = idx < n
        ii = np.minimum(idx, n - 1)
        ok &= (self._np_lo[ii] == qlo) & (self._np_hi[ii] == qhi)
        out[ok] = self._np_counts[ii[ok]]
        return out

    BULK_SLAB = 1 << 16

    # routed-join configuration (see _route_join_kernel_impl)
    JOIN_SLAB = 1 << 21      # valid queries per join dispatch
    JOIN_R0 = 1 << 4         # routing rows per slab
    JOIN_MIN_Q = 1 << 17     # below: binary-search path (jit churn)
    JOIN_MIN_N = 1 << 16     # tiny tables: binary search is fine
    _LDB_TARGET = 1 << 13    # DB entries per join row (pre padding)
    BACJ_MIN_N = 1 << 16     # grid compare-join regime: it owns the
    #                          whole bulk domain from here up.  The
    #                          routed join below remains the
    #                          degenerate-skew fallback when no grid
    #                          geometry fits
    BACJ_SLAB = 1 << 23      # queries per grid-join dispatch: the B*c
    #                          pad-sort slots amortize over Q

    def _build_grouped(self):
        """Host-side one-time build of the bucket-grouped DB layout:
        (G, LDB) plane/value rows, each row = SUB consecutive top-b-bit
        buckets, padded with the sentinel key / value 0.  Returns None
        when the DB's prefix skew would blow the query cell capacity
        (degenerate tables fall back to the binary search)."""
        N = self._n
        G = 1 << max(0, (max(1, (N + self._LDB_TARGET - 1)
                            // self._LDB_TARGET) - 1).bit_length())
        # bucket count: >= G (so a join row covers whole buckets) but
        # otherwise coarse — cell slack costs scale with B (+2.5 sigma
        # + 8 per bucket) and coarse buckets have tighter statistics
        b = max(G, 512).bit_length() - 1
        b = min(b, 2 * self.k, 26)
        B = 1 << b
        SUB = max(1, B // G)
        G = B // SUB
        top = _top_bits_np(self._np_hi, self._np_lo, self.k, b)
        counts = np.bincount(top.astype(np.int64), minlength=B)
        gcounts = counts.reshape(G, SUB).sum(axis=1)
        # eighth-pow2 quantization: pure pow2 rounds ~N/G + 3 sigma up
        # to 2x and the join re-sorts every padded slot
        mx = int(max(1, gcounts.max()))
        q = max(64, 1 << max(0, mx.bit_length() - 4))
        LDB = max(256, ((mx + q - 1) // q) * q)
        assert self.JOIN_SLAB <= 1 << 21  # qidx packs into 22 bits
        # query cell capacity: sized for the hotter of a uniform miss
        # stream and a hit stream following the DB's own bucket skew;
        # 2.5-sigma slack — the occasional cell overflow costs one
        # exact binary-search fallback, while every slack slot rides
        # through both routing sorts of every batch
        L0 = self.JOIN_SLAB // self.JOIN_R0
        mean_uni = L0 / B
        mean_hot = L0 * (counts.max() / max(N, 1))
        mean = max(mean_uni, mean_hot, 1.0)
        c = int(np.ceil(mean + 2.5 * np.sqrt(mean) + 8))
        if c * B > 4 * L0:  # degenerate skew: give up on the join
            return None
        starts = np.zeros(G + 1, np.int64)
        np.cumsum(gcounts, out=starts[1:])
        gplanes = [np.full((G, LDB), 0xFFFFFFFF, np.uint32)
                   for _ in range(self.P)]
        gvalues = np.zeros((G, LDB), np.uint32)
        planes = km.planes_from_hilo(self._np_hi, self._np_lo, self.P)
        for g in range(G):
            s, e = starts[g], starts[g + 1]
            if e > s:
                for p in range(self.P):
                    gplanes[p][g, :e - s] = planes[p][s:e]
                gvalues[g, :e - s] = self._np_counts[s:e]
        pad_key = np.arange(B, dtype=np.uint32).repeat(c)
        pad_planes = [np.full(B * c, 0xFFFFFFFF, np.uint32)
                      for _ in range(self.P)]
        return {
            "cfg": (self.k, self.P, b, B, G, SUB, LDB,
                    self.JOIN_R0, L0, c),
            "gplanes": [jnp.asarray(p) for p in gplanes],
            "gvalues": jnp.asarray(gvalues),
            "pad_key": jnp.asarray(pad_key),
            "pad_planes": [jnp.asarray(p) for p in pad_planes],
        }

    def values_bulk(self, q_planes_np, valid_np,
                    exists_only: bool = False) -> np.ndarray:
        """Values for a LARGE host-side query batch.

        Big batches against non-degenerate tables run the routed join
        (gather-free; see _route_join_kernel_impl); small batches and
        fallback cases run fixed-size slabs through the prefix-table
        binary search.  q_planes_np: P numpy arrays; valid_np: bool.

        exists_only=True returns 0/1 instead of counts — screening
        callers (existence / include / exclude / -bed / -wig-depth)
        then pay one packed output array instead of two (the download
        bounds these workloads on slow device->host links)."""
        n_valid = int(np.count_nonzero(valid_np))
        if (self._n >= self.BACJ_MIN_N and n_valid >= self.JOIN_MIN_Q):
            # big-DB (Merqury screening) regime: the routed join below
            # re-sorts the whole grouped DB every slab, so its per-
            # query cost diverges with N — the grid join's DB touch is
            # a dense streaming compare instead (ops/bacjoin.py)
            if self._bacj is None:
                self._bacj = self._build_bacj() or "degenerate"
            if self._bacj != "degenerate":
                return self._values_bulk_bacj(q_planes_np, valid_np,
                                              exists_only)
        if (self._n >= self.JOIN_MIN_N and n_valid >= self.JOIN_MIN_Q
                and self._device_resident):
            if self._grouped is None:
                self._grouped = self._build_grouped() or "degenerate"
            if self._grouped != "degenerate":
                return self._values_bulk_join(q_planes_np, valid_np,
                                              exists_only)
        out = self._values_bulk_bsearch(q_planes_np, valid_np)
        if exists_only:
            return (out > 0).astype(np.uint32)
        return out

    def _values_bulk_bsearch(self, q_planes_np, valid_np) -> np.ndarray:
        """Binary-search bulk path (small batches and fallbacks)."""
        Q = len(valid_np)
        out = np.zeros(Q, np.uint32)
        slab = self.BULK_SLAB
        for s in range(0, Q, slab):
            e = min(Q, s + slab)
            n = e - s
            qp = []
            for p in q_planes_np:
                a = np.zeros(slab, np.uint32)
                a[:n] = p[s:e]
                qp.append(jnp.asarray(a))
            vv = np.zeros(slab, bool)
            vv[:n] = valid_np[s:e]
            vals = np.asarray(self.values_batch(qp, jnp.asarray(vv)))
            out[s:e] = vals[:n]
        return out

    def _values_bulk_join(self, q_planes_np, valid_np,
                          exists_only: bool = False) -> np.ndarray:
        g = self._grouped
        cfg = g["cfg"]
        R0, L0 = cfg[7], cfg[8]
        SENTQ = np.uint32(0xFFFFFFFF)
        Q = len(valid_np)
        out = np.zeros(Q, np.uint32)
        vidx = np.flatnonzero(valid_np)
        slab = R0 * L0
        for s in range(0, len(vidx), slab):
            take = vidx[s:s + slab]
            n = len(take)
            qp = []
            for p in q_planes_np:
                a = np.full(slab, 0xFFFFFFFF, np.uint32)
                a[:n] = p[take]
                qp.append(jnp.asarray(a.reshape(R0, L0)))
            if exists_only:
                packed, n_ovf, tail = _route_join_kernel(
                    g["gplanes"], g["gvalues"], qp, jnp.int32(n),
                    g["pad_key"], g["pad_planes"], cfg, True)
                pk = np.asarray(packed).reshape(-1)
                mask = pk != SENTQ
                pk = pk[mask]
                v = ((pk >> 22) & 1).astype(np.uint32)
                dup = (pk >> 31) != 0
                qn = (pk & 0x1FFFFF).astype(np.int64)
                val2 = qidx2 = None
            else:
                val2, qidx2, n_ovf, tail = _route_join_kernel(
                    g["gplanes"], g["gvalues"], qp, jnp.int32(n),
                    g["pad_key"], g["pad_planes"], cfg)
                val2 = np.asarray(val2).reshape(-1)
                qidx2 = np.asarray(qidx2).reshape(-1)
                mask = qidx2 != SENTQ
                v = val2[mask]
                qraw = qidx2[mask]
                dup = (qraw >> 31) != 0
                qn = (qraw & 0x7FFFFFFF).astype(np.int64)
            # duplicate queries copy their run representative's value:
            # the download is in sorted-key order, so chains are
            # contiguous — one vectorized forward fill
            if dup.any():
                src = np.where(dup, 0, np.arange(len(v)))
                np.maximum.accumulate(src, out=src)
                v = v[src]
            out[take[qn]] = v
            if int(n_ovf) > 0:
                # cell-capacity overflow: answer those queries exactly
                # through the binary search (fixed-slab, no jit churn)
                tq = np.asarray(tail).reshape(-1)
                oq = (tq[tq != SENTQ]).astype(np.int64)
                opos = take[oq]
                qpo = [np.ascontiguousarray(p[opos]) for p in q_planes_np]
                ov = self._values_bulk_bsearch(
                    qpo, np.ones(len(opos), bool))
                out[opos] = (ov > 0).astype(np.uint32) if exists_only \
                    else ov
        return out

    def _build_bacj(self):
        """One-time host build of the bucket-grid layout for the
        big-DB compare-join (ops/bacjoin.py).  Returns None when no
        geometry fits the device-memory cap with sane padding."""
        from .budget import budget_bytes
        from .ops import bacjoin as bj

        if 2 * self.k < 18 or self._n < self.BACJ_MIN_N:
            return None
        cap = budget_bytes("bacj")
        # bound the max-bucket scan resolution by the table size: a
        # fixed 2^26 bincount is a surprise 0.5 GB host allocation for
        # a 2^16-entry table (the planner never picks B > 8 * n_db
        # anyway, so n-scaled resolution loses nothing)
        bm = min(26, 2 * self.k - 1, self._n.bit_length() + 3)
        topM = bj._top_bits_np(self._np_hi, self._np_lo, self.k, bm)
        cM = np.bincount(topM, minlength=1 << bm)  # already int64

        def bucket_max(b):
            return int(cM.reshape(1 << b, -1).sum(axis=1).max())

        cfg = bj.plan_bacjoin_segmented(self._n, self.k, bucket_max,
                                        self.BACJ_SLAB, cap, b_hi=bm)
        if cfg is None:
            return None
        dbd, dbv = bj.build_db_grid(self._np_hi, self._np_lo,
                                    self._np_counts, self.k, cfg)
        out = {
            "cfg": cfg,
            "segments": cfg.get("segments", 1),
            "kcfg": (self.k, cfg["b"], cfg["b1"], cfg["c"],
                     cfg["capA"], cfg["s_cap"], cfg["ovfcap"]),
        }
        if out["segments"] == 1:
            out["dbd"] = tuple(jnp.asarray(d) for d in dbd)
            out["dbv"] = jnp.asarray(dbv)
        else:
            # host-resident grid, streamed through HBM one key-range
            # segment at a time (numpy row slices are views, no copy)
            out["dbd_np"] = dbd
            out["dbv_np"] = dbv
        return out

    def _values_bulk_bacj(self, q_planes_np, valid_np,
                          exists_only: bool = False) -> np.ndarray:
        """Bulk lookup through the bucket-grid compare-join.  Every
        escape is exact: per-cell overflow queries are captured by
        position and re-answered by binary search; a coarse row whose
        capture window itself overflows (ovfcap) falls back for the
        whole row; a slab the host router cannot place (degenerate
        query skew) falls back for the whole slab."""
        from .ops import bacjoin as bj

        g = self._bacj
        cfg, kcfg = g["cfg"], g["kcfg"]
        capA, ovfcap = cfg["capA"], cfg["ovfcap"]
        K = g["segments"]
        SENTQ = np.uint32(0xFFFFFFFF)
        Q = len(valid_np)
        out = np.zeros(Q, np.uint32)
        vidx = np.flatnonzero(valid_np)
        qhi, qlo = km.hilo_from_planes(q_planes_np)

        # hatch queries (cell overflow, lost rows, rejected slabs) are
        # ACCUMULATED and resolved in one vectorized host searchsorted
        # at the end instead of one device dispatch PER COARSE ROW —
        # the host table copy answers the same queries exactly at
        # numpy speed
        fb_idx: list = []

        def bsearch_into(idx):
            if len(idx):
                fb_idx.append(np.asarray(idx))

        def resolve_fallbacks():
            if not fb_idx:
                return
            idx = np.unique(np.concatenate(fb_idx))
            fb_idx.clear()
            ov = self.values_host(qhi[idx], qlo[idx])
            out[idx] = (ov > 0).astype(np.uint32) if exists_only else ov

        def run_slabs(sel, dbd, dbv, row_base, n_rows):
            """1-deep pipeline over sel's slabs against one resident
            grid (the whole grid, or one key-range segment): the host
            routes slab i+1 while the device resolves slab i (kernel
            dispatch is async; only the result fetch blocks)."""
            def _route(take):
                return take, bj.route_queries_host(
                    qhi[take], qlo[take], self.k, cfg,
                    row_base=row_base, n_rows=n_rows)

            def _dispatch(routed):
                qlow, n_row, perm = routed
                return bj.bacjoin_kernel(
                    dbd, dbv, tuple(jnp.asarray(x) for x in qlow),
                    jnp.asarray(n_row), kcfg,
                    exists_only=exists_only)

            slabs = [sel[s:s + self.BACJ_SLAB]
                     for s in range(0, len(sel), self.BACJ_SLAB)]
            inflight = None
            for i in range(len(slabs) + 1):
                nxt = None
                if i < len(slabs):
                    take, routed = _route(slabs[i])
                    if routed is None:
                        bsearch_into(take)
                    else:
                        nxt = (take, routed[2], _dispatch(routed))
                if inflight is None:
                    inflight = nxt
                    continue
                take, perm, handles = inflight
                inflight = nxt
                if exists_only:
                    # packed word: found bit 31 | routed column — ONE
                    # downloaded array instead of two
                    packed, ovf_pos, n_ovf = handles
                    packed = np.asarray(packed)
                    n_ovf = np.asarray(n_ovf)
                    rows, cols = np.nonzero(packed != SENTQ)
                    pw = packed[rows, cols]
                    orig = perm[rows * capA
                                + (pw & 0x7FFFFFFF).astype(np.int64)]
                    out[take[orig]] = (pw >> 31).astype(np.uint32)
                else:
                    vals, pos, ovf_pos, n_ovf = handles
                    vals = np.asarray(vals)
                    pos = np.asarray(pos)
                    n_ovf = np.asarray(n_ovf)
                    rows, cols = np.nonzero(pos != SENTQ)
                    orig = perm[rows * capA + pos[rows, cols]]
                    out[take[orig]] = vals[rows, cols]
                lost_rows = np.flatnonzero(n_ovf > ovfcap)
                if len(lost_rows):
                    # capture window overflowed: re-answer those
                    # coarse rows wholesale (duplicate-flood case)
                    for r in lost_rows:
                        rp = perm[r * capA:(r + 1) * capA]
                        bsearch_into(take[rp[rp >= 0]])
                ok_rows = n_ovf <= ovfcap
                op = np.asarray(ovf_pos)
                orr, occ = np.nonzero((op != SENTQ)
                                      & ok_rows[:, None])
                if len(orr):
                    oidx = perm[orr * capA + op[orr, occ]]
                    bsearch_into(take[oidx])

        if K == 1:
            run_slabs(vidx, g["dbd"], g["dbv"], 0, 1 << cfg["b1"])
            resolve_fallbacks()
            return out

        # segmented grid: partition queries by key-range segment (top
        # log2 K bits), then stream one grid segment through HBM at a
        # time — each upload serves ALL of that segment's slabs
        B1 = 1 << cfg["b1"]
        rows_per_seg = B1 // K
        buckets_per_seg = cfg["B"] // K
        coarse = bj._top_bits_np(qhi[vidx], qlo[vidx],
                                 self.k, cfg["b1"])
        seg_ids = (coarse // rows_per_seg).astype(np.int64)
        order = np.argsort(seg_ids, kind="stable")
        bounds = np.searchsorted(seg_ids[order], np.arange(K + 1))
        for s in range(K):
            sel = vidx[order[bounds[s]:bounds[s + 1]]]
            if len(sel) == 0:
                continue
            a, b = s * buckets_per_seg, (s + 1) * buckets_per_seg
            dbd_s = tuple(jnp.asarray(d[a:b]) for d in g["dbd_np"])
            dbv_s = jnp.asarray(g["dbv_np"][a:b])
            run_slabs(sel, dbd_s, dbv_s, s * rows_per_seg,
                      rows_per_seg)
            del dbd_s, dbv_s
        resolve_fallbacks()
        return out

    def values_join(self, q_planes_np, valid_np) -> np.ndarray:
        """Sort-merge-join variant of values_bulk (one radix sort of
        DB+queries per slab, no gathers) — kept as the alternative
        strategy for backends where gathers dominate."""
        Q = len(valid_np)
        out = np.zeros(Q, np.uint32)
        slab = max(self._n, 1 << 22)
        for s in range(0, Q, slab):
            e = min(Q, s + slab)
            qp = [jnp.asarray(p[s:e]) for p in q_planes_np]
            vv = jnp.asarray(valid_np[s:e])
            vals, qidx = _join_kernel(self._planes, self._values, qp, vv)
            vals = np.asarray(vals)
            qidx = np.asarray(qidx)
            m = qidx < (e - s)
            out[s:e][qidx[m]] = vals[m]
        out[~valid_np] = 0
        return out

    # ---- convenience host-side probes (small batches) ----

    def values_np(self, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
        q = km.planes_from_hilo(np.asarray(hi, np.uint64),
                                np.asarray(lo, np.uint64), self.P)
        valid = jnp.ones(len(lo), bool)
        return np.asarray(self.values_batch([jnp.asarray(p) for p in q], valid))

    def value(self, kmer_int: int) -> int:
        hi, lo = km.hilo_from_int(kmer_int)
        return int(self.values_np(np.array([hi], np.uint64),
                                  np.array([lo], np.uint64))[0])

    def exists(self, kmer_int: int) -> bool:
        return self.value(kmer_int) > 0
