"""Bucket-aligned compare-join: bulk exact lookup for the big-DB
(Merqury screening) regime, where the database is much larger than a
query slab.

Why this shape: a binary search pays several dependent gathers per
query against a table far larger than any cache.  The routed join
avoids gathers but re-sorts the whole grouped DB inside every slab
(G x LDB entries), so for N >> Q its per-query cost diverges.  This
kernel touches the DB only with dense streaming reads:

  build (host, once):  pad the sorted DB into a (B, s_cap) top-b-bit
      bucket grid — per bucket, its suffix keys and values at fixed
      offsets, value 0 marking padding.  The DB is never re-sorted or
      gathered again.
  route (host, per slab):  radix-partition the queries into B1 coarse
      rows of capacity capA (numpy; linear time, overlappable with the
      device).  Host->device wire = B1*capA suffix words, ~1.3x the
      raw query bytes.
  align (device):  per coarse row, ONE row-batched sort of
      [queries ++ c pads per fine bucket] keyed (fine bucket, is_pad)
      puts each fine bucket's queries before its pads; a cummax rank
      keeps exactly c entries per bucket; ONE compaction sort yields
      bucket-major (B, c) query cells.  Overflowing queries (rank >=
      c: duplicate-heavy or skewed slabs) are captured per row for an
      exact host-side fallback, never dropped.
  resolve (device):  for each cell lane j < c, a dense broadcast
      compare of the cell's suffix against its bucket's s_cap DB
      entries; value = sum of matching entries' values (DB keys are
      unique, padding has value 0, so the sum is exact).  Traffic =
      c * B * s_cap * 8 bytes of sequential device-memory reads — the
      only DB touch, at memory-bandwidth speed.
  pack (device):  one flag sort compacts results to each coarse row's
      front; reals per row <= capA by construction, so the download
      slice is statically (B1, capA).

Reference contract: merylExactLookup value()/exists()
(/root/reference/src/meryl-lookup/meryl-lookup.C:40-100); the
reference probes one kmer at a time from CPU threads — this is the
batched device equivalent for its dominant screening workload.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
SENT = 0xFFFFFFFF



def _ceil_div(a, b):
    return -(-a // b)


def _cap_for_overflow(lam: float, target: float = 0.03) -> int:
    """Smallest per-bucket cell capacity with expected query overflow
    <= target fraction under Poisson(lam) bucket occupancy.  Overflow
    is never wrong — it falls back to the exact binary search — so the
    capacity only balances pad-sort volume against fallback volume."""
    lam = max(lam, 1e-9)
    for c in range(2, 257):
        # E[(X - c)+] = sum_{x > c} (x - c) P(x)
        xs = np.arange(c + 1, max(int(lam + 12 * np.sqrt(lam)), c + 40))
        logp = xs * np.log(lam) - lam - \
            np.cumsum(np.log(np.maximum(np.arange(1, xs[-1] + 1), 1)))[xs - 1]
        tail = float(np.sum((xs - c) * np.exp(logp)))
        if tail / lam <= target:
            return c
    return 256


def plan_bacjoin(n_db: int, k: int, bucket_max, q_slab: int,
                 mem_cap_bytes: int, b_hi: int = 26) -> dict | None:
    """Choose the join geometry for a DB of n_db entries.

    bucket_max: callable b -> max top-b-bit bucket count (the caller
    computes it from the real key distribution; padding and exactness
    both depend on the true max, not a Poisson model).
    Returns None when no b fits the memory cap with sane padding
    (degenerate skew) — callers fall back to the binary search."""
    best = None
    for b in range(min(b_hi, 2 * k - 1), 15, -1):
        B = 1 << b
        if B > 8 * n_db or B < 2:
            continue
        s_cap = int(bucket_max(b))
        ps = max(1, _ceil_div(2 * k - b, 32))  # suffix planes
        mem = B * s_cap * 4 * (ps + 1)
        if mem > mem_cap_bytes:
            continue
        # hit-heavy slabs follow the REALIZED db bucket shares, not a
        # Poisson spray: a bucket holding d_i of N keys draws
        # Binomial(Q, d_i/N) hits, so across buckets the occupancy
        # variance is lam * (1 + Q/N) — material when the DB is only a
        # few slabs big (the mid-size regime; at N >> Q it vanishes).
        # The Poisson tail target shrinks by that factor to keep the
        # realized overflow fraction near the 3% design point.
        f_over = 1.0 + q_slab / max(1, n_db)
        c = _cap_for_overflow(q_slab / B, target=0.03 / f_over)
        # device work model (relative weights of three terms): the
        # align/pack sorts touch the q_slab + B*c slots 3 times; the
        # fused resolve streams the grid once, but its compare work
        # still scales with c (the (B, c, s_cap) compare+select
        # tensor).  Without the c term the planner picks too-coarse
        # buckets with huge c.
        work = 0.83 * 3 * (q_slab + B * c) \
            + 0.01 * B * s_cap * (ps + 1) \
            + 0.003 * c * B * s_cap * ps
        if best is None or work < best["work"]:
            b1 = max(10, min(b - 7, 14))
            lam = q_slab / (1 << b1)
            # coarse-row capacity pays the same hit overdispersion
            # (see f_over above): without it a full-hit slab's realized
            # row max sits right AT the 5-sigma Poisson cap and the
            # router rejects whole slabs to the binary search
            capA = int(np.ceil(lam + 5.0 * np.sqrt(lam * f_over) + 8))
            capA = _ceil_div(capA, 8) * 8
            # per-coarse-row capture window for cell-overflow queries:
            # sized from the EXPECTED overflow volume (the c sizing
            # target x queries per coarse row) with 4x margin — a
            # fixed 64 was calibrated to the big-DB regime (8192 rows
            # per slab) and blew up at mid-size b1=10 where a row
            # carries 8192 queries: ~0.7% overflow = ~55/row meant
            # half the rows lost their captures and fell back
            # WHOLESALE
            ovfcap = max(64, min(1024, _ceil_div(
                int(4 * (0.03 / f_over) * lam) + 32, 8) * 8))
            best = {"b": b, "B": B, "s_cap": s_cap, "c": c, "ps": ps,
                    "b1": b1, "capA": capA, "work": work,
                    "mem": mem, "ovfcap": ovfcap}
    if best is None:
        return None
    # padding sanity: a grid mostly made of padding burns compare
    # bandwidth for nothing (pathological key skew)
    if best["B"] * best["s_cap"] > 4 * n_db + (1 << 22):
        return None
    best["segments"] = 1
    return best


def plan_bacjoin_segmented(n_db: int, k: int, bucket_max, q_slab: int,
                           seg_cap_bytes: int, b_hi: int = 26,
                           max_segments: int = 16) -> dict | None:
    """plan_bacjoin, but when no single-grid geometry fits the device
    cap, split the grid into K equal coarse-row ranges (segments) of
    <= seg_cap_bytes each.  The grid lives on the HOST; segments are
    uploaded one at a time and each serves every query slab routed to
    its key range — out-of-core lookup for DBs past device memory (the
    reference simply requires the whole table in RAM: merylExactLookup,
    SURVEY §2.3; this analog streams it through the device).

    capA is resized for the K-fold query concentration (a slab routed
    to one segment lands on B1/K rows).  Returns None only for
    degenerate skew or truly oversized DBs (> max_segments * cap)."""
    for segs in (1, 2, 4, 8, 16):
        if segs > max_segments:
            break
        cfg = plan_bacjoin(n_db, k, bucket_max, q_slab,
                           seg_cap_bytes * segs, b_hi)
        if cfg is None:
            continue
        if segs > 1:
            b1 = cfg["b1"]
            if (1 << b1) % segs or (1 << b1) <= segs:
                continue
            lam = q_slab / ((1 << b1) // segs)
            f_over = 1.0 + q_slab / max(1, n_db)
            capA = int(np.ceil(lam + 5.0 * np.sqrt(lam * f_over) + 8))
            cfg["capA"] = _ceil_div(capA, 8) * 8
            # rows per segment must also divide the fine buckets
            if cfg["B"] % segs:
                continue
            # the fine-cell capacity sees the same K-fold concentration:
            # a slab routed to one segment lands on B/K fine buckets, so
            # the per-cell occupancy is segs * (q_slab / B) — without
            # this resize the overflow-to-binary-search fraction runs
            # segs-fold past the 3% target on out-of-core DBs
            # (throughput-only; the overflow hatch keeps it exact)
            cfg["c"] = _cap_for_overflow(q_slab / (cfg["B"] // segs),
                                         target=0.03 / f_over)
            # the capture window sees the same K-fold concentration
            cfg["ovfcap"] = max(64, min(1024, _ceil_div(
                int(4 * (0.03 / f_over) * lam) + 32, 8) * 8))
            cfg["segments"] = segs
        return cfg
    return None


def build_db_grid(hi: np.ndarray, lo: np.ndarray, counts: np.ndarray,
                  k: int, cfg: dict):
    """Sorted (hi, lo, counts) -> ((ps x (B, s_cap)) suffix planes,
    (B, s_cap) values) with value 0 marking padding.  Host, once.

    A native parallel builder (native/mt_route.cpp mt_bacj_build_grid)
    runs when available — buckets are contiguous input runs under the
    sorted order, so the scatter is sequential per bucket range;
    numpy below is the reference/fallback (differential-tested)."""
    import os as _os

    b, B, s_cap, ps = cfg["b"], cfg["B"], cfg["s_cap"], cfg["ps"]
    n = len(counts)
    if _os.environ.get("MERYL_TPU_NATIVE_ROUTE", "1") != "0":
        out = _build_db_grid_native(hi, lo, counts, k, cfg)
        if out is not NotImplemented:
            return out
    top = _top_bits_np(hi, lo, k, b)  # already int64 — every extra
    # astype here is a fresh 8n-byte allocation whose first-touch page
    # faults are a large share of the build
    cnt = np.bincount(top, minlength=B)
    starts = np.zeros(B + 1, np.int64)
    np.cumsum(cnt, out=starts[1:])
    col = np.arange(n, dtype=np.int64)
    col -= starts[top]
    top *= s_cap
    flat = top
    flat += col
    sbits = 2 * k - b
    dbd = []
    for p in range(ps):
        pl = np.zeros(B * s_cap, np.uint32)
        pl[flat] = _suffix_plane_np(hi, lo, sbits, p)
        dbd.append(pl.reshape(B, s_cap))
    dbv = np.zeros(B * s_cap, np.uint32)
    dbv[flat] = counts
    return dbd, dbv.reshape(B, s_cap)


def _build_db_grid_native(hi, lo, counts, k: int, cfg: dict):
    import ctypes

    from .. import native

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "mt_bacj_build_grid"):
        return NotImplemented
    b, B, s_cap, ps = cfg["b"], cfg["B"], cfg["s_cap"], cfg["ps"]
    n = len(counts)
    hi = np.ascontiguousarray(hi, np.uint64)
    lo = np.ascontiguousarray(lo, np.uint64)
    counts = np.ascontiguousarray(counts, np.uint32)
    dbd = np.zeros((ps, B, s_cap), np.uint32)
    dbv = np.zeros((B, s_cap), np.uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    rc = lib.mt_bacj_build_grid(
        hi.ctypes.data_as(u64p), lo.ctypes.data_as(u64p),
        counts.ctypes.data_as(u32p), ctypes.c_int64(n),
        ctypes.c_int32(2 * k), ctypes.c_int32(b),
        ctypes.c_int32(s_cap), ctypes.c_int32(ps),
        dbd.ctypes.data_as(u32p), dbv.ctypes.data_as(u32p),
        ctypes.c_int32(native.n_threads()))
    if rc != 0:
        return NotImplemented
    return [dbd[p] for p in range(ps)], dbv


def _top_bits_np(hi, lo, k: int, b: int):
    shift = 2 * k - b
    hi = np.asarray(hi, np.uint64)
    lo = np.asarray(lo, np.uint64)
    if 2 * k <= 64:
        return (lo >> np.uint64(shift)).astype(np.int64)
    if shift >= 64:
        return (hi >> np.uint64(shift - 64)).astype(np.int64)
    nhi = 2 * k - 64
    out = hi << np.uint64(b - nhi)
    out |= lo >> np.uint64(shift)
    return out.astype(np.int64)


def _suffix_plane_np(hi, lo, sbits: int, p: int):
    """Plane p (bits [32p, 32p+32)) of the low sbits bits of each key.

    Minimal-temporary formulation: each u64 intermediate is an 8n-byte
    allocation whose first-touch faults dominate at genome scale —
    truncate to u32 as early as possible and mask in place."""
    hi = np.asarray(hi, np.uint64)
    lo = np.asarray(lo, np.uint64)
    sh = 32 * p
    if sh >= 64:
        v = (hi >> np.uint64(sh - 64)).astype(np.uint32)
    elif sh == 0:
        v = lo.astype(np.uint32)      # low 32 bits directly
    else:
        v = (lo >> np.uint64(sh)).astype(np.uint32)
        if np.any(hi):
            v |= (hi << np.uint64(64 - sh)).astype(np.uint32)
    bits_here = sbits - sh
    if bits_here < 32:
        v &= np.uint32((1 << max(0, bits_here)) - 1)
    return v


def route_queries_host(hi: np.ndarray, lo: np.ndarray, k: int,
                       cfg: dict, row_base: int = 0,
                       n_rows: int | None = None):
    """Partition a query slab into (n_rows, capA) low-bit rows.

    -> (qlow list of ps_l x (n_rows, capA) u32, n_row (n_rows,) i32,
        perm (Q,) int64 original index per (row, col) slot, or None
        when a coarse row overflows capA — caller splits the slab).
    Queries carry only their low 2k - b1 bits; the row IS the coarse
    bucket, so the top bits travel for free.

    row_base/n_rows select a coarse-row window for SEGMENTED grids
    (out-of-core DBs): the caller pre-partitions queries by segment
    and every key must land in [row_base, row_base + n_rows).

    The native two-pass counting-sort router (native/mt_route.cpp)
    runs when the shared library is present; this numpy path is the
    reference implementation and the fallback (differential:
    tests/test_bacjoin.py::test_native_router_matches_numpy)."""
    import os as _os

    b1, capA = cfg["b1"], cfg["capA"]
    if n_rows is None:
        n_rows = 1 << b1
    if _os.environ.get("MERYL_TPU_NATIVE_ROUTE", "1") != "0":
        out = _route_queries_native(hi, lo, k, cfg, row_base, n_rows)
        if out is not NotImplemented:
            return out
    B1 = n_rows
    Q = len(lo)
    coarse = _top_bits_np(hi, lo, k, b1) - row_base
    if Q and (coarse.min() < 0 or coarse.max() >= n_rows):
        raise ValueError("query key outside segment row window")
    n_row = np.bincount(coarse, minlength=B1).astype(np.int32)
    if n_row.max() > capA:
        return None
    order = np.argsort(coarse, kind="stable")
    starts = np.zeros(B1 + 1, np.int64)
    np.cumsum(n_row, out=starts[1:])
    col = np.arange(Q, dtype=np.int64) - starts[coarse[order]]
    flat = coarse[order] * capA + col
    lbits = 2 * k - b1
    ps_l = max(1, _ceil_div(lbits, 32))
    qlow = []
    hs, ls = hi[order], lo[order]
    for p in range(ps_l):
        pl = np.zeros(B1 * capA, np.uint32)
        pl[flat] = _suffix_plane_np(hs, ls, lbits, p)
        qlow.append(pl.reshape(B1, capA))
    perm = np.full(B1 * capA, -1, np.int64)
    perm[flat] = order
    return qlow, n_row, perm


def _route_queries_native(hi: np.ndarray, lo: np.ndarray, k: int,
                          cfg: dict, row_base: int = 0,
                          n_rows: int | None = None):
    """mt_bacj_route wrapper; NotImplemented when the library or the
    symbol is unavailable (caller runs the numpy reference)."""
    import ctypes

    from .. import native

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "mt_bacj_route"):
        return NotImplemented
    b1, capA = cfg["b1"], cfg["capA"]
    B1 = (1 << b1) if n_rows is None else n_rows
    Q = len(lo)
    lbits = 2 * k - b1
    ps_l = max(1, _ceil_div(lbits, 32))
    hi = np.ascontiguousarray(hi, np.uint64)
    lo = np.ascontiguousarray(lo, np.uint64)
    qlow = np.zeros((ps_l, B1, capA), np.uint32)
    n_row = np.zeros(B1, np.int32)
    perm = np.full(B1 * capA, -1, np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    rc = lib.mt_bacj_route(
        hi.ctypes.data_as(u64p), lo.ctypes.data_as(u64p),
        ctypes.c_int64(Q), ctypes.c_int32(2 * k),
        ctypes.c_int32(b1), ctypes.c_int64(row_base),
        ctypes.c_int64(B1), ctypes.c_int32(capA),
        ctypes.c_int32(ps_l),
        qlow.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n_row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(native.n_threads()))
    if rc == 1:
        return None    # row overflow: same contract as the numpy path
    if rc == 3:
        raise ValueError("query key outside segment row window")
    if rc != 0:
        return NotImplemented
    return [qlow[p] for p in range(ps_l)], n_row, perm


def _bits_from_planes(planes, lo_bit: int, nbits: int):
    """bits [lo_bit, lo_bit + nbits) (nbits <= 32) of multiword planes
    (any shape) as one u32 array."""
    p0 = lo_bit // 32
    off = lo_bit - 32 * p0
    v = planes[p0] >> U32(off)
    if off and p0 + 1 < len(planes):
        v = v | (planes[p0 + 1] << U32(32 - off))
    if nbits < 32:
        v = v & U32((1 << nbits) - 1)
    return v


@functools.partial(jax.jit, static_argnames=("cfg", "fused",
                                             "exists_only"))
def bacjoin_kernel(dbd, dbv, qlow, n_row, cfg, fused=None,
                   exists_only=False):
    """Resolve one routed query slab against the DB grid.

    dbd: ps x (B, s_cap) u32 suffix planes; dbv: (B, s_cap) u32
    qlow: ps_l x (B1, capA) u32 low-bit planes; n_row: (B1,) i32
    cfg: (k, b, b1, c, capA, s_cap, ovfcap) static

    -> vals (B1, capA) u32   value per real query, row-front packed
       pos  (B1, capA) u32   original column of each packed result
                             (SENT past the row's real count)
       ovf_pos (B1, ovfcap) u32  columns of cell-overflow queries
       n_ovf (B1,) i32          per-row overflow counts
    exists_only=True returns (packed, ovf_pos, n_ovf) instead, with
    packed = found-bit<<31 | column — half the download.
    """
    k, b, b1, c, capA, s_cap, ovfcap = cfg
    B2 = 1 << (b - b1)
    B1 = n_row.shape[0]
    lbits = 2 * k - b1
    sbits = 2 * k - b
    ps = len(dbd)

    pos = jax.lax.broadcasted_iota(U32, (B1, capA), 1)
    valid = pos < n_row[:, None].astype(U32)

    # fine-bucket id within the coarse row; invalid slots key past
    # every pad so they fall to the dropped tail
    fbl = _bits_from_planes(qlow, sbits, b - b1).astype(U32)
    key_q = jnp.where(valid, fbl * U32(2), U32(2 * B2 + 3))

    # c pads per fine bucket, keyed directly after their bucket's
    # queries: sorting [queries ++ pads] then ranking by cummax keeps
    # min(n_f, c) queries + (c - n_f) pads = EXACTLY c per bucket, so
    # the compaction sort's leading B2*c slots are the aligned cells
    # (no per-bucket counting — the routed join's count search costs
    # B1*B2*log2 gathers here)
    D = B2 * c
    pad_key = (jax.lax.broadcasted_iota(U32, (B2, c), 0) * U32(2)
               + U32(1)).reshape(D)
    key1 = jnp.concatenate(
        [key_q, jnp.broadcast_to(pad_key[None, :], (B1, D))], axis=1)
    pl1 = [jnp.concatenate(
        [q, jnp.zeros((B1, D), U32)], axis=1) for q in qlow]
    pos1 = jnp.concatenate(
        [jnp.where(valid, pos, U32(SENT)),
         jnp.full((B1, D), SENT, U32)], axis=1)
    srt1 = jax.lax.sort((key1,) + tuple(pl1) + (pos1,), num_keys=1,
                        dimension=-1)
    key1s, pl1s, pos1s = srt1[0], list(srt1[1:-1]), srt1[-1]

    W = capA + D
    seg = key1s >> U32(1)
    seg_start = jnp.concatenate(
        [jnp.ones((B1, 1), bool), seg[:, 1:] != seg[:, :-1]], axis=1)
    iot = jax.lax.broadcasted_iota(jnp.int32, (B1, W), 1)
    seg_base = jax.lax.cummax(jnp.where(seg_start, iot, -1), axis=1)
    kept = ((iot - seg_base) < c) & (seg < U32(B2))
    is_q = (key1s & U32(1)) == U32(0)
    # overflowing real queries (rank >= c) sort between the cells and
    # the dropped pads; the host resolves them exactly by binary search
    key2 = jnp.where(kept, seg,
                     jnp.where(is_q & (seg < U32(B2)), U32(B2),
                               U32(B2 + 1)))
    srt2 = jax.lax.sort((key2,) + tuple(pl1s) + (pos1s,), num_keys=1,
                        dimension=-1, is_stable=True)
    cells_q = [s[:, :D] for s in srt2[1:-1]]
    cells_pos = srt2[-1][:, :D]
    tail_pos = srt2[-1][:, D:D + ovfcap]
    n_ovf = jnp.sum((srt2[0][:, D:] == U32(B2)).astype(jnp.int32),
                    axis=1)

    # (B1, B2*c) bucket-major cells -> (B, c); the dense resolve:
    # lane j of every bucket compares against the bucket's whole DB
    # row in one streaming pass (c passes total; DB keys are unique
    # and padding carries value 0, so the match-sum is the value)
    # bucket count from the ROW slice, not 1 << b: a segmented grid
    # (out-of-core DBs) passes a contiguous row/bucket range and the
    # kernel is range-agnostic — fine-bucket ids are row-local
    B = B1 * B2
    cells_q = [cq.reshape(B, c) for cq in cells_q]
    cells_pos = cells_pos.reshape(B, c)

    if fused is None:
        fused = os.environ.get("MERYL_TPU_BACJ_FUSED", "1") != "0"
    if fused:
        # one (B, c, s_cap) broadcast-compare reduction: XLA reads the
        # grid ONCE for all c lanes (the per-lane loop below re-streams
        # dbd+dbv from device memory c times)
        eq = None
        for p in range(ps):
            qdp = _bits_from_planes(cells_q, 32 * p,
                                    min(32, sbits - 32 * p))  # (B, c)
            e = dbd[p][:, None, :] == qdp[:, :, None]
            eq = e if eq is None else (eq & e)
        val_cells = jnp.sum(jnp.where(eq, dbv[:, None, :], U32(0)),
                            axis=2, dtype=jnp.uint32)  # (B, c)
    else:
        vals = []
        for j in range(c):
            lane = [cq[:, j] for cq in cells_q]
            eq = None
            for p in range(ps):
                qdp = _bits_from_planes(lane, 32 * p,
                                        min(32, sbits - 32 * p))
                e = dbd[p] == qdp[:, None]
                eq = e if eq is None else (eq & e)
            vals.append(jnp.sum(jnp.where(eq, dbv, U32(0)), axis=1,
                                dtype=jnp.uint32))
        val_cells = jnp.stack(vals, axis=1)  # (B, c)

    # pack results to each coarse row's front; reals per row <= n_row
    # <= capA by construction, so (B1, capA) is a static full cover.
    # Screening callers (existence / include / exclude / -bed /
    # -wig-depth — the dominant meryl-lookup workload) only need a
    # found bit: exists mode packs it into bit 31 of the position
    # word, halving both the compaction-sort payload and the
    # device->host download (capA < 2^22 << 2^31, so the bit is free)
    valr = val_cells.reshape(B1, D)
    posr = cells_pos.reshape(B1, D)
    flag = jnp.where(posr == U32(SENT), U32(1), U32(0))
    if exists_only:
        packed = jnp.where(
            posr == U32(SENT), U32(SENT),
            posr | jnp.where(valr > U32(0), U32(1) << U32(31),
                             U32(0)))
        srt3 = jax.lax.sort((flag, packed), num_keys=1, dimension=-1,
                            is_stable=True)
        return srt3[1][:, :capA], tail_pos, n_ovf
    srt3 = jax.lax.sort((flag, valr, posr), num_keys=1, dimension=-1,
                        is_stable=True)
    return srt3[1][:, :capA], srt3[2][:, :capA], tail_pos, n_ovf
