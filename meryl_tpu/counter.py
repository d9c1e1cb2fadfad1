"""Counting driver: sequence files -> sorted unique (kmer, count) arrays -> DB.

Device replacement for the reference's threaded counter
(/root/reference/src/meryl/merylOp-countThreads.C): instead of
spin-locked prefix buckets + std::sort per bucket, each fixed-size chunk
of bases is encoded, canonicalized, sorted and run-length counted on
device in one fused jitted pipeline; chunk results (already deduplicated
within the chunk) are merged at the end.  Out-of-core behavior (the
reference's batch dumps, merylOp-count.C:577-603) maps to spilling
chunk results to host RAM and merging there.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import kmer as km
from .db import MerylDB
from .io.sequence import SequenceChunker
from .ops import count as cnt
from .ops import extract as ext

import os as _os
import time as _time

def default_chunk() -> int:
    """Bases per device chunk (env MERYL_TPU_CHUNK, read at call time
    so tests/dryruns can shrink it); sort cost is superlinear in chunk
    size."""
    return int(_os.environ.get("MERYL_TPU_CHUNK", 1 << 22))


def shard_default_chunk() -> int:
    """Per-DEVICE bases per SPMD step (env MERYL_TPU_SHARD_CHUNK).
    The routed step (round 5) sorts only row-batched rows (its
    routing rows are L0 <= 2^18 regardless of chunk size), so chunk
    size no longer trades against a flat-sort wall — it only
    amortizes per-step fixed costs (collective launch, control
    scalars) against HBM footprint (cell grid + staged groups,
    ~1.7 x chunk x 8 B each).  2^22 matches the single-chip chunk."""
    return int(_os.environ.get("MERYL_TPU_SHARD_CHUNK", 1 << 22))


def _sort_rowlen(chunk_len: int) -> int | None:
    """Row length for the chunk sort: chunks are sorted as independent
    rows (one long sort row is the slow shape), and the host merge
    union-sums duplicates across rows.  None disables (tiny chunks, or
    MERYL_TPU_ROWLEN=0)."""
    # default 2^11: shorter rows sort faster on the device, but every
    # halving of the row doubles the host k-way finish merge's fan-in;
    # 2^11 balances the two for the host-merge path (the accumulator
    # path has its own routing geometry and ignores this knob).
    r = int(_os.environ.get("MERYL_TPU_ROWLEN", 1 << 11))
    if r <= 0 or chunk_len % r or chunk_len // r <= 1:
        return None
    return r

# device-side compaction before download: costs extra device time but
# downloads only the unique prefix — a win when the device->host link
# is slow or data has high coverage (uniques << windows).  Default:
# host compaction.
_COMPACT_DEVICE = _os.environ.get("MERYL_TPU_COMPACT", "host") == "device"


def _suffix_filter(planes, valid, suffix):
    if suffix is not None:
        sbits, slen = suffix
        need = 2 * slen
        for p, pl in enumerate(planes):
            bits_here = min(32, need - 32 * p)
            if bits_here <= 0:
                break
            want = jnp.uint32((sbits >> (32 * p)) & ((1 << bits_here) - 1))
            mask = jnp.uint32((1 << bits_here) - 1 if bits_here < 32
                              else 0xFFFFFFFF)
            valid = valid & ((pl & mask) == want)
    return planes, valid


def _extract_any(codes_or_packed, k, mode):
    """Extraction for both wire formats: a plain (L,) uint8 codes
    array, or the packed triple (packed2, exc, n_real) from
    km.pack_codes_2bit (4x less h2d wire; extract_kmers_packed)."""
    if isinstance(codes_or_packed, tuple):
        packed2, exc, n_real = codes_or_packed
        return ext.extract_kmers_packed(packed2, exc, n_real, k, mode)
    return ext.extract_kmers(codes_or_packed, k, mode)


@functools.partial(jax.jit, static_argnames=("k", "mode", "suffix",
                                              "rowlen"))
def _chunk_pipeline(codes, k: int, mode: str, suffix=None, rowlen=None):
    """codes (L,) uint8 OR packed triple -> (sorted planes, start mask,
    n_invalid).

    Device program is extract + sort + neighbor-compare only; run
    lengths are recovered on the host from start positions
    (cnt.sort_starts rationale).  suffix: optional (bits, length)
    static pair — only count kmers whose last `length` bases encode to
    `bits` (the reference's count-suffix, merylOp-countSimple.C:50-90)."""
    planes, valid = _suffix_filter(*_extract_any(codes, k, mode), suffix)
    return cnt.sort_starts(planes, valid, rowlen)


@functools.partial(jax.jit, static_argnames=("k", "mode", "suffix"))
def _chunk_pipeline_compacted(codes, k: int, mode: str, suffix=None):
    planes, valid = _suffix_filter(*_extract_any(codes, k, mode), suffix)
    return cnt.sort_count_compacted(planes, valid)


def _wire_chunk(chunk: np.ndarray):
    """Host chunk -> device wire arrays.  MERYL_TPU_PACK_WIRE=0 ships
    raw uint8 codes (1 B/base); default packs to 2-bit words + an
    exception list (0.25 B/base + ~4 B/read)."""
    if _os.environ.get("MERYL_TPU_PACK_WIRE", "1") == "0":
        return jnp.asarray(chunk)
    packed2, exc, n_real = km.pack_codes_2bit(chunk)
    return (jnp.asarray(packed2), jnp.asarray(exc), jnp.uint32(n_real))


def _count_chunk(chunk, k: int, mode: str, suffix=None):
    """Dispatch one chunk (host np codes or pre-built wire arrays);
    returns an opaque device result for _finish_chunk (keeps the
    1-deep host/device pipeline)."""
    if isinstance(chunk, np.ndarray):
        L = len(chunk)
        chunk = _wire_chunk(chunk)
    elif isinstance(chunk, tuple):
        L = chunk[0].shape[0] * 16
    else:
        L = chunk.shape[0]
    if _COMPACT_DEVICE:
        return (_chunk_pipeline_compacted(chunk, k, mode, suffix), None)
    rowlen = _sort_rowlen(L)
    return (_chunk_pipeline(chunk, k, mode, suffix, rowlen), rowlen)


def _finish_chunk(result, rowlen=None):
    """Device result -> LIST of host (hi, lo, counts-u64) sorted unique
    triples (one per sort row — rows are independently sorted, so each
    is its own run for the merge cascade)."""
    if _COMPACT_DEVICE:
        uplanes, counts, n_unique = result
        n = int(n_unique)
        planes_np = [np.asarray(p[:n]) for p in uplanes]
        c = np.asarray(counts[:n]).astype(np.uint64)
        hi, lo = km.hilo_from_planes(planes_np)
        return [(hi, lo, c)]
    splanes, start, n_invalid = result
    planes_np, c, idx = cnt.host_rle_finish(
        [np.asarray(p) for p in splanes], np.asarray(start),
        np.asarray(n_invalid) if rowlen else int(n_invalid), rowlen)
    hi, lo = km.hilo_from_planes(planes_np)
    if rowlen is None:
        return [(hi, lo, c)]
    # split at row boundaries: each row is independently sorted
    rows = len(start) // rowlen
    cuts = np.searchsorted(idx, np.arange(1, rows) * rowlen)
    out = []
    prev = 0
    for cut in list(cuts) + [len(c)]:
        if cut > prev:
            out.append((hi[prev:cut], lo[prev:cut], c[prev:cut]))
        prev = cut
    return out


def merge_runs(runs):
    """Merge per-chunk unique (hi, lo, counts-u64) triples into one
    globally sorted unique triple; counts clamped to kmvalu max.

    Uses the native linear-time pairwise merge cascade when available
    (each run is already sorted; lexsort would re-sort from scratch)."""
    if not runs:
        z = np.zeros(0, np.uint64)
        return z, z.copy(), np.zeros(0, np.uint32)

    from . import native
    if native.available() and len(runs) > 1:
        lib = native.get_lib()
        if len(runs) > 2 and hasattr(lib, "mt_merge_kway"):
            # single-pass tournament (bandwidth: 1 read + 1 write per
            # entry) beats the log2(n)-pass cascade for any real fan-in
            hi, lo, c = native.merge_kway(runs)
        else:
            hi, lo, c = native.merge_cascade(runs)
        counts = np.minimum(c, km.VALUE_MAX).astype(np.uint32)
        return hi, lo, counts

    hi = np.concatenate([r[0] for r in runs])
    lo = np.concatenate([r[1] for r in runs])
    c = np.concatenate([r[2] for r in runs]).astype(np.uint64)
    order = np.lexsort((lo, hi))
    hi, lo, c = hi[order], lo[order], c[order]
    new = np.empty(len(hi), dtype=bool)
    new[0:1] = True
    np.logical_or(hi[1:] != hi[:-1], lo[1:] != lo[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    csum = np.add.reduceat(c, starts) if len(starts) else np.zeros(0, np.uint64)
    counts = np.minimum(csum, km.VALUE_MAX).astype(np.uint32)
    return hi[starts], lo[starts], counts


class AccCapacity(Exception):
    """The accumulator would outgrow its HBM budget: the driver
    salvages the device state exactly and finishes on the host path."""


class DeviceAccCounter:
    """Single-chip device-accumulator counting driver (ops/accum.py):
    the device keeps the running sorted-unique (kmer, count) set; the
    host never merges and downloads only the final uniques.  This is
    the end-to-end fast path for inputs whose unique set fits HBM —
    the structure-forced host merge caps e2e counting otherwise (the
    same bind the reference's CPU merge has,
    merylOp-countThreads.C:384-474).

    Correctness hatches (all exact):
      * cell overflow (adversarial composition skew): the chunk is
        recounted on the host path and union-merged at finalize
      * accumulator row overflow: the merge is re-dispatched with a
        grown row capacity (the old accumulator and staged cells stay
        alive until the new one is verified)
      * the all-ones kmer (real when 2k % 32 == 0) is counted by a
        device scalar and appended at finalize, so the sentinel never
        aliases a real key
    """

    def __init__(self, k: int, mode: str, chunk_len: int,
                 expected_uniques: int):
        from .ops import accum
        self.k = int(k)
        self.P = km.num_planes(self.k)
        self.mode = mode
        self.chunk_len = int(chunk_len)
        plan = accum.plan_route(self.chunk_len, self.k,
                                max(1, expected_uniques))
        self.B = plan["B"]
        self.M = plan["M"]
        self.La = plan["La0"]
        self.cfg = (self.k, self.P, mode, self.B, plan["R0"],
                    plan["L0"], plan["c"], plan["bits"])
        self._acc = None
        self._staged = []          # routed cell tuples awaiting merge
        self._pending = []         # (cells, ovf, n_ovf_row, codes,
                                   #  n_allones devscalar)
        self._nallones = []        # device scalars, fetched at the end
        self._fallback_runs = []   # host-counted overflow chunks
        self._ovf_planes = []      # captured cell-overflow windows
        from .budget import budget_bytes
        self._cap_bytes = budget_bytes("acc")
        # wire accounting (bench decomposition: the volumes that cross
        # the host<->device link, independent of what the link costs)
        self.wire_h2d_bytes = 0
        self.wire_d2h_bytes = 0
        self._bases_seen = 0   # drives the packed-download bit split
        # sync-point accounting: every host<->device
        # interaction is counted and its HOST-BLOCKED time accumulated,
        # so the e2e residual decomposes into measured categories
        # instead of one prose-attributed lump.  n_h2d = device_puts,
        # n_dispatch = jitted-call invocations (async unless the
        # backend serializes), n_fetch = blocking downloads (np.asarray
        # / int() of device values) — the true serialization points.
        self.sync = {"n_h2d": 0, "n_dispatch": 0, "n_fetch": 0,
                     "t_h2d_s": 0.0, "t_dispatch_s": 0.0,
                     "t_fetch_s": 0.0, "host_pack_s": 0.0,
                     "host_finalize_s": 0.0}

    def _put(self, x):
        t0 = _time.perf_counter()
        r = jnp.asarray(x)
        self.sync["n_h2d"] += 1
        self.sync["t_h2d_s"] += _time.perf_counter() - t0
        return r

    def _dispatch(self, fn, *args, **kw):
        t0 = _time.perf_counter()
        r = fn(*args, **kw)
        self.sync["n_dispatch"] += 1
        self.sync["t_dispatch_s"] += _time.perf_counter() - t0
        return r

    def _fetch(self, x):
        t0 = _time.perf_counter()
        r = np.asarray(x)
        self.sync["n_fetch"] += 1
        self.sync["t_fetch_s"] += _time.perf_counter() - t0
        return r

    def _fetch_int(self, x):
        t0 = _time.perf_counter()
        r = int(x)
        self.sync["n_fetch"] += 1
        self.sync["t_fetch_s"] += _time.perf_counter() - t0
        return r

    def _fresh_acc(self):
        zp = tuple(jnp.full((self.B, self.La), 0xFFFFFFFF, jnp.uint32)
                   for _ in range(self.P))
        zc = jnp.zeros((self.B, self.La), jnp.uint32)
        return (zp, zc)

    def prepack(self, codes: np.ndarray):
        """Pad + 2-bit-pack one chunk for add_codes — runs on the
        PREFETCH READER THREAD (via _prefetch_chunks' transform) so
        the pack overlaps device dispatches instead of serializing
        with them."""
        from .io.sequence import SEP
        n_orig = len(codes)
        if n_orig < self.chunk_len:
            codes = np.concatenate(
                [codes, np.full(self.chunk_len - n_orig, SEP,
                                np.uint8)])
        packed2, exc, n_real = km.pack_codes_2bit(
            codes, pad_to=self.chunk_len)
        return (codes, packed2, exc, n_real, n_orig)

    def add_codes(self, codes):
        """codes: (chunk_len,) uint8 host codes, or a prepack() tuple
        (the 2-bit pack then rode the reader thread)."""
        from .io.sequence import SEP
        from .ops import accum
        prepacked = isinstance(codes, tuple)
        if prepacked:
            codes, packed2, exc, n_real, n_orig = codes
            self._bases_seen += int(n_orig)
        else:
            self._bases_seen += int(len(codes))
            if len(codes) < self.chunk_len:
                codes = np.concatenate(
                    [codes, np.full(self.chunk_len - len(codes), SEP,
                                    np.uint8)])
        if _os.environ.get("MERYL_TPU_PACK_WIRE", "1") == "0":
            self.wire_h2d_bytes += codes.nbytes
            cells, ovf, n_ovf_row, n_allones = self._dispatch(
                accum.route_chunk, self._put(codes), self.cfg)
        else:
            if not prepacked:
                t0 = _time.perf_counter()
                packed2, exc, n_real = km.pack_codes_2bit(
                    codes, pad_to=self.chunk_len)
                self.sync["host_pack_s"] += _time.perf_counter() - t0
            self.wire_h2d_bytes += packed2.nbytes + exc.nbytes
            cells, ovf, n_ovf_row, n_allones = self._dispatch(
                accum.route_chunk_packed, self._put(packed2),
                self._put(exc), jnp.uint32(n_real), self.cfg)
        # n_allones travels WITH the pending chunk: it is committed to
        # self._nallones only when the chunk's cells are staged — a
        # host-path recount (cell overflow > OVF_CAP) counts the
        # all-ones kmer itself, so committing eagerly double-counts it
        self._pending.append((cells, ovf, n_ovf_row, codes, n_allones))
        # overflow scalars are checked in a batch at merge cadence —
        # a per-chunk int() fetch costs one blocking round trip per chunk
        # (raw chunk codes are kept until their check clears, so an
        # overflowed chunk can still be recounted exactly)
        if len(self._pending) >= self.M:
            self._resolve_batch()
        if len(self._staged) >= self.M:
            self._merge()

    def _resolve_batch(self):
        """Resolve every pending chunk with ONE device fetch for all
        their overflow-row vectors instead of a blocking round trip per
        chunk."""
        from .ops.accum import OVF_CAP
        if not self._pending:
            return
        stacked = self._fetch(self._dispatch(
            jnp.stack, [item[2] for item in self._pending]))
        # ONE stacked fetch for every capture region in the batch
        # instead of ~2 blocking round trips per chunk with any capture
        # traffic
        need = [i for i in range(len(self._pending))
                if 0 < int(stacked[i].max(initial=0)) <= OVF_CAP]
        ovf_np = {}
        if need:
            ov = self._fetch(self._dispatch(
                jnp.stack,
                [jnp.stack(self._pending[i][1]) for i in need]))
            for j, i in enumerate(need):
                ovf_np[i] = [ov[j, p] for p in range(self.P)]
        for i, item in enumerate(self._pending):
            self._resolve(item, nrow=stacked[i], ovf_np=ovf_np.get(i))
        self._pending = []

    def _resolve(self, item, nrow=None, ovf_np=None):
        from .ops.accum import OVF_CAP
        cells, ovf, n_ovf_row, codes, n_allones = item
        if nrow is None:
            nrow = self._fetch(n_ovf_row)
        mx = int(nrow.max()) if len(nrow) else 0
        if mx > OVF_CAP:
            # adversarial composition blew a whole capture row:
            # recount this chunk on the host path (exact), drop cells
            # AND the chunk's all-ones scalar — the host recount
            # counts the all-ones kmer itself
            self._fallback_runs.extend(_finish_chunk(
                *_count_chunk(codes, self.k, self.mode, None)))
            return
        self._nallones.append(n_allones)
        if mx > 0:
            # thin Poisson tail: the overflowed windows sit at the
            # head of each capture row — collect them host-side
            # (batch-prefetched by _resolve_batch when possible)
            planes = ovf_np if ovf_np is not None \
                else [self._fetch(p) for p in ovf]
            for r in np.flatnonzero(nrow):
                n = int(nrow[r])
                self._ovf_planes.append(
                    [p[r, :n].copy() for p in planes])
        self._staged.append(cells)

    def _merge(self):
        """Dispatch a merge of the staged cell groups and DEFER its
        row-overflow verification to the next merge cadence (or
        finalize/salvage): the nmax fetch then costs one round trip
        instead of merge-latency + round trip, and the device
        folds while the host packs and dispatches the next chunks.
        The pre-merge accumulator and the staged groups stay alive in
        _unverified until the check clears — exactness unchanged."""
        from .ops import accum
        if self._acc is None:
            self._acc = self._fresh_acc()
        self._verify_merge()
        staged = tuple(self._staged)
        planes, counts, n_runs = self._dispatch(
            accum.merge_cells,
            self._acc[0], self._acc[1], staged, self.P, self.La,
            int(km.VALUE_MAX))
        self._unverified = (planes, counts, n_runs, self._acc, staged,
                            self.La)
        self._acc = (planes, counts)  # optimistic: overflow is rare
        self._staged = []

    def _verify_merge(self):
        """Resolve the previous deferred merge: fetch its nmax and, on
        the rare row overflow, fall back to the blocking regrow loop
        against the preserved pre-merge accumulator.  On AccCapacity
        the pre-merge state (old acc + staged groups) is restored so
        salvage() rescues exactly what existed before the merge."""
        from .ops import accum
        uv = getattr(self, "_unverified", None)
        if uv is None:
            return
        self._unverified = None
        planes, counts, n_runs, old_acc, staged, la_then = uv
        hi = self._fetch_int(jnp.max(n_runs))
        if hi <= la_then:
            self._max_run = hi
            return
        # row overflow: regrow and re-merge (old acc still alive)
        acc = old_acc
        la = la_then
        while True:
            new_la = la
            while new_la < hi:
                new_la *= 2
            # (P planes + counts) u32 x3 for the merge working set
            if new_la * self.B * (self.P + 1) * 4 * 3 > self._cap_bytes:
                self._acc = old_acc
                self.La = la_then
                self._staged = list(staged) + self._staged
                raise AccCapacity()
            la = new_la
            acc = (
                tuple(jnp.concatenate(
                    [p, jnp.full((self.B, la - p.shape[1]),
                                 0xFFFFFFFF, jnp.uint32)], axis=1)
                    for p in acc[0]),
                jnp.concatenate(
                    [acc[1],
                     jnp.zeros((self.B, la - acc[1].shape[1]),
                               jnp.uint32)], axis=1))
            planes, counts, n_runs = self._dispatch(
                accum.merge_cells, acc[0], acc[1], staged, self.P, la,
                int(km.VALUE_MAX))
            hi = self._fetch_int(jnp.max(n_runs))
            if hi <= la:
                break
        self.La = la
        self._max_run = hi
        self._acc = (planes, counts)

    def salvage(self):
        """Exact device-state rescue when the accumulator hit its HBM
        budget (AccCapacity): download the accumulator and every
        staged cell group, count them host-side, and return the run
        list — the driver finishes the remaining input on the host
        path and union-merges everything."""
        self._resolve_batch()
        try:
            self._verify_merge()
        except AccCapacity:
            pass  # pre-merge acc + staged groups restored by the raise
        runs = list(self._fallback_runs)
        self._fallback_runs = []
        if self._acc is not None:
            planes_np = [np.asarray(p).reshape(-1) for p in self._acc[0]]
            counts_np = np.asarray(self._acc[1]).reshape(-1)
            keepm = counts_np > 0
            hi, lo = km.hilo_from_planes([p[keepm] for p in planes_np])
            runs.append((hi, lo, counts_np[keepm].astype(np.uint64)))
            self._acc = None
        for cells in self._staged:
            planes_np = [np.asarray(p).reshape(-1) for p in cells]
            real = ~np.logical_and.reduce(
                [p == 0xFFFFFFFF for p in planes_np])
            hi, lo = km.hilo_from_planes([p[real] for p in planes_np])
            order = np.lexsort((lo, hi))
            hi, lo = hi[order], lo[order]
            new = np.empty(len(hi), bool)
            new[:1] = True
            np.logical_or(hi[1:] != hi[:-1], lo[1:] != lo[:-1],
                          out=new[1:])
            st = np.flatnonzero(new)
            cnt = np.diff(np.append(st, len(hi))).astype(np.uint64)
            runs.append((hi[st], lo[st], cnt))
        self._staged = []
        if self._ovf_planes:
            planes = [np.concatenate([o[p] for o in self._ovf_planes])
                      for p in range(self.P)]
            ohi, olo = km.hilo_from_planes(planes)
            order = np.lexsort((olo, ohi))
            ohi, olo = ohi[order], olo[order]
            new = np.empty(len(ohi), bool)
            new[:1] = True
            np.logical_or(ohi[1:] != ohi[:-1], olo[1:] != olo[:-1],
                          out=new[1:])
            st = np.flatnonzero(new)
            cnt = np.diff(np.append(st, len(ohi))).astype(np.uint64)
            runs.append((ohi[st], olo[st], cnt))
            self._ovf_planes = []
        n_allones = sum(int(x) for x in self._nallones)
        self._nallones = []
        if n_allones:
            twok = 2 * self.k
            runs.append((np.array([(1 << max(0, twok - 64)) - 1],
                                  np.uint64),
                         np.array([(1 << min(64, twok)) - 1], np.uint64),
                         np.array([n_allones], np.uint64)))
        return runs

    def _download_packed(self, lmax: int):
        """Gap-packed accumulator download (ops/accum.pack_for_download):
        one u32 per unique instead of P + 1, a ~3x cut of the d2h
        transfer, in ONE blocking fetch (pack_for_download_fused).
        Column 0 of each row crosses dense (the cumsum base); exceptions
        (unpackable gap/count) are re-applied by position.  Returns None
        when any row's exceptions overflow the capture arrays — the
        caller falls back to the dense download, so this path is exact
        or absent, never approximate."""
        from .ops import accum

        planes, counts = self._acc
        # the kernel sizes the gap field PER ROW from each row's own
        # max gap and derives the count field's floor from coverage
        # (bases / uniques) ON DEVICE — one dispatch, ONE blocking
        # fetch for the whole download
        B, EC = self.B, accum.EXC_ROW_CAP
        blob = self._fetch(self._dispatch(
            accum.pack_for_download_fused, planes, counts, self.P,
            jnp.float32(self._bases_seen), lmax))
        offs = np.cumsum([B * lmax] + [B] * (3 + self.P)
                         + [B * EC] * (2 + self.P))[:-1]
        (packed_f, gbits_f, nexc_f, headc_f, *rest) = \
            np.split(blob, offs)
        headp_f = rest[:self.P]
        exccol_f, exccnt_f = rest[self.P], rest[self.P + 1]
        excp_f = rest[self.P + 2:]
        packed = packed_f.reshape(B, lmax)
        n_exc_row = nexc_f.astype(np.int32)
        # rows whose exceptions overflow the capture arrays download
        # DENSE (hybrid): the equal-mass routing map gives rows equal
        # counts, so rows covering sparse key ranges (canonical keys
        # thin out toward the top of the space) have in-row gaps far
        # past the global-mean-sized gap field — a handful of wide
        # rows, not a reason to give up the 3x cut on the rest
        dense_rows = np.flatnonzero(n_exc_row > accum.EXC_ROW_CAP)
        if len(dense_rows) > max(4, B // 4):
            return None
        head_p = [p.astype(np.uint64) for p in headp_f]
        head_c = headc_f
        exc_col = exccol_f.reshape(B, EC)
        exc_p = [p.reshape(B, EC).astype(np.uint64) for p in excp_f]
        exc_cnt = exccnt_f.reshape(B, EC)
        # wire accounting accumulates LOCALLY and commits only on the
        # successful return: the exception loop below can still bail to
        # the dense fallback, which does its own (full) accounting — an
        # eager commit here would double-count that path's d2h bytes
        d2h_bytes = blob.nbytes + 4

        cbits_row = (32 - gbits_f.astype(np.int32)).astype(np.uint32)
        # host decode time = wall inside this window minus any fetch
        # time the dense-row hatch spends blocked on the device
        t_host0 = _time.perf_counter()
        t_fetch_at_host0 = self.sync["t_fetch_s"]
        lo0 = head_p[0]
        if self.P == 2:
            lo0 = lo0 | (head_p[1] << np.uint64(32))
        gaps = (packed >> cbits_row[:, None]).astype(np.uint64)
        cnts = (packed & ((np.uint32(1) << cbits_row[:, None])
                          - np.uint32(1))).astype(np.uint32)
        is_exc = packed == 0xFFFFFFFF
        gaps[is_exc] = 0
        gaps[:, 0] = 0
        keys = gaps
        keys[:, 0] = lo0
        np.cumsum(keys, axis=1, out=keys)
        # exceptions: absolute key + count, correction propagates to
        # the rest of the row (later gaps are relative to the true
        # predecessor); rows ascending, columns ascending, so applying
        # in array order keeps each correction downstream-consistent
        for r in np.flatnonzero(
                (n_exc_row > 0) & (n_exc_row <= accum.EXC_ROW_CAP)):
            for j in range(int(n_exc_row[r])):
                c = int(exc_col[r, j])
                if c >= lmax:
                    return None  # entry past the downloaded prefix
                t = exc_p[0][r, j]
                if self.P == 2:
                    t = t | (exc_p[1][r, j] << np.uint64(32))
                keys[r, c:] += t - keys[r, c]
                cnts[r, c] = exc_cnt[r, j]
        m = packed != 0
        m[:, 0] = head_c > 0
        cnts[:, 0] = head_c
        if len(dense_rows):
            dr = jnp.asarray(dense_rows)
            dp = [self._fetch(jnp.take(p[:, :lmax], dr, axis=0))
                  .astype(np.uint64) for p in planes]
            dc = self._fetch(jnp.take(counts[:, :lmax], dr, axis=0))
            d2h_bytes += (sum(p.nbytes // 2 for p in dp)
                          + dc.nbytes)
            dk = dp[0]
            if self.P == 2:
                dk = dk | (dp[1] << np.uint64(32))
            keys[dense_rows] = dk
            cnts[dense_rows] = dc
            m[dense_rows] = dc > 0
        lo = keys[m]
        cts = cnts[m]
        hi = np.zeros(len(lo), np.uint64)
        self.wire_d2h_bytes += d2h_bytes
        self.sync["host_finalize_s"] += (_time.perf_counter() - t_host0
                                         - self.sync["t_fetch_s"]
                                         + t_fetch_at_host0)
        return (hi, lo, cts.astype(np.uint64))

    def finalize(self):
        """-> sorted unique (hi, lo, counts-u32)."""
        self._resolve_batch()
        if self._staged:
            self._merge()
        self._verify_merge()
        # ONE batched fetch for all per-chunk all-ones scalars (a
        # per-chunk int() would pay one round trip per chunk)
        n_allones = 0
        if self._nallones:
            n_allones = self._fetch_int(jnp.sum(jnp.stack(
                [jnp.asarray(x) for x in self._nallones])))

        if self._acc is None:
            acc_run = None
        else:
            # download only the used row prefix: the accumulator is
            # sized from the (file-size-based) over-estimate
            # (eighth-pow2 quantized so the fused download's static
            # lmax does not mint a jit signature per run)
            from .ops import accum as _accum
            lmax = min(self.La, _accum._eighth_round(
                max(256, getattr(self, "_max_run", self.La))))
            acc_run = None
            if (2 * self.k <= 64
                    and _os.environ.get("MERYL_TPU_PACK_D2H",
                                        "1") != "0"):
                acc_run = self._download_packed(lmax)
            if acc_run is None:  # k > 32, knob off, or hatch overflow
                self.wire_d2h_bytes += self.B * lmax * 4 * (self.P + 1)
                planes_np = [self._fetch(p[:, :lmax]).reshape(-1)
                             for p in self._acc[0]]
                counts_np = self._fetch(
                    self._acc[1][:, :lmax]).reshape(-1)
                keepm = counts_np > 0
                planes_np = [p[keepm] for p in planes_np]
                hi, lo = km.hilo_from_planes(planes_np)
                acc_run = (hi, lo, counts_np[keepm].astype(np.uint64))

        runs = ([acc_run] if acc_run is not None else []) \
            + self._fallback_runs
        if self._ovf_planes:
            # captured cell-overflow windows: raw kmers, count 1 each.
            # Defense in depth (and parity with salvage): drop any
            # sentinel-keyed entry — the all-ones real kmer is excluded
            # at extraction and counted by scalar, so a sentinel here
            # can only be capture-region padding
            P = self.P
            planes = [np.concatenate([o[p] for o in self._ovf_planes])
                      for p in range(P)]
            real = ~np.logical_and.reduce(
                [p == 0xFFFFFFFF for p in planes])
            planes = [p[real] for p in planes]
            ohi, olo = km.hilo_from_planes(planes)
            order = np.lexsort((olo, ohi))
            ohi, olo = ohi[order], olo[order]
            new = np.empty(len(ohi), bool)
            new[:1] = True
            np.logical_or(ohi[1:] != ohi[:-1], olo[1:] != olo[:-1],
                          out=new[1:])
            st = np.flatnonzero(new)
            cnt = np.diff(np.append(st, len(ohi))).astype(np.uint64)
            runs.append((ohi[st], olo[st], cnt))
        hi, lo, counts = merge_runs(runs)
        if n_allones:
            twok = 2 * self.k
            ao_lo = np.uint64((1 << min(64, twok)) - 1)
            ao_hi = np.uint64((1 << max(0, twok - 64)) - 1)
            n = min(n_allones, int(km.VALUE_MAX))
            if len(lo) and hi[-1] == ao_hi and lo[-1] == ao_lo:
                counts[-1] = min(int(counts[-1]) + n, int(km.VALUE_MAX))
            else:
                hi = np.append(hi, ao_hi)
                lo = np.append(lo, ao_lo)
                counts = np.append(counts, np.uint32(n))
        return hi, lo, counts


def _use_device_acc(count_suffix, paths, k, chunk_len) -> int:
    """Expected-uniques estimate when the device-accumulator path
    should run, else 0.  Env MERYL_TPU_DEVICE_ACC=1/0 forces; auto =
    on for a single non-CPU device when the expected unique set fits
    the accumulator budget."""
    if count_suffix is not None:
        return 0
    env = _os.environ.get("MERYL_TPU_DEVICE_ACC", "auto")
    if env == "0":
        return 0
    import jax
    exp = 0
    try:
        plan = configure_counting(paths, k, chunk_len=chunk_len)
        exp = min(plan["expected_kmers"],
                  4 ** k if k < 32 else 1 << 63)
    except OSError:
        return 0
    if env == "1":
        return max(1, exp)
    if jax.device_count() != 1 or jax.default_backend() == "cpu":
        return 0
    from .budget import budget_bytes
    cap = budget_bytes("acc")
    # (P planes + counts) x u32, x3 for the merge sort's working set;
    # the admission estimate uses the same FASTQ/dedup discount the
    # accumulator sizes itself with — if uniques really outgrow the
    # budget mid-run, AccCapacity salvages the device state exactly
    # and the rest of the input finishes on the host path
    acc_bytes = (km.num_planes(k) + 1) * 4 * 3
    if exp * 0.35 * acc_bytes > cap:
        return 0
    return max(1, exp)


# wire volumes of the most recent device-accumulator run (set by
# count_to_arrays_device_acc; read by bench.py to decompose the e2e
# wall clock into link and compute terms)
LAST_WIRE_STATS: dict = {}


def _prefetch_chunks(chunker, depth: int = 2, transform=None,
                     stats: dict | None = None):
    """Iterate a SequenceChunker through a small queue fed by a reader
    thread: the host file scan (native scanner + decompression) — and
    any per-chunk `transform` (the device-acc path packs the 2-bit
    wire here) — overlaps the device dispatches instead of serializing
    with the M-cadence fetch barriers.  The reader owns the chunker;
    errors re-raise at the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()

    def _reader():
        busy = 0.0
        try:
            it = iter(chunker)
            while True:
                t0 = _time.perf_counter()
                try:
                    c = next(it)
                except StopIteration:
                    break
                if transform is not None:
                    c = transform(c)
                busy += _time.perf_counter() - t0
                q.put(c)
            if stats is not None:
                stats["reader_busy_s"] = round(busy, 4)
            q.put(DONE)
        except BaseException as e:  # surface reader errors, then stop
            q.put(e)

    t = threading.Thread(target=_reader, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def count_to_arrays_device_acc(paths, k: int, mode: str, hpc: bool,
                               chunk_len: int, expected_uniques: int,
                               progress=None, segment=None):
    acc = DeviceAccCounter(k, mode, chunk_len, expected_uniques)
    nbases = 0
    transform = acc.prepack \
        if _os.environ.get("MERYL_TPU_PACK_WIRE", "1") != "0" else None
    reader_stats: dict = {}
    # depth 4: the consumer drains in bursts around the M-cadence
    # fetch barriers; a 2-deep queue re-stalls right after each one
    it = iter(_prefetch_chunks(SequenceChunker(paths, k, chunk_len,
                                               hpc=hpc,
                                               segment=segment),
                               depth=4, transform=transform,
                               stats=reader_stats))
    salvage_runs = None
    scan_stall_s = 0.0  # consumer time blocked on the reader thread
    while True:
        t0 = _time.perf_counter()
        try:
            chunk = next(it)
        except StopIteration:
            scan_stall_s += _time.perf_counter() - t0
            break
        scan_stall_s += _time.perf_counter() - t0
        n_chunk = chunk[4] if isinstance(chunk, tuple) else len(chunk)
        try:
            acc.add_codes(chunk)
        except AccCapacity:
            # the unique set outgrew the accumulator's HBM budget:
            # rescue the device state exactly and finish the stream
            # on the host sort+merge path
            salvage_runs = acc.salvage()
            break
        nbases += n_chunk
        if progress:
            progress(nbases)
    if salvage_runs is not None:
        runs = salvage_runs
        for chunk in it:
            if isinstance(chunk, tuple):
                # prepack() already built the 2-bit wire on the reader
                # thread — hand _count_chunk the wire triple directly
                # (re-packing the raw codes would double the host pack
                # cost for the whole post-salvage stream)
                n_chunk = chunk[4]
                chunk = (jnp.asarray(chunk[1]), jnp.asarray(chunk[2]),
                         jnp.uint32(chunk[3]))
            else:
                n_chunk = len(chunk)
            runs.extend(_finish_chunk(*_count_chunk(
                chunk, k, mode, None)))
            nbases += n_chunk
            if progress:
                progress(nbases)
        return merge_runs(runs)
    t_fin0 = _time.perf_counter()
    try:
        out = acc.finalize()
    except AccCapacity:  # the final merge itself outgrew the budget
        out = merge_runs(acc.salvage())
    t_finalize_s = _time.perf_counter() - t_fin0
    LAST_WIRE_STATS.clear()
    LAST_WIRE_STATS.update(h2d_bytes=acc.wire_h2d_bytes,
                           d2h_bytes=acc.wire_d2h_bytes,
                           bases=nbases,
                           scan_stall_s=round(scan_stall_s, 4),
                           reader_busy_s=reader_stats.get(
                               "reader_busy_s", 0.0),
                           t_finalize_s=round(t_finalize_s, 4),
                           **{kk: (round(v, 4)
                                   if isinstance(v, float) else v)
                              for kk, v in acc.sync.items()})
    return out


def _use_sharded(count_suffix) -> bool:
    """Whether counting should run the multi-chip SPMD path.

    Auto-on for real multi-device backends (the product analog of the
    reference's external count-shards-then-union-sum,
    merylCommandBuilder.C:313-315); MERYL_TPU_SHARDED=1/0 forces it on
    or off (tests use 1 on the virtual CPU mesh).  count-suffix
    filtering is not fused into the SPMD step and falls back."""
    if count_suffix is not None:
        return False
    env = _os.environ.get("MERYL_TPU_SHARDED", "auto")
    if env == "0":
        return False
    if env == "1":
        return True
    import jax
    return jax.device_count() > 1 and jax.default_backend() != "cpu"


def _feed_sharded(paths, k: int, mode: str = "canonical",
                  hpc: bool = False,
                  chunk_len: int | None = None, progress=None,
                  segment=None, mesh=None, **shard_kw):
    """Feed the whole input through a ShardedCounter (n_devices chunker
    chunks per SPMD step — each chunk is a self-contained window with
    its own k-1 halo, so consecutive chunks can go to different
    devices; short final groups are padded with separator-filled
    shards).  Returns the counter, ready to finalize."""
    import jax
    from jax.sharding import Mesh
    from .io.sequence import SEP
    from .parallel.shard_count import ShardedCounter

    chunk_len = chunk_len or shard_default_chunk()
    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), ("d",))
    n = mesh.devices.size
    sc = ShardedCounter(mesh, k, chunk_len=chunk_len, mode=mode, **shard_kw)
    group = []
    nbases = 0
    for chunk in SequenceChunker(paths, k, chunk_len, hpc=hpc,
                                 segment=segment):
        group.append(chunk)
        nbases += len(chunk)
        if len(group) == n:
            sc.add_codes(np.concatenate(group))
            group = []
            if progress:
                progress(nbases)
    if group:
        pad = np.full(chunk_len, SEP, np.uint8)
        group.extend([pad] * (n - len(group)))
        sc.add_codes(np.concatenate(group))
        if progress:
            progress(nbases)
    return sc


def count_to_arrays_sharded(paths, k: int, mode: str = "canonical",
                            hpc: bool = False,
                            chunk_len: int | None = None, progress=None,
                            segment=None, mesh=None, **shard_kw):
    """Multi-chip counting to in-memory arrays (see _feed_sharded)."""
    return _feed_sharded(paths, k, mode=mode, hpc=hpc,
                         chunk_len=chunk_len, progress=progress,
                         segment=segment, mesh=mesh,
                         **shard_kw).finalize()


def count_to_arrays(paths, k: int, mode: str = "canonical", hpc: bool = False,
                    chunk_len: int | None = None, progress=None,
                    count_suffix: str | None = None, segment=None):
    """Count kmers in sequence files.  Returns sorted (hi, lo, counts)."""
    if not (1 <= k <= km.K_MAX):
        raise ValueError(f"k must be in [1, {km.K_MAX}], got {k}")
    user_chunk = chunk_len
    chunk_len = chunk_len or default_chunk()
    if _use_sharded(count_suffix):
        # the sharded path has its own (smaller) default chunk — pass
        # the USER's choice through, not the single-chip default
        return count_to_arrays_sharded(paths, k, mode=mode, hpc=hpc,
                                       chunk_len=user_chunk,
                                       progress=progress, segment=segment)
    exp_uniques = _use_device_acc(count_suffix, paths, k, chunk_len)
    if exp_uniques:
        return count_to_arrays_device_acc(
            paths, k, mode=mode, hpc=hpc, chunk_len=chunk_len,
            expected_uniques=exp_uniques, progress=progress,
            segment=segment)
    suffix = None
    if count_suffix:
        if len(count_suffix) > k:
            raise ValueError("count-suffix longer than k")
        suffix = (km.string_to_kmer(count_suffix), len(count_suffix))
    runs = []
    nbases = 0
    pending = None  # 1-deep pipeline: device computes chunk i+1 while
    #                 the host compacts chunk i (the reference's
    #                 loader/worker/writer overlap, sweatShop-style)
    for chunk in SequenceChunker(paths, k, chunk_len, hpc=hpc,
                                 segment=segment):
        result = _count_chunk(chunk, k, mode, suffix)  # async dispatch
        if pending is not None:
            runs.extend(_finish_chunk(*pending))
        pending = result
        nbases += len(chunk)
        if progress:
            progress(nbases)
    if pending is not None:
        runs.extend(_finish_chunk(*pending))
    return merge_runs(runs)


def _use_multihost(count_suffix, segment) -> bool:
    """Whether counting should run the multi-process (multi-host)
    distributed path: either the MERYL_TPU_COORD launcher contract is
    set, or the caller already initialized a >1-process jax.distributed
    job.  count-suffix / explicit segment= fall back to local paths."""
    if count_suffix is not None or segment is not None:
        return False
    from .parallel import multihost as mh
    if mh.env_requested():
        return int(_os.environ.get("MERYL_TPU_NPROCS", "1")) > 1
    import jax
    return jax.process_count() > 1


def count_to_db(paths, out_path: str, k: int, mode: str = "canonical",
                hpc: bool = False, chunk_len: int | None = None,
                count_suffix: str | None = None, segment=None,
                memory_gb: float | None = None,
                progress=None) -> MerylDB:
    """Count to a DB.  memory= (memory_gb) is a real bound: when the
    plan says the merged unique set may exceed it, counting routes
    through an out-of-core path — batched partial DBs single-stream,
    disk-backed accumulator spills sharded (the reference sizes batches
    to its memory allowance the same way, merylOp-count.C:355-358)."""
    if _use_multihost(count_suffix, segment):
        from .parallel import multihost as mh
        if mh.env_requested():
            mh.init_from_env()
        return mh.count_to_db_multihost(paths, out_path, k, mode=mode,
                                        hpc=hpc, chunk_len=chunk_len,
                                        progress=progress)
    if memory_gb is not None and count_suffix is None:
        plan = configure_counting(paths, k, memory_gb, chunk_len)
        if plan["batches"] > 1:
            if _use_sharded(count_suffix):
                # sharded out-of-core: accumulator spills go to DISK,
                # finalize loads one owner device's runs at a time, and
                # the DB is written bucket-by-bucket as owner ranges
                # stream out — host peak is ~1/n_dev of the merged set,
                # never all of it (the sharded analog of the batched
                # path)
                import shutil
                from .db import stream_sorted_parts
                spill_dir = out_path + ".spills"
                sc = _feed_sharded(
                    paths, k, mode=mode, hpc=hpc,
                    chunk_len=plan["chunk_len"], progress=progress,
                    segment=segment, spill_dir=spill_dir)
                db = stream_sorted_parts(
                    out_path, k,
                    ((hi, lo, c)  # merge_runs clamps to u32 kmvalu
                     for _, hi, lo, c in sc.iter_finalized_parts()),
                    mode=mode, hpc=hpc)
                shutil.rmtree(spill_dir, ignore_errors=True)
                return db
            return count_to_db_batched(
                paths, out_path, k, mode=mode, hpc=hpc,
                chunk_len=plan["chunk_len"], memory_gb=memory_gb,
                segment=segment, progress=progress)
        chunk_len = plan["chunk_len"]
    hi, lo, counts = count_to_arrays(paths, k, mode=mode, hpc=hpc,
                                     chunk_len=chunk_len,
                                     count_suffix=count_suffix,
                                     segment=segment, progress=progress)
    return MerylDB.write(out_path, k, hi, lo, counts, mode=mode, hpc=hpc)


# Device-memory model of the chunk pipeline (bytes per base), derived
# from the program structure: extraction
# materializes P uint32 planes, lax.sort double-buffers them, and the
# run-length stage carries ~3 int32-sized temporaries (counts, iota,
# cummin).  The reference's analog minimizes prefix-width memory the
# same way, analytically (merylOp-count.C:173-295).
def device_bytes_per_base(k: int) -> int:
    P = km.num_planes(k)
    return 4 * P * 3 + 12


def configure_counting(paths, k: int, memory_gb: float | None = None,
                       chunk_len: int | None = None,
                       hbm_gb: float | None = None,
                       n_devices: int | None = None) -> dict:
    """Counting plan: expected kmers, device chunk size, batch count.

    Mirrors the reference's configuration pass (-C dry run;
    /root/reference/src/meryl/merylOp-count.C:299-462): expected kmers
    are guessed from file sizes x1 (plain) / x3 (gz) / x3.5 (bz2) /
    x4 (xz); the device chunk is sized to the HBM budget via the
    bytes-per-base model; and the batch count bounds peak host memory
    for the merged unique set (the out-of-core dump trigger,
    merylOp-count.C:355-358)."""
    import os
    if isinstance(paths, str):
        paths = [paths]
    exp = 0
    for p in paths:
        sz = os.path.getsize(p)
        with open(p, "rb") as f:
            magic = f.read(6)
        if magic[:2] == b"\x1f\x8b":
            exp += sz * 3
        elif magic[:3] == b"BZh":
            exp += int(sz * 3.5)
        elif magic[:6] == b"\xfd7zXZ\x00":
            exp += sz * 4
        else:
            exp += sz

    # device plan: largest power-of-two chunk whose pipeline fits the
    # device working budget (half of it: XLA needs headroom for the
    # doubled sort programs and the 1-deep pipeline overlap)
    if hbm_gb is not None:
        hbm = hbm_gb
    else:
        from .budget import budget_bytes
        hbm = budget_bytes("hbm") / 1e9
    dev_bpb = device_bytes_per_base(k)
    fit = int(hbm * 1e9 * 0.5 / dev_bpb)
    max_chunk = 1 << max(16, fit.bit_length() - 1)
    if chunk_len is None:
        chunk_len = min(default_chunk(), max_chunk)
    else:
        chunk_len = min(chunk_len, max_chunk)

    bytes_per_kmer = 8 + 8 + 4  # hi, lo, count on host
    if memory_gb is None:
        # grid-aware default, like the reference's getMaxMemoryAllowed
        # (documentation/source/reference.rst:117-120)
        from .resources import max_memory_gb
        memory_gb = max_memory_gb()
    mem_budget = memory_gb * 1e9
    n_batches = max(1, int(np.ceil(exp * bytes_per_kmer / mem_budget)))
    import jax
    n_dev = n_devices if n_devices is not None else jax.device_count()
    return {
        "k": k,
        "expected_kmers": int(exp),
        "chunk_len": int(chunk_len),
        "device_bytes_per_base": dev_bpb,
        "device_chunk_hbm_bytes": int(chunk_len) * dev_bpb,
        "hbm_gb": hbm,
        "devices": int(n_dev),
        "sharded": bool(n_dev > 1),
        "host_bytes_per_kmer": bytes_per_kmer,
        "memory_gb": memory_gb,
        "host_peak_bytes": int(min(exp, np.ceil(exp / n_batches)) *
                               bytes_per_kmer),
        "batches": n_batches,
        "batch_bases": int(np.ceil(exp / n_batches)),
    }


def count_to_db_batched(paths, out_path: str, k: int, *,
                        mode: str = "canonical", hpc: bool = False,
                        chunk_len: int | None = None,
                        batch_bases: int | None = None,
                        memory_gb: float | None = None,
                        segment=None,
                        resume: bool = True, progress=None) -> MerylDB:
    """Out-of-core, restartable counting.

    The input stream is split into batches of ~batch_bases; each batch
    is counted and written as a partial DB `<out>.batch<i>` with a
    manifest recording completion — the reference's finishBatch/finish
    pattern (/root/reference/src/meryl/merylOp-countThreads.C:311-380)
    plus idempotent-restart capability (SURVEY.md §5).  Completed
    batches are skipped on resume; the final union-sum merge produces
    the output DB and removes the partials.
    """
    import json
    import os
    import shutil

    chunk_len = chunk_len or default_chunk()
    plan = configure_counting(paths, k, memory_gb, chunk_len)
    if batch_bases is None:
        batch_bases = plan["batch_bases"]
    manifest_path = out_path + ".manifest.json"
    # chunk_len and segment are part of the resume identity: batch
    # boundaries are counted in chunks, so a different chunk size (or
    # input segment) renames which bases "batch i" covers — resuming
    # across that silently double/never-counts ranges
    manifest = {"k": k, "mode": mode, "hpc": hpc,
                "batch_bases": batch_bases, "chunk_len": chunk_len,
                "segment": list(segment) if segment else None,
                "done": []}
    if resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            old = json.load(f)
        if all(old.get(key) == manifest[key]
               for key in ("k", "mode", "hpc", "batch_bases",
                           "chunk_len", "segment")):
            manifest["done"] = old.get("done", [])

    def save_manifest():
        with open(manifest_path, "w") as f:
            json.dump(manifest, f)

    # deterministic: batch i is identified by chunk index in the
    # resume manifest, so the chunk stream must be bit-reproducible
    chunker = SequenceChunker(paths, k, chunk_len, hpc=hpc,
                              segment=segment, deterministic=True)
    chunks_per_batch = max(1, int(np.ceil(batch_bases / chunk_len)))

    # per-BATCH device accumulator: a batch is sized to fit by
    # construction, so its dedup can stay on device (no host merge at
    # all; the flush downloads only the batch's packed uniques).  The
    # gate mirrors _use_device_acc but estimates uniques for ONE
    # batch; AccCapacity mid-batch salvages exactly and that batch
    # finishes on the host path (the next batch tries again).
    acc_exp = 0
    if _os.environ.get("MERYL_TPU_DEVICE_ACC", "auto") != "0":
        import jax
        env_acc = _os.environ.get("MERYL_TPU_DEVICE_ACC", "auto")
        try:
            single = (jax.device_count() == 1
                      and jax.default_backend() != "cpu")
        except Exception:
            single = False
        exp_b = min(batch_bases, 4 ** k if k < 32 else 1 << 63)
        from .budget import budget_bytes
        cap = budget_bytes("acc")
        acc_bytes = (km.num_planes(k) + 1) * 4 * 3
        if env_acc == "1" or (single
                              and exp_b * 0.35 * acc_bytes <= cap):
            acc_exp = max(1, exp_b)

    batch_idx = 0
    runs = []
    acc = None
    nchunks = 0
    nbases = 0
    batch_paths = []

    def flush_batch(idx):
        nonlocal acc
        bpath = f"{out_path}.batch{idx}"
        if idx in manifest["done"]:
            acc = None
            return  # already counted in a previous run
        parts = list(runs)
        if acc is not None:
            try:
                parts.append(acc.finalize())
            except AccCapacity:  # final merge outgrew the budget
                parts.extend(acc.salvage())
            acc = None
        if len(parts) == 1:
            hi, lo, counts = parts[0]
        else:
            hi, lo, counts = merge_runs(parts)
        MerylDB.write(bpath, k, hi, lo, counts, mode=mode, hpc=hpc)
        manifest["done"].append(idx)
        save_manifest()

    for chunk in chunker:
        batch_idx_cur = nchunks // chunks_per_batch
        nchunks += 1
        nbases += len(chunk)
        if batch_idx_cur in manifest["done"]:
            continue  # resume: skip chunks of completed batches
        if batch_idx_cur != batch_idx and (runs or acc is not None):
            flush_batch(batch_idx)
            runs = []
        batch_idx = batch_idx_cur
        if acc_exp:
            if acc is None and not runs:
                acc = DeviceAccCounter(k, mode, chunk_len, acc_exp)
            if acc is not None:
                try:
                    acc.add_codes(chunk)
                except AccCapacity:
                    # salvage is exact and includes everything staged;
                    # the rest of THIS batch runs on the host path
                    runs.extend(acc.salvage())
                    acc = None
                if progress:
                    progress(nbases)
                continue
        runs.extend(_finish_chunk(*_count_chunk(
            chunk, k, mode, None)))
        if progress:
            progress(nbases)
    if nchunks == 0:  # empty input
        z = np.zeros(0, np.uint64)
        if os.path.exists(manifest_path):
            os.remove(manifest_path)
        return MerylDB.write(out_path, k, z, z.copy(),
                             np.zeros(0, np.uint32), mode=mode, hpc=hpc)
    n_batches = (nchunks + chunks_per_batch - 1) // chunks_per_batch
    if runs or acc is not None or batch_idx not in manifest["done"]:
        flush_batch(batch_idx)
    batch_paths = [f"{out_path}.batch{i}" for i in range(n_batches)]

    # final merge: union-sum over the batch partials
    if len(batch_paths) == 1 and os.path.exists(batch_paths[0]):
        if os.path.exists(out_path):
            shutil.rmtree(out_path)
        os.rename(batch_paths[0], out_path)
        db = MerylDB.open(out_path)
    else:
        from .optree import DBInput, OpNode, execute_root
        node = OpNode(op="union-sum",
                      inputs=[DBInput(p) for p in batch_paths
                              if os.path.exists(p)],
                      output_path=out_path)
        db = execute_root(node, k)
        for p in batch_paths:
            shutil.rmtree(p, ignore_errors=True)
    if os.path.exists(manifest_path):
        os.remove(manifest_path)
    return db
