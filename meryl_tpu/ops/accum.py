"""Single-device accumulator counting: the whole dedup/merge stage
stays on the device; the host sees only the final unique set.

Why: the host finish merge processes ~1 entry per base (rows dedup
almost nothing locally — duplicate kmers of a high-coverage input are
spread across the whole stream), which caps end-to-end counting at the
host's merge rate (tens of Mbases/s) no matter how fast the device
pipeline is; and every chunk's sorted output must cross the
device->host link.  The reference has the same structure-forced merge
on the CPU (merylOp-countThreads.C:384-474).  Keeping a device-resident
sorted-unique accumulator removes both: per chunk the device routes raw
windows to key-range bucket rows, and every M chunks one row-batched
merge sort folds them into the accumulator.  Downloads happen once, at
finalize.

All stages are row-batched sorts / cumulative ops:

  route_chunk:  extract -> bucket row id (closed-form equal-mass map)
                -> 1-key row sort -> cummax ranks -> searchsorted
                histogram -> one compaction sort -> (B, W) cells
  merge_cells:  [acc row ++ staged cell rows] stable row sort ->
                run lengths by reversed cummin -> counts = run length
                - 1 + first entry's count (the accumulator entry sorts
                first in its run; raw windows count 1 each) -> flag
                compaction back into the accumulator rows

The all-ones kmer (a real key when 2k % 32 == 0) is EXCLUDED on device
and counted by a scalar — the padding sentinel therefore never aliases
a real key anywhere in the accumulator.  Invalid windows route past the
last bucket and are dropped.  Cell overflow (adversarially skewed
composition) is reported per chunk so the driver can recount that chunk
on the host path — never silently dropped.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from . import extract as ext

U32 = jnp.uint32
SENT = U32(0xFFFFFFFF)


def plan_route(chunk_len: int, k: int, expected_uniques: int) -> dict:
    """Static routing/accumulator geometry for one chunk size.

    Routing-row length L0 = 2^18: every halving grows the RELATIVE
    cell slack (total pad = R0*B*(3 sqrt(mean)+4) shrinks ~sqrt(2) per
    doubling), while much longer rows leave too few rows to batch the
    sort.  Cell slack is the tight 3-sigma tail
    (overflow recounts exactly on the host path — rare by
    construction); merges amortize over M=8 chunks; the accumulator
    row capacity starts from a DISCOUNTED expectation (the file-size
    estimate overshoots FASTQ ~4x) and regrows on demand — oversized
    rows make every merge re-sort padding."""
    L0 = min(1 << 18, chunk_len)
    if os.environ.get("MERYL_TPU_ACC_L0"):  # sweep knob
        L0 = min(int(os.environ["MERYL_TPU_ACC_L0"]), chunk_len)
    R0 = max(1, chunk_len // L0)
    M = 8
    vol = max(int(expected_uniques), M * chunk_len)
    # B cap 2^10 (the kernel cost depends only on (L0, B); the vol
    # term only shrinks B for small runs)
    B = max(8, min(1 << 10, vol >> 14))
    B = 1 << (B - 1).bit_length()
    if os.environ.get("MERYL_TPU_ACC_B"):  # sweep knob: clamp to a
        # sane pow2 so a typo degrades, never crashes downstream
        B = int(os.environ["MERYL_TPU_ACC_B"])
        B = 1 << max(3, min(12, (max(B, 1) - 1).bit_length()))
    mean = max(1.0, L0 / B)
    c = max(8, int(mean + 3.0 * mean ** 0.5 + 4))
    # prefix resolution: >= 64 prefixes per row where the equal-mass
    # map is steepest (slope 2 at x=0), else quantization alone
    # unbalances rows 2x and cells overflow chronically
    # bits <= 16 is what the exact integer row map requires; a
    # sweep-knob B past 2^10 therefore degrades to coarser prefix
    # resolution (unbalanced rows), never to a wrong map.
    bits = min(2 * k, 16, (B - 1).bit_length() + 6)
    La0 = max(2048, _eighth_round(
        int(expected_uniques * 0.35 // B) + 1))
    return {"B": B, "R0": R0, "L0": L0, "c": c, "bits": bits,
            "M": M, "La0": La0}


def _eighth_round(n: int) -> int:
    q = max(64, 1 << max(0, int(n).bit_length() - 4))
    return ((n + q - 1) // q) * q


def row_from_prefix_int(pref, bits: int, B: int, canonical: bool,
                        xp=jnp):
    """Monotone prefix -> bucket row map with near-equal expected mass.

    Canonical kmers are min(f, rc) of two ~uniform draws, so their
    density over prefix space x is 2(1-x) with CDF F(x) = 2x - x^2;
    row = floor(B * F(x)) gives near-equal expected mass per row
    (closed form — no per-boundary compares, no gathers).  Computed in
    EXACT integer arithmetic as

        num32 = (2^(2*bits) - (2^bits - p)^2) << (32 - 2*bits)

    (num32 < 2^32 always, since p < 2^bits) and then row =
    floor(num32 * B / 2^32) via a u32 high-multiply split.  No floats
    anywhere: the map is monotone by construction (the plane-keyed
    routing sort in _route_core relies on that), and a HOST
    recomputation (xp=np) is bit-identical to the device's — the SPMD
    path routes its overflow-hatch extras to owner devices by
    recomputing rows host-side.
    Requires bits <= 16.  Works for any B (owner meshes need not be
    powers of two); monotone non-decreasing in pref by construction.

    xp: jnp (device) or np (host); pref must be uint32 in [0, 2^bits).
    """
    assert bits <= 16, bits
    u = (lambda v: xp.uint32(v)) if xp is jnp else \
        (lambda v: np.uint32(v))
    p = pref.astype(xp.uint32)
    if B == 1:
        return xp.zeros(p.shape, xp.int32)
    if canonical:
        d = u((1 << bits)) - p
        dd = d * d  # wraps to 0 exactly at p == 0 when bits == 16
        if bits == 16:
            num32 = u(0) - dd          # 2^32 - d^2 (mod 2^32, exact)
        else:
            num32 = (u(1 << (2 * bits)) - dd) << u(32 - 2 * bits)
    else:
        num32 = p << u(32 - bits)
    if B & (B - 1) == 0:  # power of two: one shift
        row = num32 >> u(32 - (B - 1).bit_length() if B > 1 else 32)
        return xp.minimum(row, u(B - 1)).astype(xp.int32)
    # general B: floor(num32 * B / 2^32) without a 64-bit multiply
    hi = num32 >> u(16)
    lo = num32 & u(0xFFFF)
    row = (hi * u(B) + ((lo * u(B)) >> u(16))) >> u(16)
    return xp.minimum(row, u(B - 1)).astype(xp.int32)


def _top_bits(planes, k: int, b: int):
    """Top b bits of each kmer (any shape); b <= 2k."""
    top_bit = 2 * k - 1
    top_plane = top_bit // 32
    used = 2 * k - 32 * top_plane
    if used >= b:
        v = planes[top_plane] >> U32(used - b)
        return (v & U32((1 << b) - 1)).astype(jnp.int32)
    need = b - used
    hi = planes[top_plane] & ((U32(1) << U32(used)) - U32(1))
    lo = planes[top_plane - 1] >> U32(32 - need)
    return ((hi.astype(jnp.int32) << need) | lo.astype(jnp.int32))


# per-routing-row capture capacity for cell-overflow windows: the
# 3-sigma cell slack leaves a thin Poisson tail (~a few windows per
# chunk) that the host counts exactly from this region instead of
# recounting the whole chunk
OVF_CAP = 256


@functools.partial(jax.jit, static_argnames=("cfg",))
def route_chunk(codes, cfg):
    """codes (chunk_len,) uint8 -> ((B, R0*c) cell planes,
    ovf_planes (R0, OVF_CAP) x P, n_ovf_row (R0,), n_allones).

    Cells hold raw windows grouped by bucket row (unsorted within;
    each window counts 1); sentinel entries pad.  Windows whose cell
    overflowed sort into the capture region (real keys only — invalid
    windows sort past it); a row overflowing OVF_CAP tells the driver
    to recount the whole chunk on the host path."""
    k, P, mode = cfg[:3]
    planes, valid = ext.extract_kmers(codes, k, mode)
    return _route_core(planes, valid, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def route_chunk_packed(packed2, exc, n_real, cfg):
    """route_chunk over the 2-bit packed wire format (4x less
    host->device traffic; see ops/extract.extract_kmers_packed)."""
    k, P, mode = cfg[:3]
    planes, valid = ext.extract_kmers_packed(packed2, exc, n_real, k,
                                             mode)
    return _route_core(planes, valid, cfg)


def _route_core(planes, valid, cfg):
    # cfg: (k, P, mode, B, R0, L0, c, bits)
    k, P, mode, B, R0, L0, c, bits = cfg
    D = B * c

    allones = None
    for p in planes:
        e = p == SENT
        allones = e if allones is None else (allones & e)
    allones = allones & valid
    n_allones = jnp.sum(allones.astype(jnp.int32))
    valid = valid & ~allones

    # sort by the KMER ITSELF (planes as keys, most-significant plane
    # first) instead of by a separate row-key operand: the equal-mass
    # row map is monotone non-decreasing in the kmer prefix, so the
    # plane sort yields the same bucket grouping with one fewer sort
    # operand.  Invalid windows' planes are masked to the
    # sentinel first so they order past every real key (the all-ones
    # real kmer was excluded above); the row vector is recomputed
    # elementwise from the sorted planes.
    planes2 = [jnp.where(valid, p, SENT).reshape(R0, L0)
               for p in planes]
    srt = jax.lax.sort(tuple(planes2[::-1]), num_keys=P, dimension=-1)
    planes1 = list(srt[::-1])
    inval1 = None
    for p in planes1:
        e = p == SENT
        inval1 = e if inval1 is None else (inval1 & e)
    pref1 = _top_bits(planes1, k, bits)
    row1 = row_from_prefix_int(pref1.astype(jnp.uint32), bits, B,
                               mode == "canonical")
    row1 = jnp.where(inval1, jnp.int32(B), row1).astype(U32)

    # rank within bucket segment via cummax; kept = first c per bucket
    seg_start = jnp.concatenate(
        [jnp.ones((R0, 1), bool), row1[:, 1:] != row1[:, :-1]], axis=1)
    iot = jax.lax.broadcasted_iota(jnp.int32, (R0, L0), 1)
    seg_base = jax.lax.cummax(jnp.where(seg_start, iot, -1), axis=1)
    in_range = row1 < U32(B)
    kept_q = ((iot - seg_base) < c) & in_range
    is_ovf = ~kept_q & in_range
    n_ovf_row = jnp.sum(is_ovf.astype(jnp.int32), axis=1)

    # per-(row, bucket) counts: vectorized binary search over sorted
    # row ids (tiny gathers; a one-hot histogram would materialize
    # (R0, L0, B) through device memory)
    tgt = jax.lax.broadcasted_iota(U32, (R0, B + 1), 1)
    lo_b = jnp.zeros((R0, B + 1), jnp.int32)
    hi_b = jnp.full((R0, B + 1), L0, jnp.int32)
    for _ in range(int(L0).bit_length()):
        mid = (lo_b + hi_b) >> 1
        v = jnp.take_along_axis(row1, jnp.minimum(mid, L0 - 1).astype(
            jnp.int32), axis=1)
        # the `active` guard is LOAD-BEARING: the loop runs a fixed
        # iteration count, and the all-less path (a routing row with
        # no invalid windows, boundary target = B) converges one step
        # early to lo == hi == L0 — the next iteration's clamped read
        # then reports "less" again and pushes lo to L0 + 1.  That
        # overcounts the LAST bucket by one, shorts its pad fill, and
        # slides one overflow window into the cells and one sentinel
        # pad into the capture (a phantom kmer).
        active = lo_b < hi_b
        less = v < tgt
        lo_b = jnp.where(active & less, mid + 1, lo_b)
        hi_b = jnp.where(active & ~less, mid, hi_b)
    n_bucket = lo_b[:, 1:] - lo_b[:, :-1]
    pad_rank = jax.lax.broadcasted_iota(jnp.int32, (B, c), 1).reshape(D)
    n_slot = jnp.repeat(n_bucket, c, axis=1)
    kept_p = pad_rank[None, :] >= jnp.minimum(n_slot, c)

    pad_row = jnp.broadcast_to(
        (jax.lax.broadcasted_iota(U32, (B, c), 0)).reshape(D)[None, :],
        (R0, D))
    # non-kept REAL windows key just below the sentinel so they sort
    # into a contiguous capture slice right after the cells; invalid
    # windows (row == B: their planes are garbage across N/breaks)
    # and excess pads sort past it
    OVFK = U32(0xFFFFFFFE)
    key2 = jnp.concatenate(
        [jnp.where(kept_q, row1, jnp.where(is_ovf, OVFK, SENT)),
         jnp.where(kept_p, pad_row, SENT)], axis=1)
    planes_cat = [jnp.concatenate(
        [planes1[p], jnp.full((R0, D), SENT, U32)], axis=1)
        for p in range(P)]
    srt2 = jax.lax.sort((key2,) + tuple(planes_cat), num_keys=1,
                        dimension=-1, is_stable=True)
    cells = [s[:, :D].T.reshape(B, R0 * c) for s in srt2[1:]]
    ovf = tuple(s[:, D:D + OVF_CAP] for s in srt2[1:])
    return tuple(cells), ovf, n_ovf_row, n_allones


@functools.partial(jax.jit, static_argnames=("P", "La_out", "vmax"))
def merge_cells(acc_planes, acc_counts, staged, P: int, La_out: int,
                vmax: int):
    """Fold staged cell groups into the accumulator.

    acc_planes: P x (B, La) sorted unique rows (sentinel padded)
    acc_counts: (B, La) uint32 (0 marks padding)
    staged:     tuple of cell-plane tuples, each P x (B, W), raw
                windows (count 1 each) grouped by bucket row
    -> (new_planes P x (B, La_out), new_counts, n_runs (B,) int32)

    The accumulator segment is concatenated FIRST, so after the stable
    row sort the accumulator's entry (unique per key) leads its run:
    count = run_length - 1 + leading entry's count (raw windows carry
    an implicit 1).  Saturates at vmax (the reference's kmvalu cap)."""
    B = acc_counts.shape[0]
    planes = [jnp.concatenate([acc_planes[p]]
                              + [s[p] for s in staged], axis=1)
              for p in range(P)]
    W = planes[0].shape[1]
    counts = jnp.concatenate(
        [acc_counts, jnp.ones((B, W - acc_counts.shape[1]), U32)],
        axis=1)

    keys = tuple(planes[p] for p in range(P - 1, -1, -1))
    srt = jax.lax.sort(keys + (counts,), num_keys=P, dimension=-1,
                       is_stable=True)
    splanes = [srt[P - 1 - p] for p in range(P)]
    scounts = srt[P]

    neq = None
    for p in splanes:
        d = p[:, 1:] != p[:, :-1]
        neq = d if neq is None else (neq | d)
    start = jnp.concatenate([jnp.ones((B, 1), bool), neq], axis=1)

    # run length at starts: next start position via reversed cummin
    iot = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    sp = jnp.where(start, iot, jnp.int32(W))
    suffix_min = jax.lax.cummin(sp[:, ::-1], axis=1)[:, ::-1]
    nxt = jnp.concatenate(
        [suffix_min[:, 1:], jnp.full((B, 1), W, jnp.int32)], axis=1)
    run_len = (nxt - iot).astype(U32)

    is_sent = None
    for p in splanes:
        e = p == SENT
        is_sent = e if is_sent is None else (is_sent & e)
    # padding entries carry count 0 (acc pads) or 1 (cell pads, which
    # are sentinel-keyed); sentinel runs are dropped entirely — the
    # all-ones kmer was excluded at extraction, so sentinel = padding
    total = run_len - U32(1) + scounts
    total = jnp.where(total < scounts, U32(vmax), total)  # overflow sat
    total = jnp.minimum(total, U32(vmax))
    keep = start & ~is_sent & (scounts > U32(0))

    flag = jnp.where(keep, U32(0), U32(1))
    srt2 = jax.lax.sort(
        (flag,) + tuple(splanes)
        + (jnp.where(keep, total, U32(0)),),
        num_keys=1, dimension=-1, is_stable=True)
    n_runs = jnp.sum(keep.astype(jnp.int32), axis=1)
    # sanitize the tail: entries past a row's n_runs are compaction
    # leftovers whose keys DUPLICATE kept entries — a stale key
    # surviving into the next merge would inflate its run length
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, La_out), 1)
    ok = pos < n_runs[:, None]
    new_planes = tuple(jnp.where(ok, s[:, :La_out], SENT)
                       for s in srt2[1:1 + P])
    new_counts = jnp.where(ok, srt2[1 + P][:, :La_out], U32(0))
    return new_planes, new_counts, n_runs

EXC_ROW_CAP = 64


@functools.partial(jax.jit, static_argnames=("P",))
def pack_for_download(acc_planes, acc_counts, P: int, cbits_min):
    """Wire-pack the accumulator for download (2k <= 64 only).

    Finalize downloads (P + 1) u32 arrays per entry (~12 B/unique,
    plus row padding); on slow device->host links that transfer bounds
    end-to-end counting.  Keys within an accumulator row
    are sorted and dense, so each entry is its predecessor's key plus
    a small gap: pack (gap << cbits | count) into ONE u32 — a 3x wire
    cut.  The gap/count split is PER ROW: the equal-mass routing map
    gives rows equal counts but very different key-range widths (the
    canonical transform warps density several-fold across the space),
    so each row sizes its gap field from its own max in-row gap
    (gbits_row, reported to the host), floored by cbits_min bits for
    the count field (the caller derives cbits_min from coverage).
    Entries that still do not fit (count past the field, gap past a
    count-capped field, a multi-plane gap, or the ambiguous all-ones
    word) are EXCEPTIONS: their full key + count are compacted per
    row into fixed (B, EXC_ROW_CAP) side arrays and re-applied by
    position on the host — exact, like every other hatch in this
    engine.  The caller downloads column 0 of each row dense (the
    cumsum base) and per-row-dense-downloads rows whose exceptions
    overflow EXC_ROW_CAP.

    -> (packed (B, La) u32   0 = empty, SENT = exception, else word,
        gbits_row (B,) i32   per-row gap-field width,
        exc_col (B, EXC) u32 column of each exception (SENT padded),
        exc_planes P x (B, EXC) u32, exc_cnt (B, EXC) u32,
        n_exc_row (B,) int32)
    """
    B, La = acc_counts.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (B, La), 1)
    valid = acc_counts > U32(0)

    prev = [jnp.concatenate([p[:, :1], p[:, :-1]], axis=1)
            for p in acc_planes]
    d0 = acc_planes[0] - prev[0]
    if P == 2:
        borrow = (acc_planes[0] < prev[0]).astype(U32)
        d1 = acc_planes[1] - prev[1] - borrow
        hi_ok = d1 == U32(0)
    else:
        hi_ok = jnp.ones((B, La), bool)
    # per-row gap field: wide enough for the row's own largest
    # single-plane gap, capped to leave cbits_min for counts
    in_row = valid & (col > 0) & hi_ok
    gmax = jnp.max(jnp.where(in_row, d0, U32(0)), axis=1)
    gbits_row = jnp.clip(32 - jax.lax.clz(jnp.maximum(gmax, U32(1)))
                         .astype(jnp.int32), 1, 32 - cbits_min)
    gb = gbits_row[:, None].astype(U32)
    cb = U32(32) - gb
    word = (d0 << cb) | acc_counts
    fit = (in_row
           & (d0 < (U32(1) << gb))
           & (acc_counts < (U32(1) << cb))
           & (word != SENT))
    exc = valid & (col > 0) & ~fit
    packed = jnp.where(fit, word, jnp.where(exc, SENT, U32(0)))

    # per-row exception compaction: 1-key stable sort (row-batched),
    # exceptions keyed by column so
    # they stay in key order at the row front
    key = jnp.where(exc, col.astype(U32), SENT)
    srt = jax.lax.sort(
        (key,) + tuple(acc_planes) + (acc_counts,),
        num_keys=1, dimension=-1, is_stable=True)
    exc_col = srt[0][:, :EXC_ROW_CAP]
    exc_planes = tuple(s[:, :EXC_ROW_CAP] for s in srt[1:1 + P])
    exc_cnt = srt[1 + P][:, :EXC_ROW_CAP]
    n_exc_row = jnp.sum(exc.astype(jnp.int32), axis=1)
    return packed, gbits_row, exc_col, exc_planes, exc_cnt, n_exc_row


@functools.partial(jax.jit, static_argnames=("P", "lmax"))
def pack_for_download_fused(acc_planes, acc_counts, P: int,
                            bases_seen, lmax: int):
    """pack_for_download, with every output flattened into ONE u32
    blob so the host pays a single blocking fetch instead of ~11.  The
    count-field floor
    (cbits_min: coverage mean + 5 sigma) is derived ON DEVICE from
    bases_seen / uniques, so the host neither fetches a unique count
    first nor mints a signature per cbits value.  Layout, raveled u32:

      [ packed[:, :lmax] | gbits_row | n_exc_row | counts[:, 0]
        | planes[p][:, 0] x P | exc_col | exc_cnt | exc_planes x P ]

    The host splits by the statically known shapes (B, lmax,
    EXC_ROW_CAP)."""
    u = jnp.maximum(jnp.sum((acc_counts > U32(0)).astype(jnp.uint32)),
                    jnp.uint32(1))
    mean_c = jnp.maximum(jnp.float32(1.0),
                         bases_seen.astype(jnp.float32)
                         / u.astype(jnp.float32))
    need_c = jnp.ceil(mean_c + 5.0 * jnp.sqrt(mean_c) + 8.0) \
        .astype(jnp.uint32)
    need_bits = jnp.int32(32) - jax.lax.clz(need_c).astype(jnp.int32)
    cbits_min = jnp.clip((need_bits + 1) // 2 * 2, 6, 24)
    packed, gbits_row, exc_col, exc_planes, exc_cnt, n_exc_row = \
        pack_for_download(acc_planes, acc_counts, P, cbits_min)
    parts = ([packed[:, :lmax].ravel(),
              gbits_row.astype(U32), n_exc_row.astype(U32),
              acc_counts[:, 0]]
             + [acc_planes[p][:, 0] for p in range(P)]
             + [exc_col.ravel(), exc_cnt.ravel()]
             + [exc_planes[p].ravel() for p in range(P)])
    return jnp.concatenate(parts)
