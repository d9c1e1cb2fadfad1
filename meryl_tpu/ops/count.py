"""Device-side sort + run-length count of extracted kmers.

Replaces the reference's per-bucket spin-locked insert + std::sort + RLE
(/root/reference/src/meryl/merylCountArray.C:323-365) with sort-centric
dataflow (no locks, no data-dependent shapes).

The hot path is one multiword sort, neighbor-compare
run starts, and a reversed cummin to find each run's end — run length
is a subtraction.  No gathers, no scatters.  The unique entries stay at
their run-start positions (sparse); the host slices them out with one
boolean take while the device works on the next chunk.

Invalid entries are forced to the all-ones sentinel key, which sorts to
the tail.  A valid poly-G kmer can collide with the sentinel when 2k is
a multiple of 32 (k = 16/32/48/64); the collision is corrected by
subtracting the pre-computed invalid count from the sentinel run.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

U32 = jnp.uint32
SENT = U32(0xFFFFFFFF)


def _sort_planes(planes, payloads=()):
    """Sort multiword keys ascending (plus optional payloads)."""
    P = len(planes)
    keys = [planes[p] for p in range(P - 1, -1, -1)]  # MSB plane first
    ops = lax.sort(tuple(keys) + tuple(payloads), num_keys=P)
    sorted_planes = [ops[P - 1 - p] for p in range(P)]  # back to LSB-first
    return sorted_planes, list(ops[P:])


def _run_starts(planes):
    """Boolean mask of run starts in sorted order."""
    from .multiword import run_starts
    return run_starts(planes)


def _is_sentinel(planes):
    m = None
    for p in planes:
        e = p == SENT
        m = e if m is None else (m & e)
    return m


def _iota(L):
    return lax.broadcasted_iota(jnp.int32, (L, 1), 0).reshape(L)


def _run_lengths_at_starts(start):
    """Run length at each run-start position (garbage elsewhere):
    next-start position (reversed cummin) minus own position."""
    L = start.shape[0]
    idx = _iota(L)
    sp = jnp.where(start, idx, jnp.int32(L))
    suffix_min = lax.cummin(sp[::-1])[::-1]  # smallest start pos >= i
    nxt = jnp.concatenate([suffix_min[1:], jnp.full((1,), L, jnp.int32)])
    return nxt - idx


@jax.jit
def sort_count(planes, validb):
    """Sort kmers and run-length count duplicates.

    planes: list of P uint32 arrays (LSB plane first); validb: bool mask.
    Returns (sorted_planes, counts, start_mask, n_unique): entries where
    start_mask is True are the unique valid kmers in ascending ACTG
    order with their total counts (counts > 0 guaranteed)."""
    n_invalid = jnp.sum((~validb).astype(jnp.int32))
    masked = [jnp.where(validb, p, SENT) for p in planes]
    splanes, _ = _sort_planes(masked)
    start = _run_starts(splanes)
    counts = _run_lengths_at_starts(start)
    counts = counts - jnp.where(_is_sentinel(splanes), n_invalid, 0)
    start = start & (counts > 0)
    counts = jnp.where(start, counts, 0).astype(U32)
    n_unique = jnp.sum(start.astype(jnp.int32))
    return splanes, counts, start, n_unique


@functools.partial(jax.jit, static_argnames=("rowlen",))
def sort_starts(planes, validb, rowlen: int | None = None):
    """Minimal device program for the host-RLE counting path: sort and
    mark run starts only.  Run lengths are differences of start
    positions, which the host computes from the downloaded start mask
    (np.diff over flatnonzero) while the device works on the next
    chunk — this removes the reversed-cummin scan (the second most
    expensive op after the sort) from the hot program and shrinks the
    device->host transfer by the counts array.

    rowlen: when set (must divide L), the chunk is sorted as L/rowlen
    INDEPENDENT rows (one long sort row is the slow shape), and
    duplicates across rows are union-summed
    by the host merge cascade anyway.  Run starts are forced at row
    boundaries so no run crosses a row.

    Returns (sorted_planes, start_mask, n_invalid) — all flat, with
    n_invalid an int32 scalar for rowlen=None or an (L/rowlen,) vector
    of per-row invalid counts.  Invalid entries sort into each row's
    trailing sentinel run; the host subtracts n_invalid from it (the
    sentinel-collision rule of sort_count)."""
    if rowlen is None:
        n_invalid = jnp.sum((~validb).astype(jnp.int32))
        masked = [jnp.where(validb, p, SENT) for p in planes]
        splanes, _ = _sort_planes(masked)
        start = _run_starts(splanes)
        return splanes, start, n_invalid

    L = planes[0].shape[0]
    assert L % rowlen == 0, (L, rowlen)
    rows = L // rowlen
    n_invalid = jnp.sum((~validb).reshape(rows, rowlen).astype(jnp.int32),
                        axis=1)
    masked = [jnp.where(validb, p, SENT).reshape(rows, rowlen)
              for p in planes]
    P = len(masked)
    keys = tuple(masked[p] for p in range(P - 1, -1, -1))  # MSB first
    srows = lax.sort(keys, num_keys=P, dimension=-1)
    splanes = [srows[P - 1 - p] for p in range(P)]  # back to LSB-first
    neq = None
    for p in splanes:
        d = p[:, 1:] != p[:, :-1]
        neq = d if neq is None else (neq | d)
    first = jnp.ones((rows, 1), bool)
    start = jnp.concatenate([first, neq], axis=1)
    return ([p.reshape(L) for p in splanes], start.reshape(L), n_invalid)


def host_rle_finish(splanes_np, start_np, n_invalid, rowlen=None):
    """Host side of sort_starts: unique planes + counts from the start
    mask (numpy).  n_invalid: int scalar (rowlen=None) or per-row
    vector; with rows, each row's last run is its sentinel run whenever
    that row saw invalid entries (the sentinel sorts to the row tail),
    so the per-row subtraction lands there.

    Returns (planes, counts, start_idx); with rowlen set the output is
    sorted per ROW, not globally — callers must split at row
    boundaries (start_idx // rowlen) before treating pieces as sorted
    runs."""
    import numpy as np
    idx = np.flatnonzero(start_np)
    L = len(start_np)
    ends = np.append(idx[1:], L)
    counts = (ends - idx).astype(np.int64)
    if rowlen is None:
        n_invalid = int(n_invalid)
        if n_invalid and len(counts):
            counts[-1] -= n_invalid
            if counts[-1] <= 0:
                idx = idx[:-1]
                counts = counts[:-1]
    else:
        inv = np.asarray(n_invalid, np.int64)
        rows = L // rowlen
        # index (into the runs) of the last run of each row: runs are
        # ordered by position and every row starts a run at its col 0
        last = np.searchsorted(idx, np.arange(1, rows + 1) * rowlen) - 1
        sel = inv > 0
        if sel.any():
            counts[last[sel]] -= inv[sel]
            keep = counts > 0
            idx = idx[keep]
            counts = counts[keep]
    planes = [p[idx] for p in splanes_np]
    return planes, counts.astype(np.uint64), idx


def _compact_by_flag(flag, payloads):
    """Stable-sort payloads so entries with flag=True come first, in
    their original order.  (A 1-key binary sort: radix fast path.)"""
    key = jnp.where(flag, U32(0), U32(1))
    ops = lax.sort((key,) + tuple(payloads), num_keys=1, is_stable=True)
    return list(ops[1:])


@jax.jit
def sort_count_compacted(planes, validb):
    """sort_count variant that compacts unique entries to the front on
    device (via flag-compaction sorts carrying the planes as payloads).
    Slower than sort_count + host compaction, but self-contained — used
    by the SPMD shard step where results feed an all-to-all.

    Returns (unique_planes, counts, n_unique); entries past n_unique
    hold the sentinel kmer with count 0."""
    L = planes[0].shape[0]
    n_invalid = jnp.sum((~validb).astype(jnp.int32))
    masked = [jnp.where(validb, p, SENT) for p in planes]
    splanes, _ = _sort_planes(masked)
    start = _run_starts(splanes)
    end = jnp.concatenate([start[1:], jnp.ones((1,), bool)])
    idx = _iota(L).astype(U32)
    cs = _compact_by_flag(start, (idx,) + tuple(splanes))
    ce = _compact_by_flag(end, (idx,))
    spos, cplanes = cs[0], cs[1:]
    counts = (ce[0] - spos + U32(1)).astype(jnp.int32)
    n_runs = jnp.sum(start.astype(jnp.int32))
    in_range = _iota(L) < n_runs
    is_sent = _is_sentinel(cplanes) & in_range
    counts = counts - jnp.where(is_sent, n_invalid, 0)
    keep = in_range & (counts > 0)
    counts = jnp.where(keep, counts, 0).astype(U32)
    out_planes = [jnp.where(keep, p, SENT) for p in cplanes]
    n_unique = jnp.sum(keep.astype(jnp.int32))
    return out_planes, counts, n_unique


@jax.jit
def merge_counted(planes_a, counts_a, planes_b, counts_b):
    """Merge two unique-kmer/count arrays (all-ones sentinel padding
    with zero counts) into one sorted unique compacted array of size
    len(a)+len(b).  Returns (unique_planes, counts, n_unique)."""
    return merge_many([planes_a, planes_b], [counts_a, counts_b])


@jax.jit
def merge_many(planes_list, counts_list):
    """Merge any number of sorted unique sentinel-padded runs into one
    compacted run: concat + sort, then per-run count sums via prefix-sum
    differences carried through the compaction sorts."""
    planes = [jnp.concatenate(ps) for ps in zip(*planes_list)]
    w = jnp.concatenate(counts_list)
    L = w.shape[0]
    splanes, payl = _sort_planes(planes, (w,))
    w = payl[0]
    start = _run_starts(splanes)
    end = jnp.concatenate([start[1:], jnp.ones((1,), bool)])
    pre_inc = jnp.cumsum(w)
    pre_exc = pre_inc - w
    cs = _compact_by_flag(start, (pre_exc,) + tuple(splanes))
    ce = _compact_by_flag(end, (pre_inc,))
    sum_before, cplanes = cs[0], cs[1:]
    counts = ce[0] - sum_before
    n_runs = jnp.sum(start.astype(jnp.int32))
    keep = (_iota(L) < n_runs) & (counts > 0)
    counts = jnp.where(keep, counts, U32(0))
    out_planes = [jnp.where(keep, p, SENT) for p in cplanes]
    n_unique = jnp.sum(keep.astype(jnp.int32))
    return out_planes, counts, n_unique


@functools.partial(jax.jit, static_argnames=("num_values", "block"))
def value_histogram(counts, num_values: int, block: int = 1 << 15):
    """Histogram of counts: h[v] = #entries with count v (counts >=
    num_values accumulate in the last bin; h[0] forced 0, so zero-count
    padding is ignored).

    Blocked compare-and-reduce (fuses into elementwise work) rather
    than a segment_sum scatter."""
    L = counts.shape[0]
    v = jnp.minimum(counts, U32(num_values - 1))
    pad = (-L) % block
    if pad:
        v = jnp.concatenate([v, jnp.zeros((pad,), U32)])
    vb = v.reshape(-1, block)
    bins = lax.broadcasted_iota(jnp.int32, (num_values, 1), 0).reshape(
        1, num_values)

    def body(carry, row):
        eq = (row[:, None].astype(jnp.int32) == bins)
        return carry + jnp.sum(eq, axis=0), None

    init = jnp.zeros((num_values,), jnp.int32)
    hist, _ = lax.scan(body, init, vb)
    return hist.at[0].set(0)
