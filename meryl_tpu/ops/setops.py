"""Device-side k-mer set/arithmetic operations.

Device replacement for the reference's lazy N-way streaming merge
(/root/reference/src/meryl/merylOp-nextMer.C:418-683): instead of a
per-kmer pull loop cloned 64x under OpenMP, each DB bucket is evaluated
as one batched kernel — concatenate the (sorted, unique) inputs, sort,
and compute every op's value with segment reductions.  Zero value means
"suppress this kmer" exactly as in the reference (merylOp-nextMer.C:643).

Value semantics (merylOp-nextMer.C:478-641):
  union               number of inputs containing the kmer (_actLen)
  union-min/max/sum   min/max/sum of values over inputs that have it
  intersect           value of the FIRST input (only if in all inputs)
  intersect-min/max/sum
  subtract            in input 1: v1 - sum(others) if positive else 0
                      (sequential-clamp semantics reduce to this)
  difference          v1 if the kmer is ONLY in input 1
  symmetric-difference  its value if in exactly one input
  less-than/greater-than/at-least/at-most/equal-to/not-equal-to  T
  increase/decrease/multiply/divide/divide-round/modulo          C
  (arithmetic wraps at 2^32 like the reference: its overflow checks in
  merylOp-nextMer.C:513-533 compare against UINT64_MAX, so a u32-range
  overflow passes them and truncates on assignment to the u32 kmvalu)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

U32 = jnp.uint32
SENT = U32(0xFFFFFFFF)
BIG_ID = jnp.int32(0x7FFFFFFF)

MERGE_OPS = frozenset([
    "union", "union-min", "union-max", "union-sum",
    "intersect", "intersect-min", "intersect-max", "intersect-sum",
    "subtract", "difference", "symmetric-difference", "passthrough",
])
FILTER_OPS = frozenset([
    "less-than", "greater-than", "at-least", "at-most",
    "equal-to", "not-equal-to",
])
MATH_OPS = frozenset([
    "increase", "decrease", "multiply", "divide", "divide-round", "modulo",
])


def _sort_with_payload(planes, payloads):
    P = len(planes)
    keys = [planes[p] for p in range(P - 1, -1, -1)]  # MSB plane first
    ops = jax.lax.sort(tuple(keys) + tuple(payloads),
                       num_keys=P, is_stable=True)
    return [ops[P - 1 - p] for p in range(P)], list(ops[P:])


def _run_starts(planes):
    from .multiword import run_starts
    return run_starts(planes)


def _apply_value_rule(op: str, m: int, act_len, v_first, first_idx,
                      v_min, v_max, v_sum, threshold):
    """Per-unique-kmer output value; 0 = suppress."""
    t = threshold.astype(U32)
    zero = jnp.zeros_like(v_sum)
    if op == "union":
        return act_len.astype(U32)
    if op == "union-min":
        return v_min
    if op == "union-max":
        return v_max
    if op == "union-sum":
        return v_sum
    if op == "passthrough":
        return v_first
    if op.startswith("intersect"):
        allin = act_len == m
        base = {"intersect": v_first, "intersect-min": v_min,
                "intersect-max": v_max, "intersect-sum": v_sum}[op]
        return jnp.where(allin, base, zero)
    if op == "subtract":
        rest = v_sum - v_first
        ok = (first_idx == 0) & (v_first > rest)
        return jnp.where(ok, v_first - rest, zero)
    if op == "difference":
        return jnp.where((act_len == 1) & (first_idx == 0), v_first, zero)
    if op == "symmetric-difference":
        return jnp.where(act_len == 1, v_first, zero)
    # single-input value filters / arithmetic (applied to v_first)
    v = v_first
    if op == "less-than":
        return jnp.where(v < t, v, zero)
    if op == "greater-than":
        return jnp.where(v > t, v, zero)
    if op == "at-least":
        return jnp.where(v >= t, v, zero)
    if op == "at-most":
        return jnp.where(v <= t, v, zero)
    if op == "equal-to":
        return jnp.where(v == t, v, zero)
    if op == "not-equal-to":
        return jnp.where(v != t, v, zero)
    if op == "increase":
        return v + t
    if op == "decrease":
        return jnp.where(v < t, zero, v - t)
    if op == "multiply":
        return v * t
    if op == "divide":
        return jnp.where(t == 0, zero, v // jnp.maximum(t, U32(1)))
    if op == "divide-round":
        td = jnp.maximum(t, U32(1))
        q = v // td
        r = v - q * td
        half = (td >> U32(1)) + (td & U32(1))  # ceil(t/2); round half up
        q = q + jnp.where(r >= half, U32(1), U32(0))
        q = jnp.where(v < td, U32(1), q)
        return jnp.where(t == 0, zero, q)
    if op == "modulo":
        return jnp.where(t == 0, zero, v % jnp.maximum(t, U32(1)))
    raise ValueError(f"unknown operation {op!r}")


@jax.jit
def _merge_sort_stage(planes, values, input_ids):
    """Stable multiword sort with payloads; the program ends at the
    sort (see ops/count.py).

    Accepts flat (L,) arrays or row-batched (R, L) arrays.  Rows are
    sorted INDEPENDENTLY (lax.sort along the last axis) and returned
    flattened: one long sort row is the slow shape, so callers whose
    inputs are already
    sorted split them at shared key boundaries into rows (see
    optree._pack_rows) — every instance of a key lands in exactly one
    row, which makes the flattened result globally ordered."""
    splanes, (val, ids) = _sort_with_payload(planes, (values, input_ids))
    if splanes[0].ndim == 2:
        n = splanes[0].size
        splanes = [p.reshape(n) for p in splanes]
        val, ids = val.reshape(n), ids.reshape(n)
    return splanes, val, ids


def merge_op(planes, values, input_ids, op: str, m: int, threshold):
    """Evaluate one set operation over concatenated input buckets.

    planes:    P uint32 arrays, all inputs concatenated (padding entries
               carry the all-ones sentinel key and value 0); either
               flat (L,) or row-batched (R, L) with rows split at key
               boundaries (no key spans two rows)
    values:    uint32 (0 marks padding)
    input_ids: int32 input index per entry (0-based)
    op, m:     operation name and number of inputs
    threshold: uint32 scalar (threshold or math constant)

    Returns (sorted_planes, out_values, keep_mask): entries where
    keep_mask is True are the surviving kmers, ascending, value > 0.

    Host-orchestrated in two device programs (sort | compute)."""
    rowlen = planes[0].shape[-1] if planes[0].ndim == 2 else None
    splanes, val, ids = _merge_sort_stage(planes, values, input_ids)
    return _merge_compute_stage(splanes, val, ids, op, m, threshold,
                                rowlen)


# ---- multiset (per-instance) evaluation ----
#
# The reference's merge emits one entry per INSTANCE when any input is a
# multiset (/root/reference/src/meryl/merylOp-nextMer.C:296-385): for
# union-family ops it repeatedly picks the single smallest (kmer, value)
# instance (:313-317), so the output preserves every instance sorted by
# (kmer, value) and `union`'s value is _actLen == 1 per instance.  The
# reference's non-union multiset handling is explicitly unfinished
# ("THIS IS WRONG", :287; both passes skip non-multiset inputs,
# :307-309/:355-357, making the documented wildcard path unreachable) —
# for those ops we implement the semantics its comments describe
# (:291-293): instances of multiset inputs are matched across inputs by
# their per-kmer value rank, and a non-multiset input acts as a
# wildcard present at every rank of its kmer with its single value.

MS_SIMPLE_OPS = frozenset([
    "union", "union-min", "union-max", "union-sum", "passthrough",
]) | FILTER_OPS | MATH_OPS
MS_MATCH_OPS = frozenset([
    "intersect", "intersect-min", "intersect-max", "intersect-sum",
    "subtract", "difference", "symmetric-difference",
])


def merge_op_multiset(planes, values, input_ids, op: str, m: int,
                      threshold, ms_mask: tuple):
    """merge_op for multiset inputs: one output entry per instance.

    ms_mask: static tuple of m bools — which inputs are multisets.
    Returns (sorted_planes, out_values, keep_mask); kept entries are
    ascending by kmer (ties by value for union-family ops)."""
    if op in MS_SIMPLE_OPS:
        return _ms_simple_stage(planes, values, input_ids, op, m, threshold)
    if op not in MS_MATCH_OPS:
        raise ValueError(f"operation {op!r} not supported on multisets")
    return _ms_match_stage(planes, values, input_ids, op, m, threshold,
                           tuple(bool(b) for b in ms_mask))


@functools.partial(jax.jit, static_argnames=("op", "m"))
def _ms_simple_stage(planes, values, input_ids, op: str, m: int, threshold):
    """Per-instance ops needing no cross-input matching: sort instances
    by (kmer, value) — the reference's pick order — and apply the value
    rule elementwise (every instance is its own active set of 1)."""
    P = len(planes)
    keys = tuple(planes[p] for p in range(P - 1, -1, -1)) + (values,)
    ops_ = jax.lax.sort(keys + (input_ids,), num_keys=P + 1, is_stable=True)
    splanes = [ops_[P - 1 - p] for p in range(P)]
    val = ops_[P]
    present = val > U32(0)
    ones = jnp.where(present, 1, 0).astype(jnp.int32)
    out = _apply_value_rule(op, m, ones, val, jnp.zeros_like(ones),
                            val, val, val, threshold)
    keep = present & (out > U32(0))
    return splanes, out.astype(U32), keep


@functools.partial(jax.jit, static_argnames=("op", "m", "ms_mask"))
def _ms_match_stage(planes, values, input_ids, op: str, m: int,
                    threshold, ms_mask: tuple):
    from . import segscan

    P = len(planes)
    L = values.shape[0]

    # sort 1: (kmer, input, value) -> per-(kmer, input) instance rank
    # (value IS a key: instances rank by ascending value within input)
    keys1 = tuple(planes[p] for p in range(P - 1, -1, -1)) + (input_ids,)
    ops1 = jax.lax.sort(keys1 + (values,), num_keys=P + 2, is_stable=True)
    s1 = [ops1[P - 1 - p] for p in range(P)]
    ids1, val1 = ops1[P], ops1[P + 1]
    kstart1 = _run_starts(s1)
    idneq = ids1 != jnp.concatenate(
        [jnp.full((1,), -1, ids1.dtype), ids1[:-1]])
    gstart1 = kstart1 | idneq
    ones = jnp.ones((L,), jnp.int32)
    rank = segscan.seg_scan(jnp.add, ones, gstart1) - 1

    # sort 2: (kmer, rank, input) -> contiguous (kmer, rank) groups
    keys2 = tuple(s1[p] for p in range(P - 1, -1, -1)) + \
        (rank.astype(U32), ids1)
    ops2 = jax.lax.sort(keys2 + (val1,), num_keys=P + 2, is_stable=True)
    s2 = [ops2[P - 1 - p] for p in range(P)]
    rank2, ids2, val2 = ops2[P].astype(jnp.int32), ops2[P + 1], ops2[P + 2]
    kstart = _run_starts(s2)
    rneq = rank2 != jnp.concatenate(
        [jnp.full((1,), -1, jnp.int32), rank2[:-1]])
    gstart = kstart | rneq

    present = val2 > U32(0)
    ms_any = jnp.zeros((L,), bool)
    for i in range(m):
        if ms_mask[i]:
            ms_any = ms_any | (ids2 == i)
    pm = present & ms_any    # multiset instances: act at (kmer, rank)
    pn = present & ~ms_any   # non-multiset: wildcard at kmer level

    # group-level reductions over multiset entries
    ones_m = jnp.where(pm, 1, 0).astype(jnp.int32)
    g_act, g_sum = segscan.seg_sum_all(
        (ones_m, jnp.where(pm, val2, U32(0))), gstart)
    prefix_m = jnp.cumsum(ones_m) - ones_m
    g_min, g_fidx, g_rbase = segscan.seg_min_all(
        (jnp.where(pm, val2, SENT), jnp.where(pm, ids2, BIG_ID),
         jnp.where(pm, prefix_m, BIG_ID)), gstart)
    gfirst_mask = pm & (prefix_m == g_rbase)
    g_max, g_first = segscan.seg_max_all(
        (jnp.where(pm, val2, U32(0)),
         jnp.where(gfirst_mask, val2, U32(0))), gstart)

    # kmer-level reductions over non-multiset (wildcard) entries
    ones_n = jnp.where(pn, 1, 0).astype(jnp.int32)
    k_act, k_sum = segscan.seg_sum_all(
        (ones_n, jnp.where(pn, val2, U32(0))), kstart)
    prefix_n = jnp.cumsum(ones_n) - ones_n
    k_min, k_fidx, k_rbase = segscan.seg_min_all(
        (jnp.where(pn, val2, SENT), jnp.where(pn, ids2, BIG_ID),
         jnp.where(pn, prefix_n, BIG_ID)), kstart)
    kfirst_mask = pn & (prefix_n == k_rbase)
    k_max, k_first = segscan.seg_max_all(
        (jnp.where(pn, val2, U32(0)),
         jnp.where(kfirst_mask, val2, U32(0))), kstart)

    # combined active set per (kmer, rank) group
    act_len = g_act + k_act
    v_sum = g_sum + k_sum
    v_min = jnp.minimum(g_min, k_min)
    v_max = jnp.maximum(g_max, k_max)
    first_idx = jnp.minimum(g_fidx, k_fidx)
    v_first = jnp.where(k_fidx < g_fidx, k_first, g_first)

    # per-kmer distinct-input presence (difference / symmetric-difference)
    pres_others = jnp.zeros((L,), jnp.int32)
    distinct = jnp.zeros((L,), jnp.int32)
    for i in range(m):
        pres_i = segscan.seg_max_all(
            jnp.where(present & (ids2 == i), 1, 0).astype(jnp.int32), kstart)
        distinct = distinct + pres_i
        if i > 0:
            pres_others = pres_others + pres_i

    zero = jnp.zeros((L,), U32)
    if op.startswith("intersect"):
        base = {"intersect": v_first, "intersect-min": v_min,
                "intersect-max": v_max, "intersect-sum": v_sum}[op]
        out = jnp.where(act_len == m, base, zero)
    elif op == "subtract":
        rest = v_sum - v_first
        ok = (first_idx == 0) & (v_first > rest)
        out = jnp.where(ok, v_first - rest, zero)
    elif op == "difference":
        out = jnp.where((first_idx == 0) & (pres_others == 0), v_first, zero)
    else:  # symmetric-difference
        out = jnp.where(distinct == 1, v_first, zero)

    keep = gstart & (act_len > 0) & (out > U32(0))
    return s2, out.astype(U32), keep


# Above this input count the windowed reduction's m-1 shifted passes
# lose to the log-depth segmented scans.
_WINDOW_MAX = 16


@functools.partial(jax.jit, static_argnames=("op", "m", "rowlen"))
def _merge_compute_stage(splanes, val, ids, op: str, m: int, threshold,
                         rowlen: int | None = None):
    start = _run_starts(splanes)
    if rowlen is not None:
        # rows were sorted independently: force a run start at every
        # row boundary so no segmented reduction crosses rows (keys
        # never span rows by construction; this only separates each
        # row's sentinel-padding tail from the next row cleanly)
        s2 = start.reshape(-1, rowlen)
        start = jnp.concatenate(
            [jnp.ones((s2.shape[0], 1), bool), s2[:, 1:]],
            axis=1).reshape(start.shape[0])

    present = val > U32(0)
    if m <= _WINDOW_MAX:
        act_len, v_first, first_idx, v_min, v_max, v_sum = \
            _windowed_reductions(start, present, val, ids, m)
    else:
        act_len, v_first, first_idx, v_min, v_max, v_sum = \
            _scan_reductions(start, present, val, ids)

    out = _apply_value_rule(op, m, act_len, v_first, first_idx,
                            v_min, v_max, v_sum, threshold)
    keep = start & (out > U32(0)) & (act_len > 0)
    return splanes, out.astype(U32), keep


def _windowed_reductions(start, present, val, ids, m: int):
    """Per-run reductions evaluated AT RUN START positions by looking
    ahead at most m-1 entries (garbage elsewhere; callers mask by
    `start`).

    Valid because each input holds UNIQUE keys, so a run has <= m
    PRESENT entries, and the stable sort keeps them contiguous at the
    run head (packed inputs place real entries before the sentinel
    padding whose value-0 entries are the only non-present ones).
    m-1 shifted elementwise passes replace log-depth segmented
    scans."""
    L = val.shape[0]

    def shift(x, o, fill):
        return jnp.concatenate([x[o:], jnp.full((o,), fill, x.dtype)])

    # offset 0 = the run-start entry itself; stable sort puts the
    # lowest-indexed input first, so first value/id come from offset 0
    act = jnp.where(present, 1, 0).astype(jnp.int32)
    v_sum = jnp.where(present, val, U32(0))
    v_min = jnp.where(present, val, SENT)
    v_max = v_sum
    v_first = val
    first_idx = ids
    same = jnp.ones((L,), bool)
    for o in range(1, m):
        same = same & ~shift(start, o, True)
        p_o = shift(present, o, False) & same
        v_o = shift(val, o, U32(0))
        act = act + jnp.where(p_o, 1, 0)
        v_sum = v_sum + jnp.where(p_o, v_o, U32(0))
        v_min = jnp.minimum(v_min, jnp.where(p_o, v_o, SENT))
        v_max = jnp.maximum(v_max, jnp.where(p_o, v_o, U32(0)))
    return act, v_first, first_idx, v_min, v_max, v_sum


def _scan_reductions(start, present, val, ids):
    """Segmented-scan per-run reductions (any run length; used above
    _WINDOW_MAX inputs)."""
    from . import segscan

    ones = jnp.where(present, 1, 0).astype(jnp.int32)
    # scatter-free per-run reductions (see ops/segscan.py): sums, mins
    # and maxes each share one fused forward+backward segmented scan
    act_len, v_sum = segscan.seg_sum_all(
        (ones, jnp.where(present, val, U32(0))), start)
    # rank within run among present entries (stable sort preserves the
    # input-then-position order, so rank 0 is the first instance of the
    # lowest-indexed present input)
    prefix = jnp.cumsum(ones) - ones
    v_min, first_idx, rank_base = segscan.seg_min_all(
        (jnp.where(present, val, SENT),
         jnp.where(present, ids, BIG_ID),
         prefix), start)
    is_first = present & (prefix == rank_base)
    v_max, v_first = segscan.seg_max_all(
        (jnp.where(present, val, U32(0)),
         jnp.where(is_first, val, U32(0))), start)
    return act_len, v_first, first_idx, v_min, v_max, v_sum
