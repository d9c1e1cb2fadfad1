"""Device engine for meryl2 actions: (value, label) assigns + selectors.

Generalizes ops/setops.py to the meryl2 model
(/root/reference/src/meryl2/merylAssign.H:31-65,
merylSelector.H:26-120, documentation/source/reference.rst:560-770):
per unique kmer the engine computes

  * per-input presence, values and 64-bit labels (as 2x uint32 planes)
  * the assigned output value (13 value rules) and label (17 rules)
  * a selector sum-of-products over value/label/bases/input quantities

`@n` in selectors/assigns refers to the n-th PRESENT input in input
order, not the n-th listed input (reference.rst:830-833).

All per-run reductions are segment operations over one sorted
concatenation of the inputs — no streaming merge loop.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from ..ops import multiword as mw

U32 = jnp.uint32
SENT = U32(0xFFFFFFFF)

VALUE_ASSIGNS = ("nop", "set", "first", "selected", "atindex", "min", "max",
                 "add", "sub", "mul", "div", "divzero", "mod", "count")
LABEL_ASSIGNS = ("nop", "set", "first", "selected", "atindex", "min", "max",
                 "and", "or", "xor", "difference", "lightest", "heaviest",
                 "invert", "shift-left", "shift-right", "rotate-left",
                 "rotate-right")
RELATIONS = ("eq", "ne", "le", "ge", "lt", "gt")


@dataclass(frozen=True)
class Assign:
    """One assignment rule.  op from VALUE_ASSIGNS / LABEL_ASSIGNS;
    constant participates where the rule accepts (#X); index for @X."""
    op: str
    constant: int = 0
    has_constant: bool = False
    index: int = 0  # 1-based, for 'atindex' (@X)


@dataclass(frozen=True)
class SelectorTerm:
    """One term: quantity(arg1) relation quantity(arg2).

    quantity: 'value' | 'label' | 'bases' | 'input'
    arg spec: ('out', 0) output value/label; ('input', n) @n (1-based);
              ('const', c) constant.
    For 'bases', arg1 is ('letters', 'ACGT...') — the summed count of
    those letters in the kmer (v2/parser.py emits this shape).
    For 'input', the term is count-style: arg1 ('count',0) = number of
    present inputs, or ('present', n) truth of input n present (then
    relation/arg2 ignored, use rel='eq' const 1).
    """
    quantity: str
    rel: str
    arg1: tuple
    arg2: tuple
    negate: bool = False


@dataclass(frozen=True)
class Selector:
    """Sum of products: OR over groups, AND within group."""
    products: tuple = ()  # tuple[tuple[SelectorTerm, ...], ...]


def _sat_add(a, b):
    """uint32 add saturating at kmvalumax (merylOpCompute.C:171-178)."""
    s = a + b
    return jnp.where(s < a, SENT, s)


def _sat_mul(a, b):
    """uint32 multiply saturating at kmvalumax
    (merylOpCompute.C:196-203: overflow iff kmvalumax/a < b)."""
    lim = SENT // jnp.maximum(a, U32(1))
    ov = (a > U32(0)) & (b > lim)
    return jnp.where(ov, SENT, a * b)


def _rel(rel: str, a, b):
    return {"eq": a == b, "ne": a != b, "le": a <= b,
            "ge": a >= b, "lt": a < b, "gt": a > b}[rel]


def _rel64(rel: str, a, b):
    """Relation over (lo, hi) uint32-pair 64-bit quantities."""
    alo, ahi = a
    blo, bhi = b
    if rel == "eq":
        return (alo == blo) & (ahi == bhi)
    if rel == "ne":
        return (alo != blo) | (ahi != bhi)
    lt = (ahi < bhi) | ((ahi == bhi) & (alo < blo))
    eq = (alo == blo) & (ahi == bhi)
    return {"lt": lt, "le": lt | eq, "gt": ~(lt | eq), "ge": ~lt}[rel]


def _popcount32(x):
    x = x - ((x >> U32(1)) & U32(0x55555555))
    x = (x & U32(0x33333333)) + ((x >> U32(2)) & U32(0x33333333))
    x = (x + (x >> U32(4))) & U32(0x0F0F0F0F)
    return (x * U32(0x01010101)) >> U32(24)


def _count_base(planes, k: int, code: int):
    """Number of bases equal to `code` in each kmer (the reference's
    countNonZeroBases xor trick, merylSelector.H:87-120)."""
    total = jnp.zeros_like(planes[0])
    remaining = 2 * k
    cvt = U32(code * 0x55555555 & 0xFFFFFFFF)
    for p, pl in enumerate(planes):
        bits_here = min(32, remaining - 32 * p) if remaining - 32 * p > 0 else 0
        if bits_here <= 0:
            break
        x = pl ^ cvt  # base==code -> bits 00
        # squash pairs: bit set if either bit of the pair is set
        sq = (x | (x >> U32(1))) & U32(0x55555555)
        if bits_here < 32:
            sq = sq & U32((1 << bits_here) - 1)
            # pairs beyond the kmer look like code 'code' after xor when
            # they are zero; mask keeps only real pairs
        total = total + (U32(bits_here // 2) - _popcount32(sq))
    return total


def _label_popcount(lab):
    lo, hi = lab
    return _popcount32(lo) + _popcount32(hi)


@jax.jit
def _action_sort_stage(planes, values, lab_lo, lab_hi, input_ids):
    """Stable multiword sort with payloads; the program ends at the
    sort (see ops/count.py)."""
    P = len(planes)
    keys = [planes[p] for p in range(P - 1, -1, -1)]
    ops = jax.lax.sort(tuple(keys) + (values, lab_lo, lab_hi, input_ids),
                       num_keys=P, is_stable=True)
    splanes = [ops[P - 1 - p] for p in range(P)]
    return splanes, ops[P], ops[P + 1], ops[P + 2], ops[P + 3]


def merge_action(planes, values, lab_lo, lab_hi, input_ids,
                 m: int, k: int, vassign: Assign, lassign: Assign,
                 sel: Selector, vconst, lconst_lo, lconst_hi,
                 unique_inputs: bool = True):
    """Evaluate one meryl2 action over concatenated input buckets.

    planes: P uint32 arrays; values: uint32 (0 = padding);
    lab_lo/lab_hi: label halves; input_ids: int32 (m = padding id).
    Returns (sorted_planes, out_values, out_lab_lo, out_lab_hi, keep).

    Host-orchestrated in two device programs (sort | compute)."""
    splanes, val, llo, lhi, ids = _action_sort_stage(
        planes, values, lab_lo, lab_hi, input_ids)
    return _action_compute_stage(splanes, val, llo, lhi, ids, m, k,
                                 vassign, lassign, sel, vconst,
                                 lconst_lo, lconst_hi, unique_inputs)


@functools.partial(jax.jit,
                   static_argnames=("m", "k", "vassign", "lassign", "sel",
                                    "unique_inputs"))
def _action_compute_stage(splanes, val, llo, lhi, ids,
                          m: int, k: int, vassign: Assign, lassign: Assign,
                          sel: Selector, vconst, lconst_lo, lconst_hi,
                          unique_inputs: bool = True):
    N = val.shape  # full shape: (N,) flat or (R, L) row-packed

    from ..ops import segscan

    # run-start mask, shape-agnostic ((N,) flat or (R, L) row-packed;
    # rows never split a run — optree._pack_rows cuts at shared key
    # boundaries).  Same sentinel-prefix idiom as multiword.run_starts.
    neq0 = None
    for p in splanes:
        prevp = jnp.concatenate(
            [jnp.full(p.shape[:-1] + (1,), 0xFFFFFFFF, U32),
             p[..., :-1]], axis=-1)
        d0 = p != prevp
        neq0 = d0 if neq0 is None else (neq0 | d0)
    start = neq0

    present = val > U32(0)
    pres1 = jnp.where(present, 1, 0).astype(jnp.int32)

    # scatter-free per-run reductions broadcast to every element
    # (jax.ops.segment_* lowers to scatters).  Runs are bounded by m
    # (each input contributes at most one entry per key), so for
    # small m the fwd+bwd segmented scans (this stage runs ~a dozen of
    # them) are replaced by 2(m-1) shifted elementwise passes sharing
    # one set of same-run masks — the same windowed-reduction design
    # as the v1 set-op engine (ops/setops.py).
    if unique_inputs and m <= 6:  # m == 1 -> identity reductions
        # (multiset inputs may repeat a key within ONE input, so the
        # run-length <= m bound only holds for unique-keyed inputs)
        same_f = []  # same_f[d-1][i]: key[i] == key[i-d]
        same_b = []  # same_b[d-1][i]: key[i] == key[i+d]
        for d in range(1, m):
            eq = None
            for p in splanes:
                e = p[..., d:] == p[..., :-d]
                eq = e if eq is None else (eq & e)
            pad = jnp.zeros(val.shape[:-1] + (d,), bool)
            same_f.append(jnp.concatenate([pad, eq], axis=-1))
            same_b.append(jnp.concatenate([eq, pad], axis=-1))

        def _win(x, neutral, op):
            acc = x
            pshape = x.shape[:-1]
            for d in range(1, m):
                padv = jnp.full(pshape + (d,), neutral, x.dtype)
                f = jnp.concatenate([padv, x[..., :-d]], axis=-1)
                b = jnp.concatenate([x[..., d:], padv], axis=-1)
                acc = op(acc, jnp.where(same_f[d - 1], f, neutral))
                acc = op(acc, jnp.where(same_b[d - 1], b, neutral))
            return acc

        def ssum(x):
            return _win(x, x.dtype.type(0), jnp.add)

        def smin(x):
            neutral = x.dtype.type(0xFFFFFFFF) \
                if jnp.issubdtype(x.dtype, jnp.unsignedinteger) \
                else x.dtype.type(2**31 - 1)
            return _win(x, neutral, jnp.minimum)

        def smax(x):
            return _win(x, x.dtype.type(0), jnp.maximum)
    else:
        def ssum(x):
            return segscan.seg_sum_all(x, start)

        def smin(x):
            return segscan.seg_min_all(x, start)

        def smax(x):
            return segscan.seg_max_all(x, start)

    act_len = ssum(pres1)

    # rank of each present entry among present entries of its run
    prefix = jnp.cumsum(pres1, axis=-1) - pres1
    rank = prefix - smin(prefix)  # 0-based among present (stable order)

    def value_at_rank(r):  # 1-based @r
        mask = present & (rank == r - 1)
        return ssum(jnp.where(mask, val, U32(0)))

    def label_at_rank(r):
        mask = present & (rank == r - 1)
        return (ssum(jnp.where(mask, llo, U32(0))),
                ssum(jnp.where(mask, lhi, U32(0))))

    v_first = value_at_rank(1)
    l_first = label_at_rank(1)
    v_min = smin(jnp.where(present, val, SENT))
    v_max = smax(jnp.where(present, val, U32(0)))

    # ---- value=selected / label=selected ----
    # The reference DOCUMENTS these as "the value of the kmer selected by
    # the label selector" and vice versa (merylAssign.H:33,51) but its
    # shipped compute stage falls back to _acta[0] with a literal
    # "#warning wrong - need to figure out which input to select"
    # (merylOpCompute.C:149-152,299-301).  We implement the documented
    # intent: the chosen input is the first *present* input whose
    # label (resp. value) satisfies the label- (resp. value-) restricted
    # selector terms; with no such terms (or no passing input) the
    # reference's first-input fallback applies.
    N_ = N

    def _rank_passes(prods, quantity, r):
        cand_v = value_at_rank(r)
        cand_l = label_at_rank(r)
        any_ok = None
        for product in prods:
            p_ok = None
            for t in product:
                if quantity == "value":
                    def q(which):
                        kind, x = which
                        if kind == "out":
                            return cand_v
                        if kind == "input":
                            return value_at_rank(x)
                        return jnp.full(N_, x & 0xFFFFFFFF, U32)
                    tm = _rel(t.rel, q(t.arg1), q(t.arg2))
                else:
                    def q(which):
                        kind, x = which
                        if kind == "out":
                            return cand_l
                        if kind == "input":
                            return label_at_rank(x)
                        return (jnp.full(N_, x & 0xFFFFFFFF, U32),
                                jnp.full(N_, (x >> 32) & 0xFFFFFFFF, U32))
                    tm = _rel64(t.rel, q(t.arg1), q(t.arg2))
                if t.negate:
                    tm = ~tm
                p_ok = tm if p_ok is None else (p_ok & tm)
            any_ok = p_ok if any_ok is None else (any_ok | p_ok)
        return any_ok

    def _selected_rank(quantity):
        """Chosen 1-based rank per element, 0 = no input passes; None
        when the selector has no terms of this quantity."""
        prods = [[t for t in product if t.quantity == quantity]
                 for product in sel.products]
        prods = [p for p in prods if p]
        if not prods:
            return None
        chosen = jnp.zeros(N_, jnp.int32)
        for r in range(m, 0, -1):
            ok = _rank_passes(prods, quantity, r) & (act_len >= r)
            chosen = jnp.where(ok, jnp.int32(r), chosen)
        return chosen

    # ---- output value ----
    vc = vconst.astype(U32)
    op = vassign.op
    if op in ("nop", "first"):
        out_v = v_first
    elif op == "selected":
        chosen = _selected_rank("label")
        out_v = v_first
        if chosen is not None:
            for r in range(1, m + 1):
                out_v = jnp.where(chosen == r, value_at_rank(r), out_v)
    elif op == "set":
        out_v = jnp.full(N, 0, U32) + vc
    elif op == "atindex":
        out_v = value_at_rank(vassign.index)
    elif op == "min":
        out_v = jnp.minimum(v_min, vc) if vassign.has_constant else v_min
    elif op == "max":
        out_v = jnp.maximum(v_max, vc) if vassign.has_constant else v_max
    elif op in ("add", "sum"):
        # saturating sum over present inputs + constant (default 0),
        # merylOpCompute.C:171-178 (kmvalumax clamp per step)
        acc = jnp.full(N, 0, U32) + (vc if vassign.has_constant
                                        else U32(0))
        for r in range(1, m + 1):
            acc = _sat_add(acc, value_at_rank(r))  # absent rank -> +0
        out_v = acc
    elif op in ("sub", "dif"):
        # sequential clamped subtraction (merylOpCompute.C:180-194) is
        # equivalent to one clamp against the SATURATING sum of the
        # other inputs + constant: once the chain hits 0 it stays 0
        rest = jnp.zeros(N, U32)
        for r in range(2, m + 1):
            rest = _sat_add(rest, value_at_rank(r))
        if vassign.has_constant:
            rest = _sat_add(rest, jnp.zeros(N, U32) + vc)
        out_v = jnp.where(v_first > rest, v_first - rest, U32(0))
    elif op == "mul":
        # saturating product (merylOpCompute.C:196-203); constant
        # default 1 (merylCommandBuilder-isAssign.C:86)
        acc = jnp.full(N, 0, U32) + (vc if vassign.has_constant
                                        else U32(1))
        for r in range(1, m + 1):
            has = act_len >= r
            acc = jnp.where(has, _sat_mul(acc, value_at_rank(r)), acc)
        out_v = acc
    elif op == "div":
        # SEQUENTIAL division by each present input then the constant
        # (default 1), divide-by-zero -> 0 (merylOpCompute.C:206-218)
        acc = v_first
        for r in range(2, m + 1):
            has = act_len >= r
            acc = jnp.where(has, acc // jnp.maximum(value_at_rank(r),
                                                    U32(1)), acc)
        if vassign.has_constant:
            c = jnp.zeros(N, U32) + vc
            acc = jnp.where(c > U32(0),
                            acc // jnp.maximum(c, U32(1)), U32(0))
        out_v = acc
    elif op == "divzero":
        # sequential rounding division; 0 <= acc < divisor rounds up
        # to 1, divide-by-zero -> 0 (merylOpCompute.C:225-246);
        # constant default 1 applies the same rule (0 -> 1)
        def _divz_step(acc, d):
            qt = acc // jnp.maximum(d, U32(1))
            rem = acc - qt * jnp.maximum(d, U32(1))
            up = rem >= (d - rem)  # 2*rem >= d, overflow-free
            rounded = qt + jnp.where(up, U32(1), U32(0))
            return jnp.where(d == U32(0), U32(0),
                             jnp.where(acc < d, U32(1), rounded))
        acc = v_first
        for r in range(2, m + 1):
            has = act_len >= r
            acc = jnp.where(has, _divz_step(acc, value_at_rank(r)), acc)
        c = jnp.zeros(N, U32) + (vc if vassign.has_constant
                                    else U32(1))
        out_v = _divz_step(acc, c)
    elif op in ("mod", "rem"):
        # sequential quotient/remainder accumulation
        # (merylOpCompute.C:253-273): q walks the division chain, the
        # remainders sum; a zero divisor dumps q into the remainder.
        # Constant default 0 (isAssign.C:89) -> the leftover quotient
        # joins the remainder at the end.
        q = v_first
        racc = jnp.zeros(N, U32)
        for r in range(2, m + 1):
            has = act_len >= r
            d = jnp.maximum(value_at_rank(r), U32(1))  # present => >0
            qt = q // d
            racc = jnp.where(has, racc + (q - qt * d), racc)
            q = jnp.where(has, qt, q)
        c = jnp.zeros(N, U32) + (vc if vassign.has_constant
                                    else U32(0))
        qt = q // jnp.maximum(c, U32(1))
        racc = racc + jnp.where(c > U32(0), q - qt * c, q)
        out_v = racc
    elif op == "count":
        out_v = act_len.astype(U32)
    else:
        raise ValueError(f"value assign {op!r}")

    # ---- output label ----
    lo_c, hi_c = lconst_lo.astype(U32), lconst_hi.astype(U32)
    lop = lassign.op

    # bitwise AND/OR/XOR across the run: fold per-rank contributions.
    # m is small and static, so unroll over ranks.
    def fold_labels(fold, init_lo, init_hi, with_const):
        alo = jnp.full(N, init_lo, U32)
        ahi = jnp.full(N, init_hi, U32)
        for r in range(1, m + 1):
            rl, rh = label_at_rank(r)
            has = act_len >= r
            nlo, nhi = fold(alo, rl), fold(ahi, rh)
            alo = jnp.where(has, nlo, alo)
            ahi = jnp.where(has, nhi, ahi)
        if with_const and lassign.has_constant:
            alo, ahi = fold(alo, lo_c), fold(ahi, hi_c)
        return alo, ahi

    if lop in ("nop", "first"):
        out_llo, out_lhi = l_first
    elif lop == "selected":
        chosen = _selected_rank("value")
        out_llo, out_lhi = l_first
        if chosen is not None:
            for r in range(1, m + 1):
                rl, rh = label_at_rank(r)
                out_llo = jnp.where(chosen == r, rl, out_llo)
                out_lhi = jnp.where(chosen == r, rh, out_lhi)
    elif lop == "set":
        out_llo = jnp.zeros(N, U32) + lo_c
        out_lhi = jnp.zeros(N, U32) + hi_c
    elif lop == "atindex":
        out_llo, out_lhi = label_at_rank(lassign.index)
    elif lop == "and":
        out_llo, out_lhi = fold_labels(jnp.bitwise_and, 0xFFFFFFFF,
                                       0xFFFFFFFF, True)
    elif lop == "or":
        out_llo, out_lhi = fold_labels(jnp.bitwise_or, 0, 0, True)
    elif lop == "xor":
        out_llo, out_lhi = fold_labels(jnp.bitwise_xor, 0, 0, True)
    elif lop == "difference":
        alo, ahi = l_first
        for r in range(2, m + 1):
            rl, rh = label_at_rank(r)
            alo = alo & ~rl
            ahi = ahi & ~rh
        out_llo, out_lhi = alo, ahi
    elif lop in ("min", "max"):
        # label of the kmer with the min/max value
        tgt = v_min if lop == "min" else v_max
        mask = present & (val == tgt) & (rank == smin(
            jnp.where(present & (val == tgt), rank, jnp.int32(1 << 30))))
        out_llo = ssum(jnp.where(mask, llo, U32(0)))
        out_lhi = ssum(jnp.where(mask, lhi, U32(0)))
    elif lop in ("lightest", "heaviest"):
        w = _label_popcount((llo, lhi)).astype(jnp.int32)
        tgt = (smin(jnp.where(present, w, jnp.int32(1 << 30)))
               if lop == "lightest"
               else smax(jnp.where(present, w, jnp.int32(-1))))
        mask = present & (w == tgt)
        first_mask = mask & (rank == smin(
            jnp.where(mask, rank, jnp.int32(1 << 30))))
        out_llo = ssum(jnp.where(first_mask, llo, U32(0)))
        out_lhi = ssum(jnp.where(first_mask, lhi, U32(0)))
    elif lop == "invert":
        out_llo, out_lhi = ~l_first[0], ~l_first[1]
    elif lop in ("shift-left", "shift-right", "rotate-left", "rotate-right"):
        s = int(lassign.constant) % 64
        # 32-bit pair shifts (labels travel as u32 plane pairs)
        lo0, hi0 = l_first
        def shl(lo, hi, s):
            if s == 0:
                return lo, hi
            if s >= 32:
                return jnp.zeros_like(lo), lo << U32(s - 32) if s > 32 else lo
            return lo << U32(s), (hi << U32(s)) | (lo >> U32(32 - s))
        def shr(lo, hi, s):
            if s == 0:
                return lo, hi
            if s >= 32:
                return hi >> U32(s - 32) if s > 32 else hi, jnp.zeros_like(hi)
            return (lo >> U32(s)) | (hi << U32(32 - s)), hi >> U32(s)
        if lop == "shift-left":
            out_llo, out_lhi = shl(lo0, hi0, s)
        elif lop == "shift-right":
            out_llo, out_lhi = shr(lo0, hi0, s)
        else:
            l1, h1 = shl(lo0, hi0, s)
            l2, h2 = shr(lo0, hi0, (64 - s) % 64)
            if s == 0:
                out_llo, out_lhi = lo0, hi0
            elif lop == "rotate-left":
                out_llo, out_lhi = l1 | l2, h1 | h2
            else:
                l1, h1 = shr(lo0, hi0, s)
                l2, h2 = shl(lo0, hi0, (64 - s) % 64)
                out_llo, out_lhi = l1 | l2, h1 | h2
    else:
        raise ValueError(f"label assign {lop!r}")

    # ---- selector ----
    def present_in_listed(x):
        """Truth that the 1-based LISTED input x holds the kmer."""
        has = ssum(jnp.where(present & (ids == x - 1), 1, 0)
                   .astype(jnp.int32))
        return has > 0

    def term_quantity(t: SelectorTerm, which):
        kind, x = which
        if t.quantity == "value":
            if kind == "out":
                return out_v
            if kind == "input":
                return value_at_rank(x)
            return jnp.full(N, x & 0xFFFFFFFF, U32)
        if t.quantity == "label":
            if kind == "out":
                return (out_llo, out_lhi)
            if kind == "input":
                return label_at_rank(x)
            return (jnp.full(N, x & 0xFFFFFFFF, U32),
                    jnp.full(N, (x >> 32) & 0xFFFFFFFF, U32))
        if t.quantity == "bases":
            if kind == "letters":
                total = None
                for ch in x:
                    code = {"A": 0, "C": 1, "T": 2, "G": 3}[ch]
                    c = _count_base(splanes, k, code)
                    total = c if total is None else total + c
                return total
            return jnp.full(N, x, U32)
        raise ValueError(t.quantity)

    def eval_term(t: SelectorTerm):
        if t.quantity == "input":
            flags, idx, nums = t.arg1[1]
            ok = None
            cnt_ok = None
            if "any" in flags:
                cnt_ok = act_len >= 1
            if "all" in flags:
                c = act_len == m
                cnt_ok = c if cnt_ok is None else (cnt_ok | c)
            for kind2, n in nums:
                c = (act_len >= n) if kind2 == "atleast" else (act_len == n)
                cnt_ok = c if cnt_ok is None else (cnt_ok | c)
            idx_ok = None
            for x in idx:
                c = present_in_listed(x)
                idx_ok = c if idx_ok is None else (idx_ok & c)
            for part in (cnt_ok, idx_ok):
                if part is not None:
                    ok = part if ok is None else (ok & part)
            if ok is None:
                ok = act_len >= 1
            return ~ok if t.negate else ok
        a = term_quantity(t, t.arg1)
        b = term_quantity(t, t.arg2)
        tm = _rel64(t.rel, a, b) if t.quantity == "label" else _rel(t.rel, a, b)
        return ~tm if t.negate else tm

    if sel.products:
        selected = None
        for product in sel.products:
            pmask = None
            for t in product:
                tm = eval_term(t)
                pmask = tm if pmask is None else (pmask & tm)
            selected = pmask if selected is None else (selected | pmask)
    else:
        selected = jnp.ones(N, bool)

    keep = start & selected & (act_len > 0) & (out_v > U32(0))
    return splanes, out_v, out_llo, out_lhi, keep
