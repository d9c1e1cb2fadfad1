"""The action tree: nodes, inputs, and the bucket-at-a-time evaluator.

The reference evaluates its op tree as a lazy per-kmer pull pipeline
cloned 64x under OpenMP (/root/reference/src/meryl/meryl.C:253-263).
Here the same tree is evaluated one 6-bit-prefix bucket at a time:
every node maps a bucket's sorted unique (kmer, value) arrays to new
arrays via one batched device kernel (ops/setops.py).  Because buckets
are processed in ascending prefix order by a single process, printed
output is globally sorted (the reference only guarantees per-slice
order with threads > 1, src/tests/meryl-lookup-test.sh:102).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from . import kmer as km
from .db import NUM_FILES, MerylDB, MerylDBWriter
from .ops import setops

COUNT_OPS = ("count", "count-forward", "count-reverse")
REPORT_OPS = ("histogram", "statistics", "ploidy")
NEEDS_THRESHOLD = ("less-than", "greater-than", "at-least", "at-most",
                   "equal-to", "not-equal-to")
NEEDS_CONSTANT = ("increase", "decrease", "multiply", "divide",
                  "divide-round", "modulo")


@dataclass
class DBInput:
    path: str
    db: MerylDB = None

    def open(self):
        if self.db is None:
            self.db = MerylDB.open(self.path)
        return self.db


@dataclass
class SeqInput:
    path: str


@dataclass
class OpNode:
    op: str = "nothing"
    inputs: list = field(default_factory=list)  # DBInput | SeqInput | OpNode
    threshold: int | None = None
    frac_distinct: float | None = None
    word_frequency: float | None = None
    output_path: str | None = None
    print_path: str | None = None   # "-" = stdout
    print_acgt: bool = False
    expected_kmers: int | None = None
    count_suffix: str | None = None
    segment: tuple[int, int] | None = None

    def is_counting(self) -> bool:
        return self.op in COUNT_OPS

    def describe(self, depth: int = 0, out=None) -> None:
        """Tree printout (reference printTree, meryl.C:254)."""
        out = out or sys.stderr
        pad = "  " * depth
        extra = ""
        if self.threshold is not None:
            extra += f" threshold={self.threshold}"
        if self.output_path:
            extra += f" output={self.output_path}"
        if self.print_path:
            extra += f" print={self.print_path}"
        out.write(f"{pad}{self.op}{extra}\n")
        for inp in self.inputs:
            if isinstance(inp, OpNode):
                inp.describe(depth + 1, out)
            else:
                out.write("  " * (depth + 1) + f"input: {inp.path}\n")


def input_multiset(inp) -> bool:
    """Whether an input yields multiset (per-instance) entries."""
    if isinstance(inp, DBInput):
        return inp.open().multiset
    if isinstance(inp, OpNode):
        return node_output_multiset(inp)
    return False


def node_output_multiset(node: OpNode) -> bool:
    """A merge node's output is a multiset iff any input is (the
    per-instance merge of merylOp-nextMer.C:296-385 never collapses
    instances); counting always produces a plain set."""
    if node.op in COUNT_OPS:
        return False
    return any(input_multiset(i) for i in node.inputs)


def _node_k(node: OpNode, k: int | None) -> int:
    """Resolve k from the global option or the first DB input."""
    if k:
        return k
    for inp in node.inputs:
        if isinstance(inp, DBInput):
            return inp.open().k
        if isinstance(inp, OpNode):
            kk = _node_k(inp, None)
            if kk:
                return kk
    return 0


def resolve_threshold(node: OpNode) -> None:
    """Convert distinct= / word-frequency= into an absolute threshold
    using the single DB input's stored histogram (semantics of
    /root/reference/src/meryl/merylOp-nextMer.C:66-125)."""
    if node.frac_distinct is None and node.word_frequency is None:
        return
    if len(node.inputs) != 1 or not isinstance(node.inputs[0], DBInput):
        raise ValueError(
            "distinct=/word-frequency= thresholds need exactly one meryl "
            "database input")
    db = node.inputs[0].open()
    vals, occ = db.histogram()
    stats = db.stats()
    if node.frac_distinct is not None:
        target = node.frac_distinct * stats["numDistinct"]
        acc = 0
        for v, o in zip(vals.tolist(), occ.tolist()):
            acc += o
            if acc >= target:
                node.threshold = int(v)
                break
        else:
            node.threshold = int(vals[-1]) if len(vals) else 0
    if node.word_frequency is not None:
        node.threshold = int(node.word_frequency * stats["numTotal"])


class BucketEvaluator:
    """Evaluates an op tree bucket-by-bucket on device."""

    def __init__(self, k: int):
        self.k = int(k)
        self.P = km.num_planes(self.k)

    def _to_planes(self, hi, lo):
        return km.planes_from_hilo(hi, lo, self.P)

    @staticmethod
    def _pad_to(n: int) -> int:
        if n <= 256:
            return 256
        return 1 << (int(n - 1).bit_length())

    # row-batched merge packing: one long sort row is the slow shape,
    # and the merge inputs are already sorted —
    # so big bucket groups are split at shared key boundaries into
    # independent rows of ~ROW_TARGET entries and sorted as one
    # (R, L) batch.  ROW_SPLIT_MIN keeps small dispatches on the flat
    # path (fewer jit signatures).
    ROW_TARGET = 1 << 12
    ROW_SPLIT_MIN = 1 << 15

    @staticmethod
    def _quantize_rowlen(n: int) -> int:
        """Row length grid: quarter steps between powers of two (pure
        pow2 padding wastes up to 2x sort slots; the chip bench showed
        that waste directly in merged entries/s)."""
        if n <= 256:
            return 256
        p = 1 << (int(n - 1).bit_length() - 2)  # quarter step
        return ((n + p - 1) // p) * p

    @staticmethod
    def _row_cuts(ins, R: int):
        """R-1 ascending (hi, lo) cut keys that approximately balance
        total entries per row, from a rank-quantile sample."""
        his, los = [], []
        for hi, lo, c in ins:
            n = len(c)
            if n == 0:
                continue
            stride = max(1, n // (R * 32))
            his.append(hi[::stride])
            los.append(lo[::stride])
        hi = np.concatenate(his)
        lo = np.concatenate(los)
        order = np.lexsort((lo, hi))
        hi, lo = hi[order], lo[order]
        idx = (np.arange(1, R) * len(hi)) // R
        return hi[idx], lo[idx]

    @staticmethod
    def _searchsorted_hilo(hi, lo, cut_hi, cut_lo):
        """Lexicographic lower-bound of each (cut_hi, cut_lo) key in the
        sorted-unique (hi, lo) pair of arrays."""
        out = np.empty(len(cut_hi), np.int64)
        a_all = np.searchsorted(hi, cut_hi, "left")
        b_all = np.searchsorted(hi, cut_hi, "right")
        for j in range(len(cut_hi)):
            a, b = a_all[j], b_all[j]
            out[j] = a + np.searchsorted(lo[a:b], cut_lo[j], "left")
        return out

    def _pack_rows(self, ins, m: int, extras=None):
        """Pack m sorted-unique (hi, lo, counts) inputs into (R, L)
        padded plane/value/id arrays split at shared key boundaries:
        all instances of a key land in exactly one row, so rows sort
        independently and the flattened result is globally ordered.

        extras: optional per-input list of extra payload arrays (e.g.
        meryl2 label halves), each aligned with that input's counts;
        packed alongside (zero-padded) and returned as a fourth tuple
        when given."""
        total = sum(len(c) for _, _, c in ins)
        R = max(2, min(1 << 11, total // self.ROW_TARGET))
        R = 1 << (R - 1).bit_length()
        cut_hi, cut_lo = self._row_cuts(ins, R)
        bounds = []
        for hi, lo, c in ins:
            b = np.empty(R + 1, np.int64)
            b[0] = 0
            b[-1] = len(c)
            b[1:-1] = self._searchsorted_hilo(hi, lo, cut_hi, cut_lo)
            bounds.append(b)
        occ = np.zeros(R, np.int64)
        for b in bounds:
            occ += b[1:] - b[:-1]
        L = self._quantize_rowlen(int(occ.max()))
        planes = [np.full((R, L), 0xFFFFFFFF, np.uint32)
                  for _ in range(self.P)]
        values = np.zeros((R, L), np.uint32)
        ids = np.full((R, L), m, np.int32)
        n_extra = len(extras[0]) if extras else 0
        packed_extra = [np.zeros((R, L), extras[0][e].dtype)
                        for e in range(n_extra)]
        for i, (hi, lo, c) in enumerate(ins):
            iplanes = self._to_planes(hi, lo)
            b = bounds[i]
            pos = np.zeros(R, np.int64)
            for j in range(i):
                bj = bounds[j]
                pos += bj[1:] - bj[:-1]
            for r in range(R):
                s, e = b[r], b[r + 1]
                if e <= s:
                    continue
                p0 = pos[r]
                for p, arr in enumerate(iplanes):
                    planes[p][r, p0:p0 + e - s] = arr[s:e]
                values[r, p0:p0 + e - s] = c[s:e]
                ids[r, p0:p0 + e - s] = i
                for e2 in range(n_extra):
                    packed_extra[e2][r, p0:p0 + e - s] = \
                        extras[i][e2][s:e]
        if extras is not None:
            return planes, values, ids, packed_extra
        return planes, values, ids

    def eval_bucket(self, node: OpNode, ff: int):
        """-> (hi, lo, counts) for 6-bit prefix bucket ff."""
        return self.eval_buckets(node, (ff,))

    @staticmethod
    def _concat_buckets(runs):
        if len(runs) == 1:
            return runs[0]
        return tuple(np.concatenate([r[i] for r in runs])
                     for i in range(3))

    def eval_buckets(self, node: OpNode, ffs):
        """-> (hi, lo, counts) for a GROUP of ascending 6-bit prefix
        buckets, evaluated in one device dispatch.

        Buckets are disjoint ascending kmer ranges, so concatenating
        them keeps every run intact and the sorted result is still
        globally ordered — one padded kernel call replaces len(ffs)
        serial round trips (the reference's 64 cloned trees under
        OpenMP never pay this latency because its merge is in-process;
        a device pipeline does, so we batch)."""
        if node.op in COUNT_OPS:
            raise RuntimeError("counting nodes must be materialized first")

        ins = []
        for inp in node.inputs:
            if isinstance(inp, DBInput):
                db = inp.open()
                ins.append(self._concat_buckets(
                    [db.load_bucket(ff) for ff in ffs]))
            elif isinstance(inp, OpNode):
                ins.append(self.eval_buckets(inp, ffs))
            else:
                raise RuntimeError(f"unexpected input {inp} in merge phase")

        m = len(ins)
        if node.op in ("nothing", "passthrough") and m == 1:
            return ins[0]

        total = sum(len(c) for _, _, c in ins)
        if total == 0:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.uint32)

        thr = np.uint32(node.threshold or 0)
        ms_flags = tuple(input_multiset(i) for i in node.inputs)
        if not any(ms_flags) and total >= self.ROW_SPLIT_MIN:
            planes, values, ids = self._pack_rows(ins, m)
            splanes, out_vals, keep = setops.merge_op(
                [jnp.asarray(p) for p in planes], jnp.asarray(values),
                jnp.asarray(ids), node.op, m, jnp.asarray(thr))
            keep = np.asarray(keep)
            idx = np.flatnonzero(keep)
            hi, lo = km.hilo_from_planes(
                [np.asarray(p)[idx] for p in splanes])
            return hi, lo, np.asarray(out_vals)[idx]

        N = self._pad_to(total)
        planes = [np.full(N, 0xFFFFFFFF, np.uint32) for _ in range(self.P)]
        values = np.zeros(N, np.uint32)
        ids = np.zeros(N, np.int32)
        pos = 0
        for i, (hi, lo, c) in enumerate(ins):
            n = len(c)
            if n == 0:
                continue
            for p, arr in enumerate(self._to_planes(hi, lo)):
                planes[p][pos:pos + n] = arr
            values[pos:pos + n] = c
            ids[pos:pos + n] = i
            pos += n
        ids[pos:] = m  # padding id beyond any real input

        if any(ms_flags):
            splanes, out_vals, keep = setops.merge_op_multiset(
                [jnp.asarray(p) for p in planes], jnp.asarray(values),
                jnp.asarray(ids), node.op, m, jnp.asarray(thr), ms_flags)
        else:
            splanes, out_vals, keep = setops.merge_op(
                [jnp.asarray(p) for p in planes], jnp.asarray(values),
                jnp.asarray(ids), node.op, m, jnp.asarray(thr))
        keep = np.asarray(keep)
        idx = np.flatnonzero(keep)
        hi, lo = km.hilo_from_planes([np.asarray(p)[idx] for p in splanes])
        return hi, lo, np.asarray(out_vals)[idx]


def _bucket_entry_estimates(node: OpNode) -> np.ndarray:
    """Per-bucket input entry estimates from leaf DB file sizes."""
    from .db import bucket_name
    est = np.zeros(NUM_FILES, np.int64)

    def walk(n):
        for inp in n.inputs:
            if isinstance(inp, DBInput):
                db = inp.open()
                for ff in range(NUM_FILES):
                    try:
                        sz = os.path.getsize(
                            os.path.join(db.path, bucket_name(ff)))
                    except OSError:
                        sz = 0
                    est[ff] += max(0, sz - 24) // 20
            elif isinstance(inp, OpNode):
                walk(inp)

    walk(node)
    return est


def bucket_groups(node: OpNode, target: int | None = None) -> list:
    """Pack the 64 buckets into dispatch groups of ~target input
    entries each (one padded device call per group instead of 64
    serial round trips — latency batching for the merge phase)."""
    if target is None:
        target = int(os.environ.get("MERYL_TPU_SETOP_BATCH", 1 << 20))
    est = _bucket_entry_estimates(node)
    groups, cur, acc = [], [], 0
    for ff in range(NUM_FILES):
        cur.append(ff)
        acc += int(est[ff])
        if acc >= target:
            groups.append(tuple(cur))
            cur, acc = [], 0
    if cur:
        groups.append(tuple(cur))
    return groups


def execute_root(node: OpNode, k: int, *, out=None, verbose: int = 0):
    """Run the merge phase for one root: bucket-group eval, printing
    and DB output as we go.  Returns the written MerylDB (or None)."""
    ev = BucketEvaluator(k)
    writer = None
    if node.output_path:
        writer = MerylDBWriter(node.output_path, k,
                               multiset=node_output_multiset(node))
    pf = None
    if node.print_path is not None:
        from .io.sequence import open_output
        pf = sys.stdout if node.print_path == "-" else \
            open_output(node.print_path)
    try:
        from .reports import print_kmers
        for group in bucket_groups(node):
            if verbose >= 2:
                sys.stderr.write(
                    f"merylOp::eval()-- STARTING operation {node.op} "
                    f"buckets {group[0]:02d}..{group[-1]:02d}\n")
            hi, lo, counts = ev.eval_buckets(node, group)
            if verbose >= 3 and len(counts):
                # per-kmer trace (the reference's sayEverything ladder,
                # merylOp-nextMer.C:425-440): one line per surviving
                # kmer — debugging aid, deliberately unbounded
                from .reports import format_kmer_lines
                blob = format_kmer_lines(hi, lo, counts, k)
                for line in blob.decode().splitlines():
                    sys.stderr.write(
                        f"merylOp::eval()--   {node.op} kmer {line}\n")
            if writer is not None:
                if len(group) == 1:
                    writer.add_bucket(group[0], hi, lo, counts)
                else:
                    pref = km.prefix6_from_hilo(hi, lo, k)
                    for ff in group:
                        s = np.searchsorted(pref, ff, "left")
                        e = np.searchsorted(pref, ff, "right")
                        writer.add_bucket(ff, hi[s:e], lo[s:e],
                                          counts[s:e])
            if pf is not None and len(counts):
                print_kmers(hi, lo, counts, k, out=pf,
                            acgt_order=node.print_acgt)
        if writer is not None:
            return writer.finalize()
        return None
    finally:
        if pf is not None and pf is not sys.stdout:
            pf.close()


def execute_compare(node: OpNode, k: int, out=None):
    """The `compare` action: report kmers present in only one input or
    with differing values (reference merylOp-nextMer.C opCompare)."""
    out = out or sys.stdout
    ev = BucketEvaluator(k)
    assert len(node.inputs) == 2, "compare needs exactly two inputs"
    same = True
    for ff in range(NUM_FILES):
        ins = []
        for inp in node.inputs:
            if isinstance(inp, DBInput):
                ins.append(inp.open().load_bucket(ff))
            else:
                ins.append(ev.eval_bucket(inp, ff))
        a, b = ins
        # per-kmer INSTANCE value lists, so multiset inputs compare
        # per instance (value-rank matched) instead of collapsing to
        # one entry per kmer; single-entry DBs behave as before
        ka: dict = {}
        kb: dict = {}
        for h, l, c in zip(*a):
            ka.setdefault((int(h) << 64) | int(l), []).append(int(c))
        for h, l, c in zip(*b):
            kb.setdefault((int(h) << 64) | int(l), []).append(int(c))
        for v in sorted(set(ka) | set(kb)):
            s = km.kmer_to_string(v, k)
            va = sorted(ka.get(v, []))
            vb = sorted(kb.get(v, []))
            # message numbering matches the reference byte-for-byte:
            # "only in input %u" is the 0-based _actIndex, while the
            # value mismatch line says "input 1/2"
            # (merylOp-nextMer.C:617-629 mixes these the same way)
            for i in range(max(len(va), len(vb))):
                if i >= len(vb):
                    out.write(f"kmer {s} only in input 0\n")
                    same = False
                elif i >= len(va):
                    out.write(f"kmer {s} only in input 1\n")
                    same = False
                elif va[i] != vb[i]:
                    out.write(f"kmer {s} has value {va[i]} in input 1 "
                              f"!= value {vb[i]} in input 2\n")
                    same = False
    return same
