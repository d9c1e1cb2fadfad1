"""meryl2: the next-generation CLI over the (value, label) model.

Action grammar per /root/reference/documentation/source/reference.rst:
399-460 (class:name=value parameters, v1 aliases, selectors with
and/or/not).  Evaluation is bucket-at-a-time on device (v2/engine.py).

Supported today: -k/-V/-Q global flags; count/count-forward/
count-reverse (with assign:label=#X constant labels); every v1 alias;
assign:value=/assign:label=; select:value/label/bases/input;
output:database/list/show/histogram/statistics/pipe; input databases,
nested [bracketed] actions and named pipes.
"""

from __future__ import annotations

import os
import sys
import tempfile
from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from .. import kmer as km
from ..db import NUM_FILES, MerylDB, MerylDBWriter, is_meryl_db
from ..histogram import MerylHistogram
from .engine import Assign, Selector, SelectorTerm, merge_action
from .parser import parse_assign, parse_selector_term, split_class_name

COUNT_OPS = ("count", "count-forward", "count-reverse")

# v1 aliases in terms of the v2 algebra
# (reference.rst:318-372; semantics fixed to match v1 exactly)
ALIASES = {
    "union":          (Assign("count"), Assign("or"), None),
    "union-min":      (Assign("min"), Assign("min"), None),
    "union-max":      (Assign("max"), Assign("max"), None),
    "union-sum":      (Assign("add"), Assign("or"), None),
    "intersect":      (Assign("first"), Assign("and"), "all"),
    "intersect-min":  (Assign("min"), Assign("min"), "all"),
    "intersect-max":  (Assign("max"), Assign("max"), "all"),
    "intersect-sum":  (Assign("add"), Assign("and"), "all"),
    "subtract":       (Assign("sub"), Assign("first"), "first"),
    "difference":     (Assign("first"), Assign("first"), "only-first"),
    "symmetric-difference": (Assign("first"), Assign("first"), "only-one"),
}
THRESH_ALIASES = {"less-than": "lt", "greater-than": "gt", "at-least": "ge",
                  "at-most": "le", "equal-to": "eq", "not-equal-to": "ne"}
MATH_ALIASES = {"increase": "add", "decrease": "sub", "multiply": "mul",
                "divide": "div", "divide-round": "divzero", "modulo": "mod"}


@dataclass
class DBInput:
    path: str
    db: MerylDB = None

    def open(self):
        if self.db is None:
            self.db = MerylDB.open(self.path)
        return self.db


@dataclass
class ListInput:
    path: str


@dataclass
class PipeInput:
    name: str


@dataclass
class SeqInput:
    path: str


@dataclass
class Action:
    name: str = ""
    vassign: Assign = None
    lassign: Assign = None
    products: list = field(default_factory=list)   # list[list[SelectorTerm]]
    cur_connector: str = "and"
    negate_next: bool = False
    pending_number: bool = False  # alias waiting for its numeric constant
    inputs: list = field(default_factory=list)
    out_db: str | None = None
    out_list: str | None = None
    out_list_acgt: bool = False
    out_show: bool = False
    out_pipe: str | None = None
    out_hist: str | None = None
    out_stats: str | None = None
    count_value: int | None = None
    count_label: int | None = None

    def is_counting(self) -> bool:
        return self.name in COUNT_OPS

    def add_term(self, terms):
        for t in terms:
            if self.cur_connector == "and" and self.products:
                self.products[-1].append(t)
            else:
                self.products.append([t])
            self.cur_connector = "and"


class ParseError(Exception):
    pass


def _alias_to_action(a: Action, name: str, const: int | None = None):
    a.name = name
    if name in ALIASES:
        va, la, sel = ALIASES[name]
        a.vassign, a.lassign = va, la
        if sel == "all":
            a.add_term(parse_selector_term("input", "all", False))
        elif sel == "first":
            a.add_term(parse_selector_term("input", "first", False))
        elif sel == "only-first":
            a.add_term(parse_selector_term("input", "first:1", False))
        elif sel == "only-one":
            a.add_term(parse_selector_term("input", "1", False))
    elif name in THRESH_ALIASES:
        a.vassign = Assign("first")
        a.lassign = Assign("first")
        a.pending_number = True
    elif name in MATH_ALIASES:
        a.lassign = Assign("first")
        a.pending_number = True
    elif name in COUNT_OPS:
        pass
    else:
        raise ParseError(f"unknown action '{name}'")


def _finish_alias_number(a: Action, n: int):
    if a.name in THRESH_ALIASES:
        a.add_term([SelectorTerm("value", THRESH_ALIASES[a.name],
                                 ("out", 0), ("const", n), False)])
    elif a.name in MATH_ALIASES:
        a.vassign = Assign(MATH_ALIASES[a.name], n, True)
    a.pending_number = False


class Builder:
    def __init__(self):
        self.k = 0
        self.compress = False
        self.verbosity = 1
        self.stack: list[Action] = []
        self.roots: list[Action] = []
        self.pipes: dict[str, Action] = {}
        self.label_bits = 64
        self.memory_gb = None
        self._terminating = 0
        self._pending_output = False

    def top(self) -> Action:
        if not self.stack:
            a = Action()
            self.stack.append(a)
            self.roots.append(a)
        return self.stack[-1]

    def _terminate(self):
        while self._terminating > 0 and self.stack:
            self.stack.pop()
            self._terminating -= 1
        self._terminating = 0

    def word(self, w: str):
        self._terminate()
        opened = False
        if w.startswith("["):
            w = w[1:]
            opened = True
        while w.endswith("]"):
            w = w[:-1]
            self._terminating += 1
        if opened:
            parent = self.top() if self.stack else None
            child = Action()
            if parent is not None and (parent.name or parent.inputs or
                                       parent.vassign or parent.products):
                parent.inputs.append(child)
                self.stack.append(child)
            elif parent is None:
                self.stack.append(child)
                self.roots.append(child)
            # else: empty parent on stack — reuse it as this action
        if w == "":
            return
        self._word(w)

    def _word(self, w: str):
        # global options
        if w.startswith("-k"):
            self.k = int(w[2:]) if len(w) > 2 else -1
            if self.k == -1:
                self._expect_k = True
            return
        if getattr(self, "_expect_k", False):
            self.k = int(w)
            self._expect_k = False
            return
        if getattr(self, "_swallow_arg", False):
            self._swallow_arg = False
            return
        if w == "-l":                 # label size in bits (merylGlobals
            self._expect_l = True     # -l): stored labels are masked and
            return                    # packed to this width
        if getattr(self, "_expect_l", False):
            self.label_bits = int(w)
            if not (0 <= self.label_bits <= 64):
                raise ParseError("-l label size must be in [0, 64]")
            self._expect_l = False
            return
        if w == "-t":                 # threads: host merge parallelism
            self._expect_t = True
            return
        if getattr(self, "_expect_t", False):
            import os as _o
            try:
                _o.environ["MERYL_TPU_THREADS"] = str(int(w))
            except ValueError:
                raise ParseError(
                    f"-t expects a thread count, got '{w}'")
            self._expect_t = False
            return
        if w == "-m":                 # memory (GB): drives the same
            self._expect_m = True     # counting plan as v1 memory=
            return
        if w.startswith("-m") and w[2:].replace(".", "", 1).isdigit():
            self.memory_gb = float(w[2:])
            return
        if getattr(self, "_expect_m", False):
            try:
                self.memory_gb = float(w)
            except ValueError:
                raise ParseError(
                    f"-m expects a memory size in GB, got '{w}'")
            self._expect_m = False
            return
        if w.startswith("-V") or w in ("-Q", "-P", "-C"):
            return
        if w == "compress":  # homopolymer-compress sequence inputs
            self.compress = True
            return

        t = self.top()

        if self._pending_output:          # compat: 'output <path>'
            self._pending_output = False
            t.out_db = w
            return

        if t.pending_number and w.isdigit():
            _finish_alias_number(t, int(w))
            return

        if w == "not":
            t.negate_next = True
            return
        if w in ("and", "or"):
            t.cur_connector = w
            return

        # class:name parameters
        p = split_class_name(w)
        if p is not None:
            cls, name, rest = p
            neg = t.negate_next
            t.negate_next = False
            if cls == "output":
                if name == "database":
                    t.out_db = rest
                elif name == "list":
                    t.out_list = rest
                elif name == "listACGT":
                    t.out_list = rest
                    t.out_list_acgt = True
                elif name == "show":
                    t.out_show = True
                elif name == "pipe":
                    t.out_pipe = rest
                    self.pipes[rest] = t
                elif name == "histogram":
                    t.out_hist = rest or "-"
                elif name == "statistics":
                    t.out_stats = rest or "-"
                return
            if cls == "assign":
                a = parse_assign(rest, name == "label")
                if name == "value":
                    if t.is_counting() and a.op == "set":
                        t.count_value = a.constant
                    else:
                        t.vassign = a
                else:
                    if t.is_counting() and a.op == "set":
                        t.count_label = a.constant
                    else:
                        t.lassign = a
                return
            if cls == "select":
                t.add_term(parse_selector_term(name, rest, neg))
                return
            if cls == "input":
                if name == "database":
                    t.inputs.append(DBInput(rest))
                elif name == "list":
                    t.inputs.append(ListInput(rest))
                elif name == "pipe":
                    t.inputs.append(PipeInput(rest))
                return

        # plain parameters value=X label=X (no class prefix)
        if w.startswith("value="):
            t.vassign = parse_assign(w[6:], False)
            return
        if w.startswith("label="):
            a = parse_assign(w[6:], True)
            if t.is_counting() and a.op == "set":
                t.count_label = a.constant
            else:
                t.lassign = a
            return
        # quick-start compatibility forms (the reference's own docs use
        # these: quick-start.rst lines 38, 61, 193; regex 0x26 is the
        # 'output <path>' compat rule in merylCommandBuilder-processText.C)
        if w.startswith("output="):
            t.out_db = w[7:]
            return
        if w == "output":
            self._pending_output = True
            return
        if w == "print":
            t.out_show = True
            return
        if w.startswith("print="):
            t.out_list = w[6:]
            return
        if w == "histogram":              # quick-start.rst:146
            t.out_hist = "-"
            return
        if w == "statistics":
            t.out_stats = "-"
            return
        if w.startswith("value:"):
            neg = t.negate_next
            t.negate_next = False
            t.add_term(parse_selector_term("value", w[6:], neg))
            return
        if w.startswith("label:"):
            neg = t.negate_next
            t.negate_next = False
            t.add_term(parse_selector_term("label", w[6:], neg))
            return
        if w.startswith("bases:"):
            neg = t.negate_next
            t.negate_next = False
            t.add_term(parse_selector_term("bases", w[6:], neg))
            return
        if w.startswith("input:") and not os.path.exists(w):
            neg = t.negate_next
            t.negate_next = False
            t.add_term(parse_selector_term("input", w[6:], neg))
            return
        if w.startswith("k="):
            self.k = int(w[2:])
            return

        # action names
        if w in ALIASES or w in THRESH_ALIASES or w in MATH_ALIASES or \
                w in COUNT_OPS:
            if t.name:
                child = Action()
                t.inputs.append(child)
                self.stack.append(child)
                t = child
            _alias_to_action(t, w)
            return

        # inputs by path
        if is_meryl_db(w):
            t.inputs.append(DBInput(w))
            return
        if os.path.isfile(w):
            if t.is_counting():
                t.inputs.append(SeqInput(w))
            else:
                t.inputs.append(ListInput(w))
            return

        raise ParseError(f"can't interpret '{w}'")

    def finalize(self):
        if self._pending_output:
            raise ParseError("'output' needs a following path")
        self._terminate()
        self.stack.clear()
        for r in list(self.roots):
            if not r.name and not r.vassign and len(r.inputs) == 1:
                r.name = "passthrough"
                r.vassign = Assign("first")
                r.lassign = Assign("first")


# ---------------- evaluation ----------------

class Evaluator:
    # row-batch the action kernel above this many total input entries
    # (below it, one flat row already sorts at the floor and the
    # packing overhead dominates)
    ROWPACK_MIN = 1 << 17

    def __init__(self, k: int, pipes: dict, label_bits: int = 64):
        self.k = int(k)
        self.P = km.num_planes(self.k)
        self.pipes = pipes
        self.label_mask = np.uint64(0xFFFFFFFFFFFFFFFF) if \
            label_bits >= 64 else np.uint64((1 << label_bits) - 1)

    @staticmethod
    def _pad_to(n: int) -> int:
        return 256 if n <= 256 else 1 << int(n - 1).bit_length()

    def _load_input(self, inp, ffs):
        if isinstance(inp, DBInput):
            db = inp.open()
            runs = [db.load_bucket_labels(ff) for ff in ffs]
            hi = np.concatenate([r[0] for r in runs])
            lo = np.concatenate([r[1] for r in runs])
            c = np.concatenate([r[2] for r in runs])
            lab = np.concatenate(
                [r[3] if r[3] is not None else np.zeros(len(r[2]), np.uint64)
                 for r in runs])
            return hi, lo, c, lab
        if isinstance(inp, Action):
            return self.eval_buckets(inp, ffs)
        if isinstance(inp, PipeInput):
            src = self.pipes.get(inp.name)
            if src is None:
                raise ParseError(f"no action outputs to pipe '{inp.name}'")
            return self.eval_buckets(src, ffs)
        if isinstance(inp, ListInput):
            return self._load_list_buckets(inp, ffs)
        raise ParseError(f"bad input {inp}")

    def _load_list_buckets(self, inp: ListInput, ffs):
        if not hasattr(inp, "_data"):
            from ..tools.import_tool import import_kmers
            hi, lo, c = import_kmers(inp.path, self.k)
            inp._data = (hi, lo, c, np.zeros(len(c), np.uint64))
        hi, lo, c, lab = inp._data
        pref = km.prefix6_from_hilo(hi, lo, self.k)
        m = (pref >= ffs[0]) & (pref <= ffs[-1])
        return hi[m], lo[m], c[m], lab[m]

    def eval_bucket(self, act: Action, ff: int):
        return self.eval_buckets(act, (ff,))

    def eval_buckets(self, act: Action, ffs):
        """Evaluate a group of ascending 6-bit buckets in one padded
        dispatch (buckets are disjoint ascending kmer ranges, so the
        sorted result stays globally ordered — see optree.eval_buckets)."""
        ins = [self._load_input(i, ffs) for i in act.inputs]
        m = len(ins)
        total = sum(len(x[2]) for x in ins)
        if total == 0:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.uint32), np.zeros(0, np.uint64)
        # multiset DBs may repeat keys within one input: the bounded-
        # window compute and key-boundary row splitting both assume
        # unique-keyed inputs
        uniq = not any(isinstance(i, DBInput) and i.open().multiset
                       for i in act.inputs)
        if uniq and m <= 6 and total >= self.ROWPACK_MIN:
            # row-batched layout for large groups: the action's sort
            # stage then sorts short rows instead of one flat row;
            # the packer
            # splits rows at shared key boundaries so the windowed
            # compute stage and the flattened result stay exact
            from ..optree import BucketEvaluator
            if not hasattr(self, "_rowpack_ev"):
                self._rowpack_ev = BucketEvaluator(self.k)
            triples = [(hi, lo, c) for hi, lo, c, _ in ins]
            extras = [[(lab & 0xFFFFFFFF).astype(np.uint32),
                       (lab >> np.uint64(32)).astype(np.uint32)]
                      for _, _, _, lab in ins]
            planes, values, ids, (llo, lhi) = \
                self._rowpack_ev._pack_rows(triples, m, extras=extras)
        else:
            N = self._pad_to(total)
            planes = [np.full(N, 0xFFFFFFFF, np.uint32)
                      for _ in range(self.P)]
            values = np.zeros(N, np.uint32)
            llo = np.zeros(N, np.uint32)
            lhi = np.zeros(N, np.uint32)
            ids = np.full(N, m, np.int32)
            pos = 0
            for i, (hi, lo, c, lab) in enumerate(ins):
                n = len(c)
                if n == 0:
                    continue
                for p, arr in enumerate(km.planes_from_hilo(
                        hi, lo, self.P)):
                    planes[p][pos:pos + n] = arr
                values[pos:pos + n] = c
                llo[pos:pos + n] = (lab & 0xFFFFFFFF).astype(np.uint32)
                lhi[pos:pos + n] = (lab >> np.uint64(32)).astype(
                    np.uint32)
                ids[pos:pos + n] = i
                pos += n

        va = act.vassign or Assign("first")
        la = act.lassign or Assign("first")
        sel = Selector(tuple(tuple(p) for p in act.products))
        vconst = np.uint32(va.constant & 0xFFFFFFFF)
        lc = int(la.constant)
        sp, ov, ollo, olhi, keep = merge_action(
            [jnp.asarray(p) for p in planes], jnp.asarray(values),
            jnp.asarray(llo), jnp.asarray(lhi), jnp.asarray(ids),
            m, self.k, va, la, sel, jnp.asarray(vconst),
            jnp.asarray(np.uint32(lc & 0xFFFFFFFF)),
            jnp.asarray(np.uint32((lc >> 32) & 0xFFFFFFFF)),
            unique_inputs=uniq)
        # flatten row-major: rows are ascending key ranges, so the
        # flattened kept entries stay globally sorted (flat inputs are
        # unchanged by the reshape)
        keep = np.asarray(keep).reshape(-1)
        idx = np.flatnonzero(keep)
        hi, lo = km.hilo_from_planes(
            [np.asarray(p).reshape(-1)[idx] for p in sp])
        lab = (np.asarray(olhi).reshape(-1)[idx].astype(np.uint64)
               << np.uint64(32)) | \
            np.asarray(ollo).reshape(-1)[idx].astype(np.uint64)
        return hi, lo, np.asarray(ov).reshape(-1)[idx], \
            lab & self.label_mask


def resolve_special_args(act: Action):
    """Resolve distinct=/word-freq= selector args via the first DB
    input's stored histogram (reference merylOp-nextMer.C:66-125)."""
    needs = any(t.arg1[0] in ("distinct", "wordfreq") or
                t.arg2[0] in ("distinct", "wordfreq")
                for p in act.products for t in p)
    if not needs:
        return
    dbs = [i for i in act.inputs if isinstance(i, DBInput)]
    if not dbs:
        raise ParseError("distinct=/word-freq= needs a database input")
    db = dbs[0].open()
    vals, occ = db.histogram()
    stats = db.stats()

    def resolve(argspec):
        kind, x = argspec
        if kind == "distinct":
            target = x * stats["numDistinct"]
            acc = 0
            for v, o in zip(vals.tolist(), occ.tolist()):
                acc += o
                if acc >= target:
                    return ("const", int(v))
            return ("const", int(vals[-1]) if len(vals) else 0)
        if kind == "wordfreq":
            return ("const", int(x * stats["numTotal"]))
        return argspec

    act.products = [
        [SelectorTerm(t.quantity, t.rel, resolve(t.arg1), resolve(t.arg2),
                      t.negate) for t in p]
        for p in act.products]


def print_v2(hi, lo, vals, labs, k, out, with_labels: bool,
             acgt: bool = False):
    # acgt: re-canonicalize to standard ACGT lexicographic order;
    # output is then NOT sorted (reference.rst:545-570)
    from ..reports import _write_text, format_kmer_lines
    _write_text(out, format_kmer_lines(
        hi, lo, vals, k, acgt_order=acgt,
        labels=labs if with_labels else None))


def _find_k(act, pipes) -> int:
    """kmer size from any database input reachable from `act` —
    directly, through nested actions, or through named pipes (the
    reference sizes nested counts from sibling DBs the same way;
    quick-start.rst's union-sum example counts without -k)."""
    for inp in act.inputs:
        if isinstance(inp, DBInput):
            try:
                return inp.open().k
            except Exception:
                continue
        if isinstance(inp, Action):
            kk = _find_k(inp, pipes)
            if kk:
                return kk
        if isinstance(inp, PipeInput) and inp.name in pipes:
            kk = _find_k(pipes[inp.name], pipes)
            if kk:
                return kk
    return 0


def _infer_k(b: Builder) -> int:
    for root in b.roots:
        kk = _find_k(root, b.pipes)
        if kk:
            return kk
    return 0


def execute(b: Builder) -> int:
    from ..counter import count_to_arrays

    if not b.k:
        b.k = _infer_k(b)

    # counting phase
    def materialize(act: Action, tmpdirs):
        for i, inp in enumerate(act.inputs):
            if isinstance(inp, Action):
                materialize(inp, tmpdirs)
                if inp.is_counting():
                    act.inputs[i] = DBInput(inp.out_db)
        if act.is_counting():
            if not b.k:
                raise ParseError("counting needs -k / k=")
            paths = [s.path for s in act.inputs if isinstance(s, SeqInput)]
            mode = {"count": "canonical", "count-forward": "forward",
                    "count-reverse": "reverse"}[act.name]
            if act.out_db is None:
                act.out_db = tempfile.mkdtemp(prefix="meryl2_count_")
                tmpdirs.append(act.out_db)
            if (act.count_value is None and act.count_label is None
                    and b.label_bits == 64):
                # plain counting routes through the same memory-planned
                # driver as the v1 CLI: -m (b.memory_gb) is a real
                # bound — counting goes out-of-core / batched when the
                # plan says the merged set exceeds it (the reference's
                # merylGlobals -m, merylGlobals.H:36-80)
                from ..counter import count_to_db
                count_to_db(paths, act.out_db, b.k, mode=mode,
                            hpc=b.compress, memory_gb=b.memory_gb)
                return
            hi, lo, c = count_to_arrays(paths, b.k, mode=mode, hpc=b.compress)
            if act.count_value is not None:
                c = np.full(len(c), act.count_value & 0xFFFFFFFF, np.uint32)
            labels = None
            if act.count_label is not None:
                labels = np.full(len(c), act.count_label, np.uint64)
            MerylDB.write(act.out_db, b.k, hi, lo, c, labels=labels,
                          label_bits=b.label_bits)

    tmpdirs = []
    try:
        for root in b.roots:
            materialize(root, tmpdirs)

        for root in b.roots:
            if root.is_counting():
                if not (root.out_show or root.out_list or root.out_hist
                        or root.out_stats):
                    continue
                # identity action over the counted DB: reuses the full
                # output machinery (show / list / ## / hist / stats)
                pt = Action()
                pt.inputs.append(DBInput(root.out_db))
                pt.out_show = root.out_show
                pt.out_list = root.out_list
                pt.out_list_acgt = root.out_list_acgt
                pt.out_hist = root.out_hist
                pt.out_stats = root.out_stats
                root = pt

            kk = b.k or _find_k(root, b.pipes)
            if not kk:
                raise ParseError("cannot determine k")

            def check_k(a):
                for i in a.inputs:
                    if isinstance(i, DBInput) and i.open().k != kk:
                        raise ParseError(
                            f"kmer size mismatch: {i.path} has "
                            f"k={i.open().k}, expected k={kk}")
                    elif isinstance(i, Action):
                        check_k(i)
            check_k(root)

            def walk(a):
                resolve_special_args(a)
                for i in a.inputs:
                    if isinstance(i, Action):
                        walk(i)
            walk(root)

            ev = Evaluator(kk, b.pipes, b.label_bits)
            writer = MerylDBWriter(root.out_db, kk,
                                   label_bits=b.label_bits) \
                if root.out_db else None
            from ..io.sequence import open_output
            listf = None
            list_sharded = root.out_list and "##" in root.out_list
            if root.out_list and not list_sharded:
                listf = open_output(root.out_list)
            hist_acc = {}
            from ..optree import bucket_groups as _groups
            from ..optree import OpNode as _OpNode

            def _v2_groups(act, target=None):
                import os as _o
                if target is None:
                    target = int(_o.environ.get("MERYL_TPU_SETOP_BATCH",
                                                1 << 20))
                # leaf-size estimate via DB bucket files, as in optree;
                # pipe-fed inputs resolve through their source action
                # (else a pipe-heavy tree estimates ~0 entries and all
                # 64 buckets land in one oversized dispatch)
                node = _OpNode()

                def leaves(a, out, seen=()):
                    for i in a.inputs:
                        if isinstance(i, DBInput):
                            out.append(i.path)
                        elif isinstance(i, Action):
                            leaves(i, out, seen)
                        elif (isinstance(i, PipeInput)
                              and i.name in b.pipes
                              and i.name not in seen):
                            leaves(b.pipes[i.name], out,
                                   seen + (i.name,))
                    return out
                from ..optree import DBInput as _ODB
                node.inputs = [_ODB(p) for p in leaves(act, [])]
                return _groups(node, target)

            for group in _v2_groups(root):
                hi, lo, vals, labs = ev.eval_buckets(root, group)
                pref = km.prefix6_from_hilo(hi, lo, kk) if \
                    (writer or list_sharded) and len(group) > 1 else None
                for ff in group:
                    if pref is not None:
                        s = np.searchsorted(pref, ff, "left")
                        e = np.searchsorted(pref, ff, "right")
                        bh, bl, bv, bb = hi[s:e], lo[s:e], vals[s:e], \
                            labs[s:e]
                    else:
                        bh, bl, bv, bb = hi, lo, vals, labs
                    if writer:
                        writer.add_bucket(ff, bh, bl, bv, bb)
                    if list_sharded:
                        # '##' -> one file per 6-bit prefix bucket
                        # (reference.rst:528-534: 64 parallel lists)
                        with open_output(root.out_list.replace(
                                "##", f"{ff:02d}")) as bf:
                            print_v2(bh, bl, bv, bb, kk, bf, True,
                                     acgt=root.out_list_acgt)
                if listf:
                    print_v2(hi, lo, vals, labs, kk, listf, True,
                             acgt=root.out_list_acgt)
                if root.out_show:
                    print_v2(hi, lo, vals, labs, kk, sys.stdout, True)
                if root.out_hist or root.out_stats:
                    v, o = np.unique(vals, return_counts=True)
                    for vv, oo in zip(v.tolist(), o.tolist()):
                        hist_acc[vv] = hist_acc.get(vv, 0) + oo
            if writer:
                writer.finalize()
            if listf:
                listf.close()
            if root.out_hist:
                f = sys.stdout if root.out_hist == "-" else \
                    open_output(root.out_hist)
                for v in sorted(hist_acc):
                    f.write(f"{v}\t{hist_acc[v]}\n")
                if f is not sys.stdout:
                    f.close()
            if root.out_stats:
                from ..reports import report_statistics
                h = MerylHistogram(
                    np.array(sorted(hist_acc), np.uint64),
                    np.array([hist_acc[v] for v in sorted(hist_acc)],
                             np.uint64))
                f = sys.stdout if root.out_stats == "-" else \
                    open_output(root.out_stats)
                report_statistics(h, kk, out=f)
                if f is not sys.stdout:
                    f.close()
        return 0
    finally:
        import shutil
        for d in tmpdirs:
            shutil.rmtree(d, ignore_errors=True)


USAGE = """usage: meryl2 [-k K] action [action...]
Actions: [ name assign:value=... assign:label=... select:...:...
           output:database=... inputs... ]
Aliases: union[-min|-max|-sum] intersect[-min|-max|-sum] subtract
         difference symmetric-difference less-than greater-than
         at-least at-most equal-to not-equal-to increase decrease
         multiply divide divide-round modulo count[-forward|-reverse]
"""


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        sys.stderr.write(USAGE)
        return 0 if argv else 1
    b = Builder()
    try:
        words = []
        i = 0
        while i < len(argv):
            if argv[i] == "-f":  # load program text from a file
                from .parser import load_program_text
                i += 1
                words.extend(load_program_text(argv[i]))
            else:
                words.append(argv[i])
            i += 1
        for w in words:
            b.word(w)
        b.finalize()
        return execute(b)
    except ParseError as e:
        sys.stderr.write(f"meryl2: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
