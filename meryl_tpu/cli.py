"""The `meryl` command line: bracketed action-tree grammar.

Grammar matched to the reference CLI
(/root/reference/src/meryl/merylCommandBuilder.C; meryl.C:40-95):
  * each word may start with '[' (visual open) and end with any number
    of ']' (pop the op stack after the word)
  * global flags -V -Q -P -C; options k= n= memory= threads= compress
    count-suffix= d=/distinct= f=/word-frequency= t=/threshold= segment=
  * bare numbers bind to the current op's threshold or math constant
  * operations: count[-forward|-reverse], less-than, greater-than,
    at-least, at-most, equal-to, not-equal-to, increase, decrease,
    multiply, divide, divide-round, modulo, union[-min|-max|-sum],
    intersect[-min|-max|-sum], subtract, difference,
    symmetric-difference, histogram, statistics, ploidy|noise, compare
  * 'output NAME', 'print [NAME]', 'printACGT [NAME]'
  * inputs: meryl DB dirs, sequence files (counting ops only),
    histogram text files (ploidy only)
  * special commands: dumpIndex DB, dumpFile BUCKETFILE
"""

from __future__ import annotations

import os
import sys
import tempfile

from .db import MerylDB, is_meryl_db
from .histogram import MerylHistogram
from .optree import (COUNT_OPS, NEEDS_CONSTANT, NEEDS_THRESHOLD, DBInput,
                     OpNode, SeqInput, execute_compare, execute_root,
                     resolve_threshold, _node_k)
from . import reports

OP_NAMES = set(COUNT_OPS) | set(NEEDS_THRESHOLD) | set(NEEDS_CONSTANT) | {
    "union", "union-min", "union-max", "union-sum",
    "intersect", "intersect-min", "intersect-max", "intersect-sum",
    "subtract", "difference", "symmetric-difference",
    "histogram", "statistics", "ploidy", "noise", "compare",
}

USAGE = """usage: meryl [-V] [-Q] [-P] [-C] [options] action[s]
A device-accelerated k-mer counter and k-mer-set calculator with the
capabilities of meryl.  Actions form a tree:

  meryl k=21 count reads.fastq output reads.meryl
  meryl union-sum a.meryl b.meryl output u.meryl
  meryl print [greater-than 1 reads.meryl]
  meryl histogram reads.meryl
  meryl statistics reads.meryl
  meryl ploidy reads.meryl

operations:
  count count-forward count-reverse
  less-than greater-than at-least at-most equal-to not-equal-to  N
  increase decrease multiply divide divide-round modulo  N
  union union-min union-max union-sum
  intersect intersect-min intersect-max intersect-sum
  subtract difference symmetric-difference
  histogram statistics ploidy compare

options: k=K n=N memory=GB threads=T compress count-suffix=SUF
         d=/distinct=F f=/word-frequency=F t=/threshold=N segment=a/b
outputs: output DB.meryl | print [FILE] | printACGT [FILE]
"""


class ParseError(Exception):
    pass


class CommandBuilder:
    def __init__(self):
        self.k = 0
        self.memory_gb: float | None = None
        self.threads: int | None = None
        self.compress = False
        self.verbosity = 1
        self.progress = False
        self.configure_only = False
        self.stack: list[OpNode] = []
        self.roots: list[OpNode] = []
        self.all_ops: list[OpNode] = []
        self._terminating = 0
        self._pending_output = False
        self._pending_print = False
        self._print_acgt = False

    # ----- helpers -----

    def _push_root(self) -> OpNode:
        op = OpNode()
        self.stack.append(op)
        self.roots.append(op)
        self.all_ops.append(op)
        return op

    def top(self) -> OpNode:
        if not self.stack:
            self._push_root()
        return self.stack[-1]

    def _terminate(self):
        while self._terminating > 0 and self.stack:
            self.stack.pop()
            self._terminating -= 1
        self._terminating = 0

    # ----- word processing -----

    def process_word(self, word: str):
        self._terminate()
        if word.startswith("["):
            word = word[1:]
        while word.endswith("]"):
            word = word[:-1]
            self._terminating += 1
        self.top()  # ensure an op exists
        if word == "":
            return
        if self._process_option(word):
            return
        if self._process_operation(word):
            return
        if self._process_output(word):
            return
        if self._process_printer(word):
            return
        if self._process_input(word):
            return
        raise ParseError(
            f"Can't interpret '{word}': not a meryl command, option, or "
            f"recognized input file.")

    def _process_option(self, w: str) -> bool:
        if w.startswith("-V"):
            self.verbosity += len(w) - 1
            return True
        if w == "-Q":
            self.verbosity = 0
            return True
        if w == "-P":
            self.progress = True
            return True
        if w == "-C":
            self.configure_only = True
            return True
        if w == "compress":
            self.compress = True
            return True
        if w.isdigit():
            t = self.top()
            if t.op in NEEDS_THRESHOLD or t.op in NEEDS_CONSTANT:
                t.threshold = int(w)
                return True
            return False
        if "=" not in w:
            return False
        key, val = w.split("=", 1)
        t = self.top()
        if key == "k":
            v = int(val)
            if self.k and self.k != v:
                raise ParseError(f"kmer size mismatch: {self.k} != {v}")
            self.k = v
            return True
        if key == "n":
            t.expected_kmers = int(val)
            return True
        if key == "count-suffix":
            t.count_suffix = val
            return True
        if key in ("d", "distinct"):
            t.frac_distinct = float(val)
            return True
        if key in ("f", "word-frequency"):
            t.word_frequency = float(val)
            return True
        if key in ("t", "threshold"):
            t.threshold = int(val)
            return True
        if key == "memory":
            self.memory_gb = float(val)
            return True
        if key == "threads":
            self.threads = int(val)
            # host-side parallelism: the merge cascade reads this
            os.environ["MERYL_TPU_THREADS"] = str(self.threads)
            return True
        if key == "segment" and "/" in val:
            a, b = val.split("/", 1)
            t.segment = (int(a), int(b))
            return True
        return False

    def _process_operation(self, w: str) -> bool:
        if w not in OP_NAMES:
            return False
        name = "ploidy" if w == "noise" else w
        # counting ops cannot take input from another op: a second action
        # while a counting op tops the stack starts a sibling/root
        if self.top().is_counting():
            self.stack.pop()
            if not self.stack:
                self._push_root()
        t = self.top()
        if t.op != "nothing":
            child = OpNode()
            t.inputs.append(child)
            self.stack.append(child)
            self.all_ops.append(child)
            t = child
        t.op = name
        return True

    def _process_output(self, w: str) -> bool:
        if w == "output":
            self._pending_output = True
            return True
        if not self._pending_output:
            return False
        self._pending_output = False
        self.top().output_path = w
        return True

    def _process_printer(self, w: str) -> bool:
        if w == "print":
            self._pending_print = True
            self._print_acgt = False
            self.top().print_path = "-"
            return True
        if w == "printACGT":
            self._pending_print = True
            self._print_acgt = True
            self.top().print_path = "-"
            self.top().print_acgt = True
            return True
        if not self._pending_print:
            return False
        self._pending_print = False
        # 'print some.meryl' means print that DB to stdout
        if is_meryl_db(w):
            return False  # fall through to input handling
        self.top().print_path = w
        self.top().print_acgt = self._print_acgt
        return True

    def _process_input(self, w: str) -> bool:
        t = self.top()
        if is_meryl_db(w):
            self._pending_print = False
            t.inputs.append(DBInput(w))
            return True
        if os.path.isfile(w):
            if t.is_counting():
                t.inputs.append(SeqInput(w))
                return True
            if t.op == "ploidy":
                t.inputs.append(SeqInput(w))  # histogram text file
                return True
            raise ParseError(
                f"file input '{w}' only valid for counting operations "
                f"(or a histogram file for ploidy)")
        return False

    def finalize(self):
        self._terminate()
        # bare inputs with no op = print everything (reference turns
        # opNothing into opLessThan with an infinite threshold)
        for op in self.all_ops:
            if op.op == "nothing" and op.inputs:
                op.op = "passthrough"
        self.stack.clear()


def build(args: list[str]) -> CommandBuilder:
    b = CommandBuilder()
    for w in args:
        b.process_word(w)
    b.finalize()
    return b


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    if not argv or argv[0] in ("-h", "help", "--help"):
        sys.stderr.write(USAGE)
        return 0 if argv else 1

    if argv[0] == "dumpIndex":
        print(MerylDB.open(argv[1]).dump_index())
        return 0
    if argv[0] == "dumpFile":
        import numpy as np
        from . import kmer as _km
        path = argv[1]
        dbdir = os.path.dirname(path)
        db = MerylDB.open(dbdir)
        ff = int(os.path.basename(path).split(".")[0], 16)
        hi, lo, c = db.load_bucket(ff)
        print(f"bucket 0x{ff:02x}: {len(c)} kmers")
        from .reports import _write_text, format_kmer_lines
        _write_text(sys.stdout, format_kmer_lines(hi, lo, c, db.k))
        return 0

    try:
        b = build(argv)
    except ParseError as e:
        sys.stderr.write(f"meryl: {e}\n")
        return 1

    if not b.roots or all(r.op == "nothing" for r in b.roots):
        sys.stderr.write(USAGE)
        return 1

    return run(b)


def run(b: CommandBuilder) -> int:
    from .counter import count_to_db

    # report-only roots read stored histograms — no kmer scan
    # (/root/reference/src/meryl/meryl.C:185-215)
    for root in b.roots:
        if root.op in ("histogram", "statistics", "ploidy"):
            inp = root.inputs[0]
            if isinstance(inp, DBInput):
                db = inp.open()
                vals, occ = db.histogram()
                hist = MerylHistogram(vals, occ)
                kk = db.k
            else:  # ploidy also accepts a histogram text file
                hist = MerylHistogram.load(inp.path)
                kk = b.k or 21
            if root.op == "histogram":
                reports.report_histogram(hist)
            elif root.op == "statistics":
                reports.report_statistics(hist, kk)
            else:
                reports.report_ploidy(hist)
            return 0

    if b.configure_only:
        from .counter import configure_counting

        def describe_counting(node):
            if node.is_counting():
                paths = [s.path for s in node.inputs
                         if isinstance(s, SeqInput)]
                if paths and b.k:
                    plan = configure_counting(paths, b.k, b.memory_gb)
                    for kk, vv in plan.items():
                        sys.stderr.write(f"  {kk}: {vv}\n")
            for inp in node.inputs:
                if isinstance(inp, OpNode):
                    describe_counting(inp)

        for root in b.roots:
            root.describe()
            describe_counting(root)
        return 0

    # counting phase: materialize counting nodes into DBs, then convert
    # them to pass-through DB inputs (reference meryl.C:216-227)
    tmpdirs = []

    def materialize(node: OpNode):
        for i, inp in enumerate(node.inputs):
            if isinstance(inp, OpNode):
                materialize(inp)
                if inp.is_counting():
                    node.inputs[i] = DBInput(inp.output_path)
        if node.is_counting():
            if not b.k:
                raise ParseError("counting needs a kmer size (k=)")
            paths = [s.path for s in node.inputs if isinstance(s, SeqInput)]
            if not paths:
                raise ParseError("counting needs sequence file input")
            if node.output_path is None:
                node.output_path = tempfile.mkdtemp(prefix="meryl_count_")
                tmpdirs.append(node.output_path)
            mode = {"count": "canonical", "count-forward": "forward",
                    "count-reverse": "reverse"}[node.op]
            progress = None
            if b.progress:
                def progress(nbases):
                    sys.stderr.write(f"\rcounting: {nbases / 1e6:.1f} Mbp")
                    sys.stderr.flush()
            count_to_db(paths, node.output_path, b.k, mode=mode,
                        hpc=b.compress, count_suffix=node.count_suffix,
                        segment=node.segment, memory_gb=b.memory_gb,
                        progress=progress)
            if b.progress:
                sys.stderr.write("\n")

    try:
        for root in b.roots:
            materialize(root)

        for root in b.roots:
            if root.is_counting():
                # counting root: optional print of the counted DB
                if root.print_path is not None:
                    pt = OpNode(op="passthrough",
                                inputs=[DBInput(root.output_path)],
                                print_path=root.print_path,
                                print_acgt=root.print_acgt)
                    execute_root(pt, b.k)
                continue
            kk = _node_k(root, b.k)
            if not kk:
                raise ParseError("cannot determine kmer size")

            def check_k(n: OpNode):
                for inp in n.inputs:
                    if isinstance(inp, DBInput):
                        dk = inp.open().k
                        if dk != kk:
                            raise ParseError(
                                f"kmer size mismatch: {inp.path} has "
                                f"k={dk}, expected k={kk}")
                    elif isinstance(inp, OpNode):
                        check_k(inp)
            check_k(root)

            def resolve(n: OpNode):
                resolve_threshold(n)
                for inp in n.inputs:
                    if isinstance(inp, OpNode):
                        resolve(inp)
            resolve(root)

            if root.op == "compare":
                execute_compare(root, kk)
            else:
                execute_root(root, kk, verbose=b.verbosity)
        return 0
    except (ParseError, ValueError) as e:
        sys.stderr.write(f"meryl: {e}\n")
        return 1
    finally:
        import shutil
        for d in tmpdirs:
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
