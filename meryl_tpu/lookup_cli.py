"""meryl-lookup: compare sequences against k-mer databases.

Modes and output formats match the reference meryl-lookup
(/root/reference/src/meryl-lookup/meryl-lookup.C:160-230, dump.C,
existence.C, include-exclude.C):
  -bed        BED record per kmer found in a DB
  -bed-runs   overlapping found kmers merged into one record
  -wig-count  wiggle: kmer multiplicity at each starting position
  -wig-depth  wiggle: #found kmers covering each position (first DB)
  -existence  per sequence: ident, nTotal, then per DB nKmers/nFound
  -include    copy sequences with >= 1 kmer in the (single) DB
  -exclude    copy sequences with no kmer in the (single) DB

Each kmer is tested in both orientations (forward and reverse
complement) so non-canonical databases work (dump.C:93-127).
"""

from __future__ import annotations

import sys

import numpy as np
import jax.numpy as jnp

from . import kmer as km
from .io.sequence import iter_sequences
from .lookup import ExactLookup
from .ops import extract as ext
from .reports import _write_text as _wt
from .reports import format_int_table

CHUNK = 1 << 21  # max positions per device extraction batch
CHUNK_MIN = 1 << 12  # smallest extraction batch (signature grid floor)

USAGE = """usage: meryl-lookup <report-type> \\
         -sequence <input1.fasta> [<input2.fasta>] \\
         -output   <output1>      [<output2>] \\
         -mers     <input1.meryl> [<input2.meryl>] [...] [-estimate] \\
         -labels   <input1name>   [<input2name>]   [...]

  Compare kmers in input sequences against kmers in input meryl databases.

  Report types: -bed | -bed-runs | -wig-count | -wig-depth | -existence |
                -include | -exclude
  Options: -min N | -max N | -memory GB | -threads T | -10x | -estimate
"""


class LookupGlobal:
    def __init__(self):
        self.mode = None
        self.seq1 = None
        self.seq2 = None
        self.out1 = None
        self.out2 = None
        self.dbs: list[str] = []
        self.labels: list[str] = []
        self.min_v = 0
        self.max_v = km.VALUE_MAX
        self.memory_gb = None
        self.estimate = False
        self.is10x = False
        self.lookups: list[ExactLookup] = []


def parse_args(argv) -> LookupGlobal:
    g = LookupGlobal()
    i = 0
    modes = {"-bed": "bed", "-bed-runs": "bed-runs",
             "-wig-count": "wig-count", "-wig-depth": "wig-depth",
             "-existence": "existence", "-include": "include",
             "-exclude": "exclude"}
    while i < len(argv):
        a = argv[i]
        if a in modes:
            g.mode = modes[a]
        elif a == "-sequence":
            i += 1
            g.seq1 = argv[i]
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                g.seq2 = argv[i]
        elif a == "-mers":
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                g.dbs.append(argv[i])
        elif a == "-labels":
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                g.labels.append(argv[i])
        elif a == "-output":
            i += 1
            g.out1 = argv[i]
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                g.out2 = argv[i]
        elif a == "-min":
            i += 1
            g.min_v = int(argv[i])
        elif a == "-max":
            i += 1
            g.max_v = int(argv[i])
        elif a in ("-memory",):
            i += 1
            g.memory_gb = float(argv[i])
        elif a in ("-threads", "-loadthreads"):
            i += 1  # accepted for compatibility; XLA manages parallelism
        elif a == "-10x":
            g.is10x = True
        elif a == "-estimate":
            g.estimate = True
        elif a in ("-V",):
            pass
        elif a in ("-help", "-h", "--help"):
            raise SystemExit(USAGE)
        else:
            raise SystemExit(f"meryl-lookup: unknown option '{a}'\n{USAGE}")
        i += 1
    return g


def load_tables(g: LookupGlobal, err=None):
    err = err or sys.stderr
    from .db import MerylDB
    total = 0
    for p in g.dbs:
        L = ExactLookup(MerylDB.open(p), g.min_v, g.max_v)
        g.lookups.append(L)
        total += L.estimate_memory_bytes()
    if g.estimate:
        err.write(f"Estimated memory usage: {total / 1e9:.3f} GB for "
                  f"{len(g.lookups)} database(s)\n")
        raise SystemExit(0)
    if g.memory_gb is not None and total > g.memory_gb * 1e9:
        raise SystemExit(
            f"meryl-lookup: tables need {total / 1e9:.3f} GB > "
            f"-memory {g.memory_gb} GB")


BULK_MIN = 1 << 16  # switch to the sort-merge join above this many positions


def _extract_positions(codes: np.ndarray, k: int, P: int,
                       canonical: bool = False):
    """Per-position forward/reverse kmer planes + validity (host).

    Batch size adapts to the sequence (pow2 grid between CHUNK_MIN and
    CHUNK): a 25 Mbase chromosome extracts in ~12 dispatches instead
    of ~400 — every dispatch pays the device round trip.

    canonical=True extracts min(fmer, rmer) once and returns it as
    BOTH orientations: against a canonical database value(fmer) ==
    value(rmer) == value(canonical), so one query per position
    replaces two (half the link bytes and device dispatches; the
    wig-count palindrome rule still holds since fv == rv)."""
    L = len(codes)
    npos = max(0, L - k + 1)
    size = max(CHUNK_MIN, min(CHUNK, 1 << int(max(L, 1) - 1).bit_length()))
    fpl_np = [np.zeros(npos, np.uint32) for _ in range(P)]
    rpl_np = fpl_np if canonical else \
        [np.zeros(npos, np.uint32) for _ in range(P)]
    vmask = np.zeros(npos, bool)
    step = size - (k - 1)
    pos = 0
    while pos < npos:
        end = min(pos + size, L)
        chunk = np.full(size, 255, np.uint8)
        chunk[:end - pos] = codes[pos:end]
        if canonical:
            fpl, valid = ext.extract_kmers(jnp.asarray(chunk), k,
                                           "canonical")
            rpl = None
        else:
            fpl, rpl, valid = ext.extract_kmers(jnp.asarray(chunk), k,
                                                "both")
        nvalid = min(step, npos - pos)
        vmask[pos:pos + nvalid] = np.asarray(valid)[:nvalid]
        for p in range(P):
            fpl_np[p][pos:pos + nvalid] = np.asarray(fpl[p])[:nvalid]
            if not canonical:
                rpl_np[p][pos:pos + nvalid] = np.asarray(rpl[p])[:nvalid]
        pos += nvalid
    return fpl_np, rpl_np, vmask


def _per_position_values(lookups, codes: np.ndarray, k: int,
                         exists_only: bool = False,
                         allow_canonical: bool = True):
    """For each DB: (fvals, rvals) uint32 arrays over kmer start
    positions 0..len-k, plus the validity mask.

    Small batches use the prefix-table binary search; large ones the
    routed join (see lookup.py).  exists_only callers (screening) get
    0/1 and pay half the device->host bytes.

    allow_canonical=False disables the single-orientation shortcut for
    callers that need the reference's raw value(f)/value(r) pair (wig-
    count sums them, dump.C:154-161: against a canonical DB the raw
    pair is C for non-palindromes, while the shortcut's fv == rv would
    double to 2C)."""
    L = len(codes)
    npos = max(0, L - k + 1)
    if npos == 0:
        z = [np.zeros(0, np.uint32) for _ in lookups]
        return z, list(z), np.zeros(0, bool)
    P = lookups[0].P
    canonical = allow_canonical and all(
        Lk.db.mode == "canonical" for Lk in lookups)
    fpl_np, rpl_np, vmask = _extract_positions(codes, k, P, canonical)
    nf, nr = [], []
    # pad to a power of two so jit signatures stay bounded
    npad = 1 << max(8, int(npos - 1).bit_length())
    vpad = np.zeros(npad, bool)
    vpad[:npos] = vmask
    for Lk in lookups:
        if npos >= BULK_MIN:
            nf.append(Lk.values_bulk(fpl_np, vmask, exists_only))
            nr.append(nf[-1] if canonical else
                      Lk.values_bulk(rpl_np, vmask, exists_only))
        else:
            def q(pl):
                qp = []
                for p in pl:
                    a = np.zeros(npad, np.uint32)
                    a[:npos] = p
                    qp.append(jnp.asarray(a))
                return qp
            fv = np.asarray(Lk.values_batch(q(fpl_np),
                                            jnp.asarray(vpad)))[:npos]
            rv = fv if canonical else \
                np.asarray(Lk.values_batch(q(rpl_np),
                                           jnp.asarray(vpad)))[:npos]
            if exists_only:
                fv = (fv > 0).astype(np.uint32)
                rv = (rv > 0).astype(np.uint32)
            nf.append(fv)
            nr.append(rv)
    return nf, nr, vmask


def _is_palindrome(codes: np.ndarray, k: int) -> np.ndarray:
    """Per-position: is the kmer its own reverse complement (k even
    only).  Vectorized over sliding windows in bounded blocks (a
    per-position Python loop is ~1e8 iterations on a chromosome)."""
    L = len(codes)
    npos = max(0, L - k + 1)
    out = np.zeros(npos, bool)
    if k % 2 == 1 or npos == 0:
        return out
    comp = np.array([2, 3, 0, 1, *([255] * 252)], np.uint8)
    ccodes = comp[codes]
    BLOCK = 1 << 20
    for b in range(0, npos, BLOCK):
        e = min(b + BLOCK, npos)
        win = np.lib.stride_tricks.sliding_window_view(
            codes[b:e + k - 1], k)
        # fmer == rmer  <=>  window equals complement of its reversal
        cwin = np.lib.stride_tricks.sliding_window_view(
            ccodes[b:e + k - 1], k)[:, ::-1]
        out[b:e] = (win <= 3).all(axis=1) & (win == cwin).all(axis=1)
    return out


def cmd_dump(g: LookupGlobal, out):
    """-bed / -bed-runs / -wig-count / -wig-depth."""
    k = g.lookups[0].k
    use_labels = len(g.labels) > 0
    for name, seq, _ in iter_sequences(g.seq1):
        codes = km.CODE_LUT[np.frombuffer(seq, np.uint8)]
        nf, nr, vmask = _per_position_values(
            g.lookups, codes, k, exists_only=(g.mode != "wig-count"),
            allow_canonical=(g.mode != "wig-count"))
        npos = len(vmask)

        if g.mode in ("bed", "bed-runs"):
            nd = len(g.lookups)
            exist = np.zeros((nd, npos), bool)
            for d in range(nd):
                found = ((nf[d] > 0) | (nr[d] > 0)) & vmask
                if use_labels:
                    exist[d] |= found
                else:
                    exist[0] |= found  # dedupe across DBs (dump.C:128-133)
            maxp = 0
            for d in range(nd):
                w = np.flatnonzero(exist[d])
                if len(w):
                    maxp = max(maxp, int(w[-1]) + 1)
            single = nd == 1 or not use_labels
            if g.mode == "bed":
                if single:
                    # vectorized (genome-scale line counts)
                    ps = np.flatnonzero(exist[0])
                    lab = f"\t{g.labels[0]}" if use_labels else ""
                    _wt(out, format_int_table(
                        [ps, ps + k], prefix=f"{name}\t".encode(),
                        suffix=lab.encode()))
                else:
                    # multiple labeled DBs interleave by position then
                    # db, matching the reference's emit order
                    for p in range(maxp):
                        for d in range(nd):
                            if exist[d][p]:
                                lab = f"\t{g.labels[d]}" if d < len(g.labels) else ""
                                out.write(f"{name}\t{p}\t{p + k}{lab}\n")
            else:
                if single:
                    e = exist[0]
                    pad = np.zeros(len(e) + 2, np.int8)
                    pad[1:-1] = e
                    d2 = np.diff(pad)
                    starts = np.flatnonzero(d2 == 1)
                    ends = np.flatnonzero(d2 == -1)
                    lab = f"\t{g.labels[0]}" if use_labels else ""
                    # end written as first-unset-position + k,
                    # matching the reference exactly (dump.C:346-355)
                    _wt(out, format_int_table(
                        [starts, ends + k], prefix=f"{name}\t".encode(),
                        suffix=lab.encode()))
                else:
                    bgn = [None] * nd
                    for p in range(maxp + 1):
                        for d in range(nd):
                            bit = exist[d][p] if p < maxp else False
                            if bit:
                                if bgn[d] is None:
                                    bgn[d] = p
                                continue
                            if bgn[d] is None:
                                continue
                            lab = f"\t{g.labels[d]}" if d < len(g.labels) else ""
                            out.write(f"{name}\t{bgn[d]}\t{p + k}{lab}\n")
                            bgn[d] = None

        elif g.mode == "wig-count":
            pal = _is_palindrome(codes, k)
            count = np.zeros(npos, np.uint64)
            for d in range(len(g.lookups)):
                fv = nf[d].astype(np.uint64)
                rv = nr[d].astype(np.uint64)
                count += np.where(pal, fv, fv + rv) * vmask
            out.write(f"variableStep chrom={name}\n")
            ps = np.flatnonzero(count)
            _wt(out, format_int_table([ps + 1, count[ps]]))

        elif g.mode == "wig-depth":
            found = ((nf[0] > 0) | (nr[0] > 0)) & vmask
            w = np.flatnonzero(found)
            maxp = int(w[-1]) + k if len(w) else 0
            diff = np.zeros(maxp + k + 1, np.int64)
            np.add.at(diff, w, 1)
            np.add.at(diff, w + k, -1)
            depth = np.cumsum(diff)
            out.write(f"variableStep chrom={name}\n")
            ps = np.flatnonzero(depth[:maxp] > 0)
            _wt(out, format_int_table([ps + 1, depth[ps]]))


def cmd_existence(g: LookupGlobal, out):
    """Batched like cmd_filter: one bulk lookup per ~2M bases instead
    of two device dispatches per sequence."""
    k = g.lookups[0].k
    it = iter_sequences(g.seq1)
    done = False
    while not done:
        batch = []
        nb = 0
        while nb < FILTER_BATCH_BASES:
            r = next(it, None)
            if r is None:
                done = True
                break
            batch.append(r)
            nb += len(r[1])
        if not batch:
            break
        codes = [km.CODE_LUT[np.frombuffer(r[1], np.uint8)]
                 for r in batch]
        n = len(batch)
        buf, offs, lens = km.concat_codes_with_breakers(codes)
        nf, nr, vmask = _per_position_values(g.lookups, buf, k,
                                             exists_only=True)
        spans = np.maximum(0, lens - k + 1)
        cv = np.concatenate([[0], np.cumsum(vmask)])
        ntotal = cv[offs + spans] - cv[offs]
        nfound = []
        for d in range(len(g.lookups)):
            f = ((nf[d] > 0) | (nr[d] > 0)) & vmask
            cf = np.concatenate([[0], np.cumsum(f)])
            nfound.append(cf[offs + spans] - cf[offs])
        for i, (name, _seq, _q) in enumerate(batch):
            line = [name, str(int(ntotal[i]))]
            for d, L in enumerate(g.lookups):
                line += [str(L.n_kmers()), str(int(nfound[d][i]))]
            out.write("\t".join(line) + "\n")


def _write_seq(f, name, seq: bytes, qual, nfound: int):
    ident = f"{name} nKmers={nfound}"
    # qual=None means FASTA input; an EMPTY qual (zero-length read from
    # FASTQ) must still write a FASTQ record or the output mixes formats
    if qual is not None:
        f.write(f"@{ident}\n{seq.decode()}\n+\n{qual.decode()}\n")
    else:
        f.write(f">{ident}\n{seq.decode()}\n")


FILTER_BATCH_BASES = 1 << 21


def _batch_found(L, codes_list, k: int):
    """One bulk lookup over many reads: concatenate their codes with
    0xFF breakers (which invalidate cross-read windows), query ALL
    positions at once, and return (found mask, per-read position
    starts, per-read position span lengths).  This replaces a
    per-read path that paid two device dispatches per read."""
    buf, offs, lens = km.concat_codes_with_breakers(codes_list)
    nf, nr, vmask = _per_position_values([L], buf, k, exists_only=True)
    found = ((nf[0] > 0) | (nr[0] > 0)) & vmask
    spans = np.maximum(0, lens - k + 1)
    return found, offs, spans


def cmd_filter(g: LookupGlobal, out1, out2, err=None):
    err = err or sys.stderr
    k = g.lookups[0].k
    L = g.lookups[0]
    it1 = iter_sequences(g.seq1, want_quals=True)
    it2 = iter_sequences(g.seq2, want_quals=True) if g.seq2 else None
    n_total = 0
    n_found = 0
    done = False
    while not done:
        # gather a batch of read (pairs)
        b1, b2 = [], []
        nb = 0
        while nb < FILTER_BATCH_BASES:
            r1 = next(it1, None)
            r2 = next(it2, None) if it2 else None
            if r1 is None and r2 is None:
                done = True
                break
            b1.append(r1)
            b2.append(r2)
            nb += (len(r1[1]) if r1 else 0) + (len(r2[1]) if r2 else 0)
        if not b1:
            break
        recs = []                     # (pair index, mate index)
        codes = []
        for i in range(len(b1)):
            for idx, r in enumerate((b1[i], b2[i])):
                if r is not None:
                    recs.append((i, idx))
                    codes.append(km.CODE_LUT[np.frombuffer(r[1],
                                                           np.uint8)])
        found, offs, spans = _batch_found(L, codes, k)
        if g.is10x:
            for j, (_, idx) in enumerate(recs):
                if idx == 0:          # skip 10x barcode kmers
                    found[offs[j]:offs[j] + min(23, int(spans[j]))] = \
                        False
        cs = np.concatenate([[0], np.cumsum(found)])
        per_read = cs[offs + spans] - cs[offs]
        pair_nf = np.zeros(len(b1), np.int64)
        for j, (i, _) in enumerate(recs):
            pair_nf[i] += per_read[j]
        for i in range(len(b1)):
            n_total += 1
            nfound = int(pair_nf[i])
            keep = (nfound > 0) if g.mode == "include" else (nfound == 0)
            if keep:
                n_found += 1
                if b1[i] is not None and out1 is not None:
                    _write_seq(out1, b1[i][0], b1[i][1], b1[i][2],
                               nfound)
                if b2[i] is not None and out2 is not None:
                    _write_seq(out2, b2[i][0], b2[i][1], b2[i][2],
                               nfound)
    err.write(f"\nIncluding {n_found} reads (or read pairs) "
              f"out of {n_total}.\n")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        sys.stderr.write(USAGE)
        return 1
    try:
        g = parse_args(argv)
    except SystemExit as e:
        if e.code == 0 or e.code is None:
            return 0
        sys.stderr.write(str(e.code) + "\n" if isinstance(e.code, str) else "")
        return 1
    if g.mode is None or g.seq1 is None or not g.dbs:
        sys.stderr.write(USAGE)
        return 1
    load_tables(g)

    def open_out(p):
        if p is None or p == "-":
            return sys.stdout
        from .io.sequence import open_output
        return open_output(p)

    o1 = open_out(g.out1)
    o2 = open_out(g.out2) if g.out2 else None
    try:
        if g.mode in ("bed", "bed-runs", "wig-count", "wig-depth"):
            cmd_dump(g, o1)
        elif g.mode == "existence":
            cmd_existence(g, o1)
        else:
            cmd_filter(g, o1, o2)
    finally:
        if o1 is not sys.stdout:
            o1.close()
        if o2:
            o2.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
