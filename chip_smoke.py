"""Smoke test of the count -> set-op -> lookup path on NVIDIA GPUs.

Drives the product entry points (`meryl`, `meryl-lookup` and `meryl2`,
in this one process: `cli.main`, `lookup_cli.main`, `v2.cli.main`) on a
seeded data set the size of a bacterial-isolate sequencing run, and
checks every output exactly against an independent numpy reference
written below (2 bits per base, A=00 C=01 T=10 G=11, complement =
code ^ 2, canonical = the smaller of a k-mer and its reverse complement
under that integer order).  Database files are decoded here too, from
their documented on-disk layout.

    python chip_smoke.py [--seed N]      one GPU: phases a-f
    python chip_smoke.py --four-gpu      four GPUs: sharded count only

Every phase prints its wall time.  Any failure exits non-zero; without
a GPU the script exits non-zero before doing any work.  The last line
of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

GENOME_LEN = 4_641_652     # E. coli K-12 MG1655
READ_LEN = 150             # 2 x 150 bp pairs
COVERAGE = 30
SUB_RATE = 0.003           # per-base substitution rate
N_RUNS = 24                # N runs sprinkled into the genome
K = 21
K_WIDE = 33                # 3 key planes on the device
WIDE_BASES = 20_000_000    # read bases counted at K_WIDE
PROD_CHUNK = 1 << 22       # production device chunk (phase f)

ALPHA = np.frombuffer(b"ACTGN", np.uint8)   # code -> letter (4 = N)
CODE_OF = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACTG"):
    CODE_OF[_c] = _i
    CODE_OF[_c + 32] = _i                   # lower case
COMP = np.array([2, 3, 0, 1, 4], np.uint8)  # code ^ 2, N stays N


# ---------------------------------------------------------------------
# independent reference


def ref_windows(codes2d: np.ndarray, k: int):
    """Canonical k-mers of every window of each row of codes2d
    ((n, L) uint8, 0-3 = bases, 4 = N).  -> (hi, lo, valid), each
    (n, L - k + 1): the 2k-bit key split as bits [64, 128) and [0, 64);
    valid is False for windows that hold an N."""
    n, L = codes2d.shape
    W = L - k + 1
    if W <= 0:
        z = np.zeros((n, 0), np.uint64)
        return z, z.copy(), np.zeros((n, 0), bool)
    c = codes2d.astype(np.uint64)
    fhi = np.zeros((n, W), np.uint64)
    flo = np.zeros((n, W), np.uint64)
    rhi = np.zeros((n, W), np.uint64)
    rlo = np.zeros((n, W), np.uint64)
    two, three = np.uint64(2), np.uint64(3)
    for t in range(k):
        b = c[:, t:t + W] & three
        # forward: base t sits at significance k-1-t; reverse
        # complement: comp(base t) sits at significance t
        for dst_hi, dst_lo, pos, val in ((fhi, flo, k - 1 - t, b),
                                         (rhi, rlo, t, b ^ two)):
            if pos < 32:
                dst_lo |= val << np.uint64(2 * pos)
            else:
                dst_hi |= val << np.uint64(2 * (pos - 32))
    use_f = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    isn = np.zeros((n, L + 1), np.int32)
    np.cumsum(codes2d > 3, axis=1, out=isn[:, 1:])
    valid = (isn[:, k:] - isn[:, :W]) == 0
    return (np.where(use_f, fhi, rhi), np.where(use_f, flo, rlo),
            valid)


def ref_count(hi: np.ndarray, lo: np.ndarray):
    """Sorted unique (hi, lo) keys with their multiplicities."""
    if len(lo) == 0:
        z = np.zeros(0, np.uint64)
        return z, z.copy(), np.zeros(0, np.int64)
    if not hi.any():
        lo = np.sort(lo)
        hi = np.zeros(len(lo), np.uint64)
        new = np.empty(len(lo), bool)
        new[0] = True
        np.not_equal(lo[1:], lo[:-1], out=new[1:])
    else:
        order = np.lexsort((lo, hi))
        hi, lo = hi[order], lo[order]
        new = np.empty(len(lo), bool)
        new[0] = True
        new[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    st = np.flatnonzero(new)
    return hi[st], lo[st], np.diff(np.append(st, len(lo)))


def ref_count_rows(codes2d: np.ndarray, k: int, batch: int = 1 << 14):
    """ref_count over every valid window of every row, in row batches
    (bounded temporaries) spread over the host's cores (numpy releases
    the GIL inside its array operations)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(s):
        hi, lo, v = ref_windows(codes2d[s:s + batch], k)
        return hi[v], lo[v]

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        parts = list(pool.map(one, range(0, len(codes2d), batch)))
    return ref_count(np.concatenate([p[0] for p in parts]),
                     np.concatenate([p[1] for p in parts]))


def ref_count_seqs(seqs: list, k: int):
    """ref_count over a list of 1-D code arrays of any lengths."""
    his, los = [], []
    for s in seqs:
        hi, lo, v = ref_windows(s[None, :], k)
        his.append(hi[v])
        los.append(lo[v])
    return ref_count(np.concatenate(his), np.concatenate(los))


def read_db(path: str):
    """Decode a database directory from its on-disk layout: 64 bucket
    files 0x00.kmb..0x3f.kmb, each b"MTPUKMB1", u32 k, u32 flags, u64 n,
    u64[n] lo, u64[n] hi, u32[n] count, and (flags bit 0) n labels of
    the width in flags bits 8-15 (0 = 64).  -> (hi, lo, counts,
    labels-or-None), in bucket order."""
    his, los, cts, labs = [], [], [], []
    for ff in range(64):
        with open(os.path.join(path, f"0x{ff:02x}.kmb"), "rb") as f:
            raw = f.read()
        if raw[:8] != b"MTPUKMB1":
            raise ValueError(f"{path}: bucket {ff} has a bad magic")
        flags = int(np.frombuffer(raw, np.uint32, 1, 12)[0])
        n = int(np.frombuffer(raw, np.uint64, 1, 16)[0])
        off = 24
        los.append(np.frombuffer(raw, np.uint64, n, off))
        his.append(np.frombuffer(raw, np.uint64, n, off + 8 * n))
        cts.append(np.frombuffer(raw, np.uint32, n, off + 16 * n))
        if flags & 1:
            bits = (flags >> 8) & 0xFF or 64
            dt = (np.uint8 if bits <= 8 else np.uint16 if bits <= 16
                  else np.uint32 if bits <= 32 else np.uint64)
            labs.append(np.frombuffer(raw, dt, n, off + 20 * n)
                        .astype(np.uint64))
    labels = np.concatenate(labs) if labs else None
    return (np.concatenate(his), np.concatenate(los), np.concatenate(cts),
            labels)


def expect_equal(what: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = "shape" if got.shape != want.shape else int(
            np.count_nonzero(got != want))
        raise AssertionError(f"{what}: output differs from the reference"
                             f" (got {got.shape}, want {want.shape}, "
                             f"mismatches {bad})")


def expect_db(what: str, path: str, want) -> None:
    """The DB at path holds exactly the reference (hi, lo, counts)."""
    hi, lo, c, _ = read_db(path)
    expect_equal(f"{what} keys (hi)", hi, want[0])
    expect_equal(f"{what} keys (lo)", lo, want[1])
    expect_equal(f"{what} counts", c.astype(np.int64), want[2])


# ---------------------------------------------------------------------
# data


class Data:
    """Seeded genome (with N runs) and 2 x READ_LEN reads from both
    strands, written as FASTA and plain FASTQ under `td`."""

    def __init__(self, td: str, seed: int, genome_len: int = GENOME_LEN,
                 coverage: int = COVERAGE, n_runs: int = N_RUNS):
        rng = np.random.default_rng(seed)
        g = rng.integers(0, 4, size=genome_len).astype(np.uint8)
        for s in rng.integers(0, genome_len - 100, size=n_runs):
            g[s:s + int(rng.integers(1, 100))] = 4
        self.genome = g
        n_pairs = -(-coverage * genome_len // (2 * READ_LEN))
        flen = np.clip(rng.normal(400, 50, n_pairs), 2 * READ_LEN,
                       600).astype(np.int64)
        start = (rng.random(n_pairs) * (genome_len - flen + 1)).astype(
            np.int64)
        col = np.arange(READ_LEN)
        fwd = g[start[:, None] + col]
        back = COMP[g[(start + flen - READ_LEN)[:, None] + col]][:, ::-1]
        flip = rng.random(n_pairs) < 0.5
        r1 = np.where(flip[:, None], back, fwd)
        r2 = np.where(flip[:, None], fwd, back)
        for r in (r1, r2):
            err = (rng.random(r.shape) < SUB_RATE) & (r < 4)
            r[err] = (r[err] + rng.integers(1, 4, size=int(err.sum()))
                      .astype(np.uint8)) % 4
        self.r1, self.r2 = r1, r2
        self.asm = os.path.join(td, "asm.fasta")
        self.fq1 = os.path.join(td, "reads_1.fastq")
        self.fq2 = os.path.join(td, "reads_2.fastq")
        write_fasta(self.asm, "chr", g)
        write_fastq(self.fq1, r1, "/1")
        write_fastq(self.fq2, r2, "/2")
        self.bases = int(r1.size + r2.size)


def write_fasta(path: str, name: str, codes: np.ndarray) -> None:
    seq = ALPHA[codes].tobytes()
    with open(path, "wb") as f:
        f.write(b">%s\n" % name.encode())
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + b"\n")


def write_fastq(path: str, reads: np.ndarray, suffix: str) -> None:
    """Fixed-width records @rNNNNNNNN<suffix> / seq / + / qual, built as
    one byte matrix."""
    n, L = reads.shape
    sfx = np.frombuffer(suffix.encode(), np.uint8)
    hw = 2 + 8 + len(sfx) + 1
    rec = np.empty((n, hw + 2 * L + 4), np.uint8)
    rec[:, 0:2] = np.frombuffer(b"@r", np.uint8)
    ids = np.arange(n)
    for p in range(8):
        rec[:, 2 + p] = 48 + (ids // 10 ** (7 - p)) % 10
    rec[:, 10:10 + len(sfx)] = sfx
    rec[:, hw - 1] = ord("\n")
    rec[:, hw:hw + L] = ALPHA[reads]
    rec[:, hw + L] = ord("\n")
    rec[:, hw + L + 1] = ord("+")
    rec[:, hw + L + 2] = ord("\n")
    rec[:, hw + L + 3:hw + 2 * L + 3] = ord("I")
    rec[:, -1] = ord("\n")
    rec.tofile(path)


# ---------------------------------------------------------------------
# phases


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def run_main(fn, argv) -> str:
    """Call a CLI main in this process; fail on a non-zero status.
    Returns what it wrote to stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    if rc not in (0, None):
        raise RuntimeError(f"{' '.join(argv[:2])}...: exit status {rc}")
    return out.getvalue()


def count_db(args, path: str, expect_acc: bool = True) -> dict:
    """`meryl count` through cli.main; with expect_acc, assert the
    device-accumulator path ran.  Returns its wire stats."""
    from meryl_tpu import cli
    from meryl_tpu import counter
    counter.LAST_WIRE_STATS.clear()
    run_main(cli.main, ["count"] + args + ["output", path])
    stats = dict(counter.LAST_WIRE_STATS)
    if expect_acc and not stats.get("bases"):
        raise AssertionError("the device-accumulator path did not run")
    return stats


def check_reports(db: str, ref) -> None:
    """`histogram` and `statistics` agree with a bincount of the
    reference counts."""
    from meryl_tpu import cli
    occ = np.bincount(ref[2])
    vals = np.flatnonzero(occ)
    hist = np.array(run_main(cli.main, ["histogram", db]).split(),
                    np.int64).reshape(-1, 2)
    expect_equal("histogram values", hist[:, 0], vals)
    expect_equal("histogram occurrences", hist[:, 1], occ[vals])
    text = run_main(cli.main, ["statistics", db])
    head = {}
    rows = []
    for line in text.splitlines():
        f = line.split()
        if (len(f) >= 2 and f[0] in ("unique", "distinct", "present")
                and f[1].isdigit()):
            head[f[0]] = int(f[1])
        elif len(f) == 5 and f[0].isdigit():
            rows.append((int(f[0]), int(f[1])))
    want = {"unique": int(occ[1]) if len(occ) > 1 else 0,
            "distinct": len(ref[2]), "present": int(ref[2].sum())}
    if head != want:
        raise AssertionError(f"statistics {head} != reference {want}")
    expect_equal("statistics table", np.array(rows, np.int64).reshape(-1, 2),
                 np.stack([vals, occ[vals]], axis=1))


def phase_count(data: Data, td: str):
    """a. k=21 count of all reads on the device-accumulator path."""
    db = os.path.join(td, "reads.meryl")
    with phase("a count k=21 (cli)"):
        stats = count_db([f"k={K}", data.fq1, data.fq2], db)
    print(f"  device-accumulator stats: {json.dumps(stats)}")
    t0 = time.perf_counter()
    ref = ref_count_rows(np.concatenate([data.r1, data.r2]), K)
    print(f"  reference: {len(ref[2])} distinct, {int(ref[2].sum())} "
          f"total ({time.perf_counter() - t0:.1f} s)")
    expect_db("count k=21", db, ref)
    check_reports(db, ref)
    return db, ref


def phase_wide(data: Data, td: str, bases: int = WIDE_BASES):
    """b. k=33 (3 key planes, dense finalize download) on a prefix of
    the first reads."""
    n = max(1, min(len(data.r1), bases // READ_LEN))
    fq = os.path.join(td, "reads_wide.fastq")
    write_fastq(fq, data.r1[:n], "/1")
    db = os.path.join(td, "wide.meryl")
    with phase(f"b count k={K_WIDE} {n * READ_LEN} bases (cli)"):
        count_db([f"k={K_WIDE}", fq], db)
    ref = ref_count_rows(data.r1[:n], K_WIDE)
    expect_db(f"count k={K_WIDE}", db, ref)
    check_reports(db, ref)


def phase_setops(data: Data, td: str, reads_db: str, reads_ref):
    """c. assembly DB, then union-sum / intersect-min / difference."""
    from meryl_tpu import cli
    asm_db = os.path.join(td, "asm.meryl")
    with phase("c count assembly (cli)"):
        count_db([f"k={K}", data.asm], asm_db)
    asm_ref = ref_count_seqs([data.genome], K)
    expect_db("assembly count", asm_db, asm_ref)
    a, ca = reads_ref[1], reads_ref[2]
    b, cb = asm_ref[1], asm_ref[2]
    assert not reads_ref[0].any() and not asm_ref[0].any()
    keys = np.union1d(a, b)
    v = np.zeros(len(keys), np.int64)
    v[np.searchsorted(keys, a)] += ca
    v[np.searchsorted(keys, b)] += cb
    both, ia, ib = np.intersect1d(a, b, assume_unique=True,
                                  return_indices=True)
    only = ~np.isin(b, a, assume_unique=True)
    z = np.zeros
    want = {
        "union-sum": ([reads_db, asm_db], (z(len(keys), np.uint64), keys, v)),
        "intersect-min": ([reads_db, asm_db],
                          (z(len(both), np.uint64), both,
                           np.minimum(ca[ia], cb[ib]))),
        "difference": ([asm_db, reads_db],
                       (z(int(only.sum()), np.uint64), b[only], cb[only])),
    }
    for op, (ins, ref) in want.items():
        out = os.path.join(td, f"{op}.meryl")
        with phase(f"c {op} (cli)"):
            run_main(cli.main, [op] + ins + ["output", out])
        expect_db(op, out, ref)
        print(f"  {op}: {len(ref[2])} k-mers")
    return asm_db


def phase_lookup(data: Data, td: str, reads_db: str, reads_ref):
    """d. meryl-lookup -wig-count of the assembly against the reads DB
    through the grid compare-join fed by the native router."""
    from meryl_tpu import lookup, lookup_cli
    from meryl_tpu.ops import bacjoin
    seen = {"grid_join": 0, "native_route": 0}
    grid_join = lookup.ExactLookup._values_bulk_bacj
    native_route = bacjoin._route_queries_native

    def spy_join(self, *a, **kw):
        seen["grid_join"] += 1
        return grid_join(self, *a, **kw)

    def spy_route(*a, **kw):
        out = native_route(*a, **kw)
        if out is not NotImplemented:
            seen["native_route"] += 1
        return out

    wig = os.path.join(td, "asm.wig")
    lookup.ExactLookup._values_bulk_bacj = spy_join
    bacjoin._route_queries_native = spy_route
    try:
        with phase("d lookup -wig-count (cli)"):
            run_main(lookup_cli.main, ["-wig-count", "-sequence", data.asm,
                                       "-mers", reads_db, "-output", wig])
    finally:
        lookup.ExactLookup._values_bulk_bacj = grid_join
        bacjoin._route_queries_native = native_route
    print(f"  regime calls: {seen}")
    if not seen["grid_join"] or not seen["native_route"]:
        raise AssertionError(f"grid join with native router did not run: "
                             f"{seen}")
    with open(wig, "rb") as f:
        head = f.readline()
        body = np.array(f.read().split(), np.int64).reshape(-1, 2)
    if head.strip() != b"variableStep chrom=chr":
        raise AssertionError(f"wig header {head!r}")
    _, lo, valid = ref_windows(data.genome[None, :], K)
    lo, valid = lo[0], valid[0]
    keys, cnt = reads_ref[1], reads_ref[2]
    i = np.minimum(np.searchsorted(keys, lo), len(keys) - 1)
    val = np.where(valid & (keys[i] == lo), cnt[i], 0)
    pos = np.flatnonzero(val)
    expect_equal("wig-count positions", body[:, 0], pos + 1)
    expect_equal("wig-count values", body[:, 1], val[pos])
    print(f"  wig-count: {len(pos)} positions")


def phase_labels(data: Data, td: str):
    """e. meryl2: label each read half, union, check value and label."""
    from meryl_tpu.v2 import cli as v2cli
    l1 = os.path.join(td, "label1.meryl")
    l2 = os.path.join(td, "label2.meryl")
    u = os.path.join(td, "label_union.meryl")
    with phase("e meryl2 count label=#1, label=#2 (cli)"):
        run_main(v2cli.main, ["-k", str(K), "count", "label=#1", data.fq1,
                              f"output:database={l1}"])
        run_main(v2cli.main, ["-k", str(K), "count", "label=#2", data.fq2,
                              f"output:database={l2}"])
    with phase("e meryl2 union (cli)"):
        run_main(v2cli.main, ["union", l1, l2, f"output:database={u}"])
    k1 = ref_count_rows(data.r1, K)[1]
    k2 = ref_count_rows(data.r2, K)[1]
    keys = np.union1d(k1, k2)
    in1 = np.isin(keys, k1, assume_unique=True)
    in2 = np.isin(keys, k2, assume_unique=True)
    hi, lo, val, lab = read_db(u)
    if lab is None:
        raise AssertionError("meryl2 union wrote no labels")
    expect_equal("meryl2 union keys (hi)", hi, np.zeros(len(keys), np.uint64))
    expect_equal("meryl2 union keys (lo)", lo, keys)
    expect_equal("meryl2 union values", val.astype(np.int64),
                 in1.astype(np.int64) + in2)
    expect_equal("meryl2 union labels", lab,
                 in1.astype(np.uint64) | (in2.astype(np.uint64) << 1))
    print(f"  meryl2 union: {len(keys)} k-mers, {int((in1 & in2).sum())} "
          "in both")


def phase_memory(expected_uniques: int, chunk: int = PROD_CHUNK):
    """f. compiled.memory_analysis() of the count chunk pipeline and
    the accumulator route and merge steps at production shapes."""
    import jax
    import jax.numpy as jnp
    from meryl_tpu import counter, kmer
    from meryl_tpu.ops import accum
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=chunk).astype(np.uint8)
    p2, exc, n_real = kmer.pack_codes_2bit(codes, pad_to=chunk)
    wire = (jnp.asarray(p2), jnp.asarray(exc), jnp.uint32(n_real))
    acc = counter.DeviceAccCounter(K, "canonical", chunk, expected_uniques)
    B, La, P = acc.B, acc.La, acc.P
    cells = jax.eval_shape(lambda *w: accum.route_chunk_packed(
        *w, cfg=acc.cfg), *wire)[0]
    u32 = jnp.uint32
    plan = {
        "chunk pipeline": counter._chunk_pipeline.lower(
            wire, K, "canonical", None, counter._sort_rowlen(chunk)),
        "accumulator route": accum.route_chunk_packed.lower(
            *wire, cfg=acc.cfg),
        "accumulator merge": accum.merge_cells.lower(
            tuple(jax.ShapeDtypeStruct((B, La), u32) for _ in range(P)),
            jax.ShapeDtypeStruct((B, La), u32), (cells,) * acc.M,
            P=P, La_out=La, vmax=int(kmer.VALUE_MAX)),
    }
    with phase("f memory_analysis (compile)"):
        for name, low in plan.items():
            m = low.compile().memory_analysis()
            print(f"  memory {name} (chunk {chunk}, k={K}, B={B}, La={La},"
                  f" M={acc.M}): argument {m.argument_size_in_bytes} "
                  f"output {m.output_size_in_bytes} temp "
                  f"{m.temp_size_in_bytes} code "
                  f"{m.generated_code_size_in_bytes} bytes")


def hatch_fasta(path: str, n_devices: int, rng) -> list:
    """Reads that walk the sharded counter's exact hatches: poly-A
    (capture overflow -> mask + host recount), a 16-periodic motif
    (cell overflow -> captured windows) and random reads (enough
    uniques to outgrow a tiny accumulator budget -> spill)."""
    seqs = [np.zeros(1400, np.uint8),
            np.tile(CODE_OF[np.frombuffer(b"ACGTAACTGGTCAGTT", np.uint8)],
                    80)]
    seqs += [rng.integers(0, 4, size=700).astype(np.uint8)
             for _ in range(max(16, 4 * n_devices))]
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">h%d\n%s\n" % (i, ALPHA[s].tobytes()))
    return seqs


def phase_sharded(data: Data, td: str, n_devices: int) -> None:
    """Auto-sharded k=21 count over all visible GPUs, then the spill,
    mask+recount and capture hatches at tiny shapes."""
    from meryl_tpu.parallel import shard_count
    db = os.path.join(td, "reads_sharded.meryl")
    shard_count.LAST_SHARD_STATS.clear()
    with phase(f"sharded count k={K} on {n_devices} GPUs (cli)"):
        count_db([f"k={K}", data.fq1, data.fq2], db, expect_acc=False)
    stats = dict(shard_count.LAST_SHARD_STATS)
    print(f"  sharded stats: {json.dumps(stats)}")
    if not stats.get("steps"):
        raise AssertionError("the sharded counting path did not run")
    ref = ref_count_rows(np.concatenate([data.r1, data.r2]), K)
    expect_db("sharded count", db, ref)

    fa = os.path.join(td, "hatch.fa")
    seqs = hatch_fasta(fa, n_devices, np.random.default_rng(7))
    hdb = os.path.join(td, "hatch.meryl")
    knobs = {"MERYL_TPU_SHARD_CHUNK": "512",
             "MERYL_TPU_SHARD_ACC_CAP": "1200"}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    shard_count.LAST_SHARD_STATS.clear()
    try:
        with phase("sharded hatches (cli)"):
            count_db([f"k={K}", fa], hdb, expect_acc=False)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    stats = dict(shard_count.LAST_SHARD_STATS)
    print(f"  hatch stats: {json.dumps(stats)}")
    for hatch in ("spills", "recount_chunks", "captured_windows"):
        if not stats.get(hatch):
            raise AssertionError(f"hatch {hatch} did not fire: {stats}")
    expect_db("sharded hatch count", hdb, ref_count_seqs(seqs, K))


# ---------------------------------------------------------------------
# main


def card_lines(indices) -> list:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader", "-i",
                        ",".join(str(i) for i in indices)],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-gpu", action="store_true",
                    help="run only the sharded count on four GPUs")
    args = ap.parse_args(argv)
    n_dev = 4 if args.four_gpu else 1

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = ([c for c in visible.split(",") if c.strip()] if visible
             else [str(i) for i in range(n_dev)])
    if not args.four_gpu:
        # one process, one card: pinned before JAX starts
        cards = cards[:1]
        os.environ["CUDA_VISIBLE_DEVICES"] = cards[0]

    import meryl_tpu  # noqa: F401  (sets up the compile cache)
    import jax
    try:
        devs = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: no accelerator: {e}", file=sys.stderr)
        return 1
    if len(devs) != n_dev or any(d.platform != "gpu" for d in devs):
        print(f"chip_smoke: need exactly {n_dev} GPU device(s), JAX has "
              f"{[str(d) for d in devs]}", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    for line in card_lines(cards[:n_dev]):
        print(line)  # name, power limit: exactly as nvidia-smi gives them
    print(f"jax {jax.__version__}; bytes_limit "
          + ", ".join(str(d.memory_stats()["bytes_limit"]) for d in devs))
    from meryl_tpu import native
    print(f"native host library loaded: {native.available()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        with phase("data"):
            data = Data(td, args.seed)
        print(f"  genome {GENOME_LEN} bp, reads 2 x {len(data.r1)} x "
              f"{READ_LEN} bp = {data.bases} bases")
        if args.four_gpu:
            phase_sharded(data, td, n_dev)
            for d in devs:
                print(f"  {d}: peak_bytes_in_use "
                      f"{d.memory_stats()['peak_bytes_in_use']}")
        else:
            reads_db, reads_ref = phase_count(data, td)
            phase_wide(data, td)
            phase_setops(data, td, reads_db, reads_ref)
            phase_lookup(data, td, reads_db, reads_ref)
            phase_labels(data, td)
            phase_memory(os.path.getsize(data.fq1)
                         + os.path.getsize(data.fq2))
            print(f"  peak_bytes_in_use "
                  f"{devs[0].memory_stats()['peak_bytes_in_use']}")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
