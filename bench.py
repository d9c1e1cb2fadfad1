"""Benchmark of the device kernels and of end-to-end counting on one GPU.

Prints one JSON line.  It names the device (`platform`, `device_kind`,
`device_count`) and the card (`card`: name and power limit as
nvidia-smi reports them).  Metrics:

  value / trials_bases_per_s  k=21 count KERNEL (extract + row-batched
      sort + run-start mask) at the production chunk (2^22), 2^26 bases
      per timed dispatch: the per-chunk program of the host-merge
      counting path
  lookup_*_mqps               bulk lookup grid compare-join kernel at
      4M, 2M and 2^28-entry tables
  setop_union_sum_meps, v2_union_label_meps   set-op and meryl2 action
      kernels
  count_e2e_bases_s           `count_to_db` from a FASTQ on disk to a
      DB on disk (device-accumulator path), best warm run, with the
      counter's own wire and sync counters
  bam/cram_ingest_mbases_s    host-only ingest rates

Each device timing runs a whole workload as ONE lax.scan dispatch and
ends in a scalar fetch, so launch overhead is amortized and nothing is
dead-code eliminated.  Throughputs keep best-of-N as the headline and
report every run and the median.  Without a GPU the script exits
non-zero; a failing phase fails the run.

    python bench.py
"""

import json
import os
import time

import numpy as np

from meryl_tpu.budget import budget_bytes


def _timeit_fetch(fn, inputs, trials):
    int(fn(inputs[0]))  # compile + warm
    times = []
    for t in range(trials):
        t0 = time.perf_counter()
        int(fn(inputs[1 + t]))
        times.append(time.perf_counter() - t0)
    return times


def bench_counting():
    import jax
    import jax.numpy as jnp
    from jax import lax
    from meryl_tpu.ops import count as cnt
    from meryl_tpu.ops import extract as ext

    K = 21
    CHUNK = 1 << 22          # production device chunk
    TOTAL = 1 << 26          # bases per timed dispatch
    ROWLEN = int(os.environ.get("MERYL_TPU_ROWLEN", 1 << 11))  # = product default (counter._sort_rowlen)
    TRIALS = 3

    def body(carry, codes):
        planes, valid = ext.extract_kmers(codes, K, "canonical")
        splanes, start, n_invalid = cnt.sort_starts(planes, valid, ROWLEN)
        return (carry + jnp.sum(start.astype(jnp.uint32))
                + splanes[0][0] + splanes[-1][-1]
                + jnp.sum(jnp.atleast_1d(n_invalid).astype(jnp.uint32))), None

    @jax.jit
    def pipeline(chunks):
        out, _ = lax.scan(body, jnp.uint32(0), chunks)
        return out

    rng = np.random.default_rng(0)
    R = TOTAL // CHUNK
    inputs = [jax.device_put(jnp.asarray(
        rng.integers(0, 4, size=(R, CHUNK)).astype(np.uint8)))
        for _ in range(TRIALS + 1)]
    jax.block_until_ready(inputs)

    times = _timeit_fetch(pipeline, inputs, TRIALS)
    trials = [TOTAL / dt for dt in times]
    return max(trials), trials


def bench_lookup():
    """Bulk exact-lookup throughput (BASELINE.md workload:
    'meryl-lookup batched queries'): bulk queries against a ~4M-kmer
    table, S slabs per scan dispatch with a scalar checksum out
    (measures the lookup kernel, not the device->host link).  The
    measured program is what the product dispatches for this workload:
    the bucket-aligned compare-join (ops/bacjoin.py) at the product
    slab size — the grid join owns every bulk table from BACJ_MIN_N =
    2^16 up (the lookup_midsize/exists fields measure it at a
    2M-entry table)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from meryl_tpu import lookup as lk
    from meryl_tpu.ops import bacjoin as bj

    K = 21
    N_DB = 1 << 22
    S = 2
    TRIALS = 3

    rng = np.random.default_rng(1)
    kmers = np.unique(rng.integers(0, 1 << 42, size=N_DB,
                                   dtype=np.uint64))
    hi = np.zeros(len(kmers), np.uint64)
    counts = rng.integers(1, 100, size=len(kmers)).astype(np.uint32)
    n = len(kmers)

    bm = min(26, 2 * K - 1, n.bit_length() + 3)
    topM = bj._top_bits_np(hi, kmers, K, bm)
    cM = np.bincount(topM, minlength=1 << bm)  # already int64

    def bucket_max(b):
        return int(cM.reshape(1 << b, -1).sum(axis=1).max())

    q_slab = lk.ExactLookup.BACJ_SLAB
    cfg = bj.plan_bacjoin(n, K, bucket_max, q_slab, budget_bytes("bacj"),
                          b_hi=bm)
    dbd, dbv = bj.build_db_grid(hi, kmers, counts, K, cfg)
    dbd_d = tuple(jnp.asarray(d) for d in dbd)
    dbv_d = jnp.asarray(dbv)
    jax.block_until_ready((dbd_d, dbv_d))
    kcfg = (K, cfg["b"], cfg["b1"], cfg["c"], cfg["capA"],
            cfg["s_cap"], cfg["ovfcap"])

    @jax.jit
    def pipeline(dbd_a, dbv_a, xs, nr):
        # grids ride as ARGUMENTS: closing over them captures GBs of
        # constants at lowering time and stalls the compile
        def body(carry, x):
            ql, nrow = x
            vals, pos, tail, novf = bj.bacjoin_kernel(
                dbd_a, dbv_a,
                tuple(ql[i] for i in range(ql.shape[0])), nrow, kcfg)
            return (carry + jnp.sum(vals, dtype=jnp.uint32)
                    + jnp.sum(pos, dtype=jnp.uint32)
                    + jnp.sum(tail, dtype=jnp.uint32)
                    + jnp.sum(novf).astype(jnp.uint32)), None
        out, _ = lax.scan(body, jnp.uint32(0), (xs, nr))
        return out

    def make_batch(seed0):
        qs, ns = [], []
        r = np.random.default_rng(seed0)
        for _ in range(S):
            half = q_slab // 2
            take = r.integers(0, n, size=half)
            qlo = np.concatenate([kmers[take], r.integers(
                0, 1 << 42, size=q_slab - half, dtype=np.uint64)])
            qhi = np.zeros(q_slab, np.uint64)
            qlow, n_row, _ = bj.route_queries_host(qhi, qlo, K, cfg)
            qs.append(np.stack(qlow))
            ns.append(n_row)
        return (jax.device_put(jnp.asarray(np.stack(qs))),
                jax.device_put(jnp.asarray(np.stack(ns))))

    inputs = [make_batch(60 + 17 * i) for i in range(TRIALS + 1)]
    jax.block_until_ready(inputs)
    int(pipeline(dbd_d, dbv_d, *inputs[0]))
    times = []
    for t in range(TRIALS):
        t0 = time.perf_counter()
        int(pipeline(dbd_d, dbv_d, *inputs[1 + t]))
        times.append(time.perf_counter() - t0)
    return [S * q_slab / dt / 1e6 for dt in times]


def bench_lookup_midsize():
    """Mid-size bulk lookup kernel: the bucket-grid compare-join
    (ops/bacjoin.py) at a ~2M-kmer table (the routed join remains only
    the degenerate-skew fallback).  Values mode and the packed exists mode
    that screening callers (existence/include/exclude/-bed/-wig-depth)
    use; half-hit/half-miss slabs, same scan + checksum convention as
    bench_lookup_bigdb."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from meryl_tpu import lookup as lk
    from meryl_tpu.ops import bacjoin as bj

    K = 21
    LOGN = 21
    S = 2
    TRIALS = 3

    rng = np.random.default_rng(25)
    n_target = 1 << LOGN
    gaps = rng.exponential(scale=(1 << (2 * K)) / n_target,
                           size=n_target)
    lo = np.floor(np.cumsum(gaps)).astype(np.uint64)
    keep = np.ones(n_target, bool)
    keep[1:] = lo[1:] != lo[:-1]
    lo = lo[keep & (lo < (1 << (2 * K)))]
    hi = np.zeros(len(lo), np.uint64)
    counts = rng.integers(1, 200, size=len(lo)).astype(np.uint32)
    n = len(lo)

    bm = min(26, 2 * K - 1, n.bit_length() + 3)
    topM = bj._top_bits_np(hi, lo, K, bm)
    cM = np.bincount(topM, minlength=1 << bm)

    def bucket_max(b):
        return int(cM.reshape(1 << b, -1).sum(axis=1).max())

    q_slab = lk.ExactLookup.BACJ_SLAB
    cfg = bj.plan_bacjoin(n, K, bucket_max, q_slab,
                          budget_bytes("bacj"), b_hi=bm)
    if cfg is None:  # degenerate cap/skew config: skip the metric,
        return None  # never sink the whole bench line
    dbd, dbv = bj.build_db_grid(hi, lo, counts, K, cfg)
    dbd_d = tuple(jnp.asarray(d) for d in dbd)
    dbv_d = jnp.asarray(dbv)
    jax.block_until_ready((dbd_d, dbv_d))
    kcfg = (K, cfg["b"], cfg["b1"], cfg["c"], cfg["capA"],
            cfg["s_cap"], cfg["ovfcap"])

    @jax.jit
    def pipeline(dbd_a, dbv_a, xs, nr):
        def body(carry, x):
            ql, nrow = x
            vals, pos, tail, novf = bj.bacjoin_kernel(
                dbd_a, dbv_a,
                tuple(ql[i] for i in range(ql.shape[0])), nrow, kcfg)
            return (carry + jnp.sum(vals, dtype=jnp.uint32)
                    + jnp.sum(pos, dtype=jnp.uint32)
                    + jnp.sum(tail, dtype=jnp.uint32)
                    + jnp.sum(novf).astype(jnp.uint32)), None
        out, _ = lax.scan(body, jnp.uint32(0), (xs, nr))
        return out

    @jax.jit
    def pipeline_exists(dbd_a, dbv_a, xs, nr):
        def body(carry, x):
            ql, nrow = x
            packed, tail, novf = bj.bacjoin_kernel(
                dbd_a, dbv_a,
                tuple(ql[i] for i in range(ql.shape[0])), nrow, kcfg,
                exists_only=True)
            return (carry + jnp.sum(packed, dtype=jnp.uint32)
                    + jnp.sum(tail, dtype=jnp.uint32)
                    + jnp.sum(novf).astype(jnp.uint32)), None
        out, _ = lax.scan(body, jnp.uint32(0), (xs, nr))
        return out

    def make_batch(seed0):
        qs, ns = [], []
        r = np.random.default_rng(seed0)
        for _ in range(S):
            half = q_slab // 2
            take = r.integers(0, n, size=half)
            qlo = np.concatenate([lo[take], r.integers(
                0, 1 << (2 * K), size=q_slab - half, dtype=np.uint64)])
            qhi = np.zeros(q_slab, np.uint64)
            routed = bj.route_queries_host(qhi, qlo, K, cfg)
            if routed is None:  # capA overflow (router rejection):
                return None     # skip the metric, not the bench
            qlow, n_row, _ = routed
            qs.append(np.stack(qlow))
            ns.append(n_row)
        return (jax.device_put(jnp.asarray(np.stack(qs))),
                jax.device_put(jnp.asarray(np.stack(ns))))

    inputs = [make_batch(60 + 13 * i) for i in range(TRIALS + 1)]
    if any(b is None for b in inputs):
        return None
    jax.block_until_ready(inputs)
    int(pipeline(dbd_d, dbv_d, *inputs[0]))
    int(pipeline_exists(dbd_d, dbv_d, *inputs[0]))
    times, times_e = [], []
    for t in range(TRIALS):
        t0 = time.perf_counter()
        int(pipeline(dbd_d, dbv_d, *inputs[1 + t]))
        times.append(time.perf_counter() - t0)
    for t in range(TRIALS):
        t0 = time.perf_counter()
        int(pipeline_exists(dbd_d, dbv_d, *inputs[1 + t]))
        times_e.append(time.perf_counter() - t0)
    return ([S * q_slab / dt / 1e6 for dt in times],
            [S * q_slab / dt / 1e6 for dt in times_e])


def bench_v2_action():
    """meryl2 action-engine throughput (the v2 algebra surface):
    union-sum with 64-bit label OR over three 1M-entry labeled inputs,
    row-packed at shared key boundaries, S
    batches per scan dispatch, fetch-grounded.  Returns merged
    entries/s in millions.  The measured program is the product's
    action kernel (v2/engine._action_sort_stage + _action_compute_
    stage with the windowed per-run reductions)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from meryl_tpu.optree import BucketEvaluator
    from meryl_tpu.v2.engine import (Assign, Selector,
                                     _action_compute_stage,
                                     _action_sort_stage)

    N = 1 << 20
    M = 3
    S = 4
    TRIALS = 3
    rng = np.random.default_rng(6)
    ev = BucketEvaluator(21)
    va, la, sel = Assign("add"), Assign("or"), Selector()

    def make_input():
        batches = []
        for _ in range(S):
            triples, extras = [], []
            for _ in range(M):
                v = np.unique(rng.integers(0, 1 << 42, size=N,
                                           dtype=np.uint64))
                hi = np.zeros(len(v), np.uint64)
                c = rng.integers(1, 100, size=len(v)).astype(np.uint32)
                lab = rng.integers(0, 1 << 63, size=len(v),
                                   dtype=np.uint64)
                triples.append((hi, v, c))
                extras.append([(lab & 0xFFFFFFFF).astype(np.uint32),
                               (lab >> np.uint64(32)).astype(np.uint32)])
            planes, values, ids, (llo, lhi) = ev._pack_rows(
                triples, M, extras=extras)
            batches.append((planes, values, llo, lhi, ids))
        out = tuple(
            jnp.asarray(np.stack([b[0][p] for b in batches]))
            for p in range(ev.P)) + tuple(
            jnp.asarray(np.stack([b[i] for b in batches]))
            for i in range(1, 5))
        return jax.device_put(out)

    vconst = jnp.uint32(0)
    lc0 = jnp.uint32(0)

    def body(carry, xs):
        planes = list(xs[:ev.P])
        values, llo, lhi, ids = xs[ev.P:]
        sp, v2, l2, h2, i2 = _action_sort_stage(planes, values, llo,
                                                lhi, ids)
        osp, ov, ollo, olhi, keep = _action_compute_stage(
            sp, v2, l2, h2, i2, M, 21, va, la, sel, vconst, lc0, lc0)
        return (carry + jnp.sum(jnp.where(keep, ov, 0),
                                dtype=jnp.uint32)
                + jnp.sum(ollo[:1], dtype=jnp.uint32)
                + osp[0][0, 0]), None

    @jax.jit
    def pipeline(xs):
        out, _ = lax.scan(body, jnp.uint32(0), xs)
        return out

    inputs = [make_input() for _ in range(TRIALS + 1)]
    jax.block_until_ready(inputs)
    times = _timeit_fetch(pipeline, inputs, TRIALS)
    return [S * M * N / dt / 1e6 for dt in times]


def bench_lookup_bigdb():
    """Big-DB bulk lookup (the Merqury screening regime): a 2^28-entry
    DB — 128x the 2^21-query slab — resolved by the bucket-aligned
    compare-join (ops/bacjoin.py), device-kernel rate by the same scan
    + scalar-checksum convention as bench_lookup.  The routed join
    re-sorts the grouped DB side every slab in this regime; the grid
    join's only DB touch is a dense streaming compare."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from meryl_tpu import lookup as lk
    from meryl_tpu.ops import bacjoin as bj

    K = 21
    LOGN = 28
    S = 2
    TRIALS = 3

    rng = np.random.default_rng(4)
    n_target = 1 << LOGN
    # sorted unique keys as a Poisson process over the key space: same
    # bucket-occupancy statistics as uniform draws, no giant sort
    gaps = rng.exponential(scale=(1 << (2 * K)) / n_target,
                           size=n_target)
    lo = np.floor(np.cumsum(gaps)).astype(np.uint64)
    keep = np.ones(n_target, bool)
    keep[1:] = lo[1:] != lo[:-1]
    lo = lo[keep & (lo < (1 << (2 * K)))]
    hi = np.zeros(len(lo), np.uint64)
    counts = rng.integers(1, 200, size=len(lo)).astype(np.uint32)
    n = len(lo)

    bm = min(26, 2 * K - 1)
    topM = bj._top_bits_np(hi, lo, K, bm)
    cM = np.bincount(topM, minlength=1 << bm)  # already int64

    def bucket_max(b):
        return int(cM.reshape(1 << b, -1).sum(axis=1).max())

    q_slab = lk.ExactLookup.BACJ_SLAB
    cfg = bj.plan_bacjoin(n, K, bucket_max, q_slab,
                          budget_bytes("bacj"), b_hi=bm)
    dbd, dbv = bj.build_db_grid(hi, lo, counts, K, cfg)
    dbd_d = tuple(jnp.asarray(d) for d in dbd)
    dbv_d = jnp.asarray(dbv)
    jax.block_until_ready((dbd_d, dbv_d))
    kcfg = (K, cfg["b"], cfg["b1"], cfg["c"], cfg["capA"],
            cfg["s_cap"], cfg["ovfcap"])

    @jax.jit
    def pipeline(dbd_a, dbv_a, xs, nr):
        # grids ride as ARGUMENTS: closing over them captures GBs of
        # constants at lowering time and stalls the compile
        def body(carry, x):
            ql, nrow = x
            vals, pos, tail, novf = bj.bacjoin_kernel(
                dbd_a, dbv_a,
                tuple(ql[i] for i in range(ql.shape[0])), nrow, kcfg)
            return (carry + jnp.sum(vals, dtype=jnp.uint32)
                    + jnp.sum(pos, dtype=jnp.uint32)
                    + jnp.sum(tail, dtype=jnp.uint32)
                    + jnp.sum(novf).astype(jnp.uint32)), None
        out, _ = lax.scan(body, jnp.uint32(0), (xs, nr))
        return out

    def make_batch(seed0):
        qs, ns = [], []
        r = np.random.default_rng(seed0)
        for _ in range(S):
            half = q_slab // 2
            take = r.integers(0, n, size=half)
            qlo = np.concatenate([lo[take], r.integers(
                0, 1 << (2 * K), size=q_slab - half, dtype=np.uint64)])
            qhi = np.zeros(q_slab, np.uint64)
            qlow, n_row, _ = bj.route_queries_host(qhi, qlo, K, cfg)
            qs.append(np.stack(qlow))
            ns.append(n_row)
        return (jax.device_put(jnp.asarray(np.stack(qs))),
                jax.device_put(jnp.asarray(np.stack(ns))))

    inputs = [make_batch(50 + 13 * i) for i in range(TRIALS + 1)]
    jax.block_until_ready(inputs)
    int(pipeline(dbd_d, dbv_d, *inputs[0]))  # compile + warm
    times = []
    for t in range(TRIALS):
        t0 = time.perf_counter()
        int(pipeline(dbd_d, dbv_d, *inputs[1 + t]))
        times.append(time.perf_counter() - t0)
    detail = {"n_db": int(n), "q_slab": int(q_slab),
              "db_over_slab": round(n / q_slab, 1),
              "grid_gb": round(cfg["B"] * cfg["s_cap"] * 4
                               * (cfg["ps"] + 1) / 1e9, 2),
              "geometry": {kk: int(cfg[kk]) for kk in
                           ("b", "b1", "c", "capA", "s_cap")}}
    return [S * q_slab / dt / 1e6 for dt in times], detail


def bench_setop():
    """Set-operation merge-kernel throughput (BASELINE.md workload:
    'union-sum / intersect-min / subtract set ops'): union-sum over
    two 1M-entry sorted unique inputs per batch, 8 batches per scan
    dispatch, fetch-grounded scalar out.  Returns merged entries/s in
    millions.  The measured program is what the op-tree evaluator
    dispatches per bucket group: optree._pack_rows splits the
    pre-sorted inputs at shared key boundaries into (R, L) rows
    (packing itself is host work, overlapped in production and
    untimed here, as with counting's host stages), then one
    row-batched sort + windowed-reduction compute stage."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from meryl_tpu.optree import BucketEvaluator
    from meryl_tpu.ops.setops import _merge_compute_stage, _merge_sort_stage

    N = 1 << 20
    S = 8
    TRIALS = 5
    rng = np.random.default_rng(2)
    ev = BucketEvaluator(21)

    def make_input():
        batches = []
        for _ in range(S):
            ins = []
            for inp in range(2):
                v = np.unique(rng.integers(0, 1 << 42, size=N,
                                           dtype=np.uint64))
                v = np.pad(v, (0, N - len(v)),
                           constant_values=(1 << 42) - 1)[:N]
                hi = np.zeros(N, np.uint64)
                vals = rng.integers(1, 100, size=N).astype(np.uint32)
                ins.append((hi, v, vals))
            batches.append(ev._pack_rows(ins, 2))
        planes = [jnp.asarray(np.stack([b[0][p] for b in batches]))
                  for p in range(ev.P)]
        values = jnp.asarray(np.stack([b[1] for b in batches]))
        ids = jnp.asarray(np.stack([b[2] for b in batches]))
        return jax.device_put((tuple(planes), values, ids))

    rowlen = None

    def body(carry, xs):
        planes, vals, ids = xs
        splanes, val, ids2 = _merge_sort_stage(list(planes), vals, ids)
        sp, ov, keep = _merge_compute_stage(splanes, val, ids2,
                                            "union-sum", 2, jnp.uint32(0),
                                            rowlen)
        return (carry + jnp.sum(jnp.where(keep, ov, 0)) + sp[0][0]), None

    @jax.jit
    def pipeline(xs):
        out, _ = lax.scan(body, jnp.uint32(0), xs)
        return out

    inputs = [make_input() for _ in range(TRIALS + 1)]
    rowlen = int(inputs[0][1].shape[-1])
    jax.block_until_ready(inputs)
    times = _timeit_fetch(pipeline, inputs, TRIALS)
    return [S * 2 * N / dt / 1e6 for dt in times]


def bench_count_e2e():
    """END-TO-END counting throughput: wall-clock `count_to_db` from a
    FASTQ file on disk to a decoded DB on disk — the number a user of
    `meryl count` gets.

    Input: 67 Mbases of 150 bp reads at 64x coverage of a 1 Mbase
    random genome.  Run 0 compiles (reported as cold_s); runs 1-3 are
    warm.  The counter's wire volumes and host<->device sync counters
    of the last run are reported alongside."""
    import shutil
    import tempfile

    from meryl_tpu.counter import LAST_WIRE_STATS, count_to_db

    G = 1 << 20
    rlen = 150
    nreads = (64 * G) // rlen
    bases = nreads * rlen

    with tempfile.TemporaryDirectory(prefix="meryl_bench_") as td:
        fq = os.path.join(td, "reads.fq")
        r = np.random.default_rng(42)
        genome = np.frombuffer(b"ACTG", np.uint8)[
            r.integers(0, 4, size=G)]
        starts = r.integers(0, G - rlen, size=nreads)
        with open(fq, "wb") as f:
            qual = b"I" * rlen
            for i, s in enumerate(starts):
                f.write(b"@r%d\n%s\n+\n%s\n"
                        % (i, genome[s:s + rlen].tobytes(), qual))
        times = []
        n_uniques = 0
        for rep in range(4):
            out = os.path.join(td, f"out_{rep}.meryl")
            t0 = time.perf_counter()
            db = count_to_db([fq], out, 21)
            times.append(time.perf_counter() - t0)
            n_uniques = len(db.load_all()[2])
            assert n_uniques > 0
            shutil.rmtree(out)
        in_bytes = os.path.getsize(fq)
    warm = sorted(times[1:])
    detail = {
        "bases": bases,
        "uniques": int(n_uniques),
        "cold_s": times[0],
        "warm_s": times[1:],
        "warm_median_s": warm[len(warm) // 2],
        "in_bytes": in_bytes,
        "wire_and_sync": dict(LAST_WIRE_STATS),
    }
    return bases / warm[0], detail


def bench_bam_ingest():
    """Host-side BAM -> 2-bit-code ingest rate (BASELINE.md workload:
    'BAM/CRAM counting'), Mbases/s through the native window scan.
    Pure host work — independent of the device link."""
    import gzip
    import struct
    import tempfile

    from meryl_tpu.io import bam

    rng = np.random.default_rng(3)
    n_reads, rlen = 30000, 150
    seqs = rng.integers(0, 4, size=(n_reads, rlen))
    code2nib = np.array([1, 2, 8, 4], np.uint8)  # ACTG -> SEQ16 nibble
    out = bytearray(b"BAM\x01")
    text = b"@HD\tVN:1.6\n"
    out += struct.pack("<i", len(text)) + text
    out += struct.pack("<i", 0)
    name = b"r\x00"
    for row in code2nib[seqs]:
        packed = ((row[0::2] << 4) | row[1::2]).astype(np.uint8).tobytes()
        rec = struct.pack("<iiBBHHHiiii", -1, -1, len(name), 0, 4680,
                          0, 4, rlen, -1, -1, 0)
        rec += name + packed + b"\xff" * rlen
        out += struct.pack("<i", len(rec)) + rec
    with tempfile.NamedTemporaryFile(suffix=".bam", delete=False) as f:
        with gzip.open(f, "wb", compresslevel=1) as g:
            g.write(bytes(out))
        path = f.name
    sum(len(c) for c in bam.iter_codes(path))  # warm page cache
    t0 = time.perf_counter()
    nc = sum(len(c) for c in bam.iter_codes(path))
    dt = time.perf_counter() - t0
    os.unlink(path)
    return (nc - n_reads) / dt / 1e6


def bench_cram_ingest():
    """Host-side CRAM -> 2-bit-code ingest rate (BASELINE.md workload:
    'BAM/CRAM counting'), Mbases/s through the container-parallel
    decoder.  Pure host work — independent of the device link."""
    import importlib.util
    import random
    import tempfile

    # the test suite's CRAM writer, loaded by path (an unrelated
    # installed package may own the name `tests`)
    spec = importlib.util.spec_from_file_location(
        "cram_writer", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests", "cram_writer.py"))
    cw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cw)

    from meryl_tpu.io import cram

    random.seed(5)
    n_reads, rlen = 200000, 150
    reads = [(f"r{i}", "".join(random.choices("ACGT", k=rlen)))
             for i in range(n_reads)]
    with tempfile.NamedTemporaryFile(suffix=".cram", delete=False) as f:
        path = f.name
    cw.write_unmapped_cram(path, reads, method=1,
                           reads_per_container=10000)
    sum(len(c) for c in cram.iter_cram_codes(path))  # warm page cache
    t0 = time.perf_counter()
    nc = sum(len(c) for c in cram.iter_cram_codes(path))
    dt = time.perf_counter() - t0
    os.unlink(path)
    return (nc - n_reads) / dt / 1e6


def main():
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX has {devs}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()

    best, trials = bench_counting()
    out = {
        "metric": "count_k21_canonical_throughput",
        "value": best,
        "unit": "bases/s",
        "trials_bases_per_s": trials,
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": card.splitlines(),
    }

    def _spread(field, rates):
        rs = sorted(float(r) for r in rates)
        out[field] = rs[-1]
        out[field + "_runs"] = list(rates)
        out[field + "_median"] = rs[len(rs) // 2]

    _spread("lookup_mqps", bench_lookup())
    mid = bench_lookup_midsize()
    if mid is None:
        raise RuntimeError("mid-size lookup: no grid geometry fits")
    _spread("lookup_midsize_mqps", mid[0])
    _spread("lookup_exists_mqps", mid[1])
    _spread("setop_union_sum_meps", bench_setop())
    rates, bdetail = bench_lookup_bigdb()
    _spread("lookup_bigdb_mqps", rates)
    out["lookup_bigdb_detail"] = bdetail
    _spread("v2_union_label_meps", bench_v2_action())
    rate, detail = bench_count_e2e()
    out["count_e2e_bases_s"] = rate
    out["count_e2e_detail"] = detail
    out["bam_ingest_mbases_s"] = bench_bam_ingest()
    out["cram_ingest_mbases_s"] = bench_cram_ingest()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
