"""Independent end-to-end verification of meryl_tpu (single process).

Drives the real CLI surface (cli.main) and the library on the current
backend (the GPU by default), comparing decoded output against an
inline brute-force counter that is independent of meryl_tpu.oracle.

Run: python scripts/verify_e2e.py [--big] [--cpu]
  --big  production chunk/rowlen shapes (6 Mbases + out-of-core
         batched equality) instead of the small probes
  --cpu  run on the CPU backend (no card needed)
This is the /verify recipe as a script; keep it runnable."""
import contextlib
import gzip
import io
import os
import sys
import tempfile
from collections import Counter

BIG = "--big" in sys.argv
if not BIG:
    # small probes: tiny chunk keeps first-compile time down.  --big
    # runs the PRODUCTION chunk/rowlen instead (no env override) so
    # hardware verification also covers the real device program.
    os.environ["MERYL_TPU_CHUNK"] = str(1 << 15)
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    # run the whole verification on the CPU backend: the config call
    # wins over any JAX_PLATFORMS set from outside
    import jax
    jax.config.update("jax_platforms", "cpu")

from meryl_tpu import cli  # noqa: E402

CODE = {"A": 0, "C": 1, "T": 2, "G": 3, "a": 0, "c": 1, "t": 2, "g": 3}
ALPHA = "ACTG"
failures = []


def brute_count(seqs, k):
    counts = {}
    for s in seqs:
        run = 0
        v = 0
        mask = (1 << (2 * k)) - 1
        for ch in s:
            c = CODE.get(ch)
            if c is None:
                run = 0
                v = 0
                continue
            v = ((v << 2) | c) & mask
            run += 1
            if run >= k:
                r = 0
                t = v
                for _ in range(k):
                    r = (r << 2) | ((t & 3) ^ 2)
                    t >>= 2
                can = v if v < r else r
                counts[can] = counts.get(can, 0) + 1
    return counts


def kmer_str(v, k):
    return "".join(ALPHA[(v >> (2 * (k - 1 - i))) & 3] for i in range(k))


def run_cli(args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = cli.main(args)
        except SystemExit as e:
            rc = e.code
        except Exception as e:
            return 99, f"EXC: {e!r}"
    return rc, out.getvalue()


def main():
    tmp = tempfile.mkdtemp(prefix="meryl_verify_")
    seqs = [
        "ACGTACGTGGTAGCTAGCTACGATCGATCGTAGCTAGCTAGCATCGATCGATGCTAGCTAGCATGC",
        "GGGGGGGGGGGGGGGGGGGGGGGGGGGGGGGG",
        "ACGTNNNNACGTACGTACGTTTTTACGCGCGCATATATATCGCGG",
        "TTTTTTTTTTTTTTTTTACGATCGATCGAGCGAGCGATCGTACGTACG",
    ]
    fa = os.path.join(tmp, "reads.fa")
    with open(fa, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">r{i}\n")
            for j in range(0, len(s), 20):
                f.write(s[j:j + 20] + "\n")
    fagz = os.path.join(tmp, "reads.fa.gz")
    with open(fa, "rb") as f, gzip.open(fagz, "wb") as g:
        g.write(f.read())

    for k, src in [(16, fa), (21, fa), (21, fagz), (33, fa)]:
        db = os.path.join(tmp, f"out_k{k}_{os.path.basename(src)}.meryldb")
        rc, _ = run_cli([f"k={k}", "count", src, "output", db])
        if rc != 0:
            failures.append(f"count k={k} {src}: rc={rc}")
            continue
        rc, out = run_cli(["print", db])
        if rc != 0:
            failures.append(f"print k={k}: rc={rc} {out[-300:]}")
            continue
        got = {}
        for line in out.strip().split("\n"):
            if not line:
                continue
            s, v = line.split("\t")
            vv = 0
            for ch in s:
                vv = (vv << 2) | CODE[ch]
            got[vv] = int(v)
        want = brute_count(seqs, k)
        if got != want:
            miss = {kmer_str(x, k): want[x] for x in want if x not in got}
            extra = {kmer_str(x, k): got[x] for x in got if x not in want}
            diff = {kmer_str(x, k): (got[x], want[x])
                    for x in got if x in want and got[x] != want[x]}
            failures.append(f"k={k} src={os.path.basename(src)}: "
                            f"missing={miss} extra={extra} diff={diff}")
        else:
            print(f"OK k={k} src={os.path.basename(src)}: {len(got)} kmers "
                  f"match brute force", flush=True)

    db21 = os.path.join(tmp, "out_k21_reads.fa.meryldb")
    want = brute_count(seqs, 21)
    rc, out = run_cli(["histogram", db21])
    ghist = {int(v): int(o) for v, o in
             (l.split("\t") for l in out.strip().split("\n"))}
    whist = dict(Counter(want.values()))
    if ghist != whist:
        failures.append(f"histogram mismatch {ghist} != {whist}")
    else:
        print("OK histogram matches", flush=True)
    rc, out = run_cli(["statistics", db21])
    if str(len(want)) not in out:
        failures.append("statistics: distinct count absent")
    else:
        print("OK statistics", flush=True)

    # union-sum of a DB with itself = doubled counts
    u = os.path.join(tmp, "u.meryldb")
    rc, _ = run_cli(["union-sum", db21, db21, "output", u])
    rc, out = run_cli(["print", u])
    got = {}
    for line in out.strip().split("\n"):
        s, v = line.split("\t")
        vv = 0
        for ch in s:
            vv = (vv << 2) | CODE[ch]
        got[vv] = int(v)
    if got != {x: 2 * v for x, v in want.items()}:
        failures.append("union-sum self-doubling mismatch")
    else:
        print("OK union-sum", flush=True)

    # error probes
    rc, _ = run_cli(["k=65", "count", fa, "output", os.path.join(tmp, "bad")])
    if rc == 0:
        failures.append("k=65 should fail")
    else:
        print("OK k=65 rejected", flush=True)

    empty = os.path.join(tmp, "empty.fa")
    open(empty, "w").close()
    rc, _ = run_cli(["k=21", "count", empty, "output",
                     os.path.join(tmp, "e.meryldb")])
    if rc != 0:
        failures.append(f"empty input rc={rc}")
    else:
        print("OK empty input", flush=True)

    alln = os.path.join(tmp, "alln.fa")
    with open(alln, "w") as f:
        f.write(">n\nNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNN\n")
    rc, _ = run_cli(["k=21", "count", alln, "output",
                     os.path.join(tmp, "n.meryldb")])
    rc2, out = run_cli(["print", os.path.join(tmp, "n.meryldb")])
    if rc != 0 or out.strip():
        failures.append("all-N handling wrong")
    else:
        print("OK all-N -> zero kmers", flush=True)

    # count-suffix: only kmers ending in the suffix
    db_sfx = os.path.join(tmp, "sfx.meryldb")
    rc, _ = run_cli(["k=16", "count", "count-suffix=GT", fa, "output", db_sfx])
    rc2, out = run_cli(["print", db_sfx])
    want16 = brute_count(seqs, 16)
    want_sfx = {x: v for x, v in want16.items()
                if kmer_str(x, 16).endswith("GT")}
    got = {}
    for line in out.strip().split("\n"):
        if not line:
            continue
        s, v = line.split("\t")
        vv = 0
        for ch in s:
            vv = (vv << 2) | CODE[ch]
        got[vv] = int(v)
    if got != want_sfx:
        failures.append(f"count-suffix mismatch: {len(got)} vs {len(want_sfx)}")
    else:
        print(f"OK count-suffix ({len(got)} kmers)", flush=True)

    # meryl2: union with OR'd labels over two single-label DBs
    from meryl_tpu.v2 import cli as v2cli
    db_a = os.path.join(tmp, "v2a.meryldb")
    db_b = os.path.join(tmp, "v2b.meryldb")
    out21 = os.path.join(tmp, "out_k21_reads.fa.meryldb")

    def run_v2(args):
        out_io = io.StringIO()
        with contextlib.redirect_stdout(out_io):
            rc = v2cli.main(args)
        return rc, out_io.getvalue()

    rc, _ = run_v2(["-k", "21", "count", "label=#1",
                    fa, f"output:database={db_a}"])
    rc2, _ = run_v2(["-k", "21", "count", "label=#2",
                     fa, f"output:database={db_b}"])
    rc3, out = run_v2(["union", "o:show", db_a, db_b])
    ok = rc == 0 and rc2 == 0 and rc3 == 0
    want21 = brute_count(seqs, 21)
    n_ok = 0
    for line in out.strip().split("\n"):
        s, v, lab = line.split("\t")
        vv = 0
        for ch in s:
            vv = (vv << 2) | CODE[ch]
        if vv in want21 and int(v) == 2 and int(lab) == 3:
            n_ok += 1
        else:
            ok = False
    if not ok or n_ok != len(want21):
        failures.append(f"meryl2 union/labels mismatch ({n_ok}/{len(want21)})")
    else:
        print(f"OK meryl2 union with labels ({n_ok} kmers)", flush=True)

    if failures:
        print("\nFAILURES:")
        for f_ in failures:
            print(" -", f_)
        sys.exit(1)
    print("\nALL VERIFICATION PROBES PASSED", flush=True)


def brute_count_rolling(seqs, k):
    """O(1)-per-base brute force (rolling fwd+rev) for the big probe —
    independent of meryl_tpu (and of brute_count above)."""
    counts = {}
    mask = (1 << (2 * k)) - 1
    top = 2 * (k - 1)
    for s in seqs:
        fwd = rev = run = 0
        for ch in s:
            c = CODE.get(ch)
            if c is None:
                fwd = rev = run = 0
                continue
            fwd = ((fwd << 2) | c) & mask
            rev = (rev >> 2) | ((c ^ 2) << top)
            run += 1
            if run >= k:
                can = fwd if fwd < rev else rev
                counts[can] = counts.get(can, 0) + 1
    return counts


def main_big():
    """Production-scale probe: count ~6 Mbases at the PRODUCTION chunk
    size (2^22) and rowlen on the current backend, decode the DB, and
    compare against the rolling brute force; then re-count with a tiny
    memory= bound to force the out-of-core batched path and assert the
    two DBs decode identically."""
    import numpy as np
    from meryl_tpu.db import MerylDB

    k = 21
    rng = np.random.default_rng(42)
    tmp = tempfile.mkdtemp(prefix="meryl_verify_big_")
    seqs = []
    for i in range(3):
        arr = rng.integers(0, 4, size=2_000_000)
        s = "".join("ACTG"[b] for b in arr)
        # sprinkle N breaks and a poly-G stretch to hit breakers and
        # the near-sentinel key range at production shapes
        s = s[:500_000] + "N" + s[500_000:1_200_000] + "G" * 40 + s[1_200_000:]
        seqs.append(s)
    fa = os.path.join(tmp, "big.fa")
    with open(fa, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">r{i}\n{s}\n")

    db = os.path.join(tmp, "big.meryldb")
    rc, out = run_cli([f"k={k}", "count", fa, "output", db])
    if rc != 0:
        failures.append(f"big count rc={rc}: {out[-300:]}")
    else:
        hi, lo, counts = MerylDB.open(db).load_all()
        got = {(int(h) << 64) | int(l): int(c)
               for h, l, c in zip(hi, lo, counts)}
        want = brute_count_rolling(seqs, k)
        if got == want:
            print(f"OK big probe: {len(got)} kmers at production chunk "
                  f"match rolling brute force", flush=True)
        else:
            nmiss = sum(1 for x in want if x not in got)
            nextra = sum(1 for x in got if x not in want)
            ndiff = sum(1 for x in got
                        if x in want and got[x] != want[x])
            failures.append(f"big probe mismatch: missing={nmiss} "
                            f"extra={nextra} diff={ndiff}")

        db2 = os.path.join(tmp, "big_batched.meryldb")
        rc, out = run_cli([f"k={k}", "memory=0.05", "count", fa,
                           "output", db2])
        if rc != 0:
            failures.append(f"big batched count rc={rc}: {out[-300:]}")
        else:
            hi2, lo2, c2 = MerylDB.open(db2).load_all()
            if (len(c2) == len(counts) and (hi2 == hi).all()
                    and (lo2 == lo).all() and (c2 == counts).all()):
                print("OK big batched (memory=0.05) == single-batch DB",
                      flush=True)
            else:
                failures.append("big batched DB != single-batch DB")

    if failures:
        print("\nFAILURES:")
        for f_ in failures:
            print(" -", f_)
        sys.exit(1)
    print("\nBIG VERIFICATION PROBES PASSED", flush=True)


if __name__ == "__main__":
    main_big() if BIG else main()
