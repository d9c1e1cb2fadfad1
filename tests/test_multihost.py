"""Multi-host (multi-process) counting: the launcher spawns a real
2-process jax.distributed job (gloo collectives on a virtual CPU mesh,
4 devices per process) driving the PRODUCT CLI; the assembled DB must
decode identically to a single-process count of the same input.

This is the code-level test of SURVEY §2.5 P6 / §5 "distributed
communication backend" — cross-process collectives + shared-filesystem
DB assembly, not just a single-process mesh."""

import os
import subprocess
import sys

import numpy as np
import pytest

from meryl_tpu.db import MerylDB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_reads(path, rng, n_reads=10, length=400):
    bases = "ACGT"
    with open(path, "w") as f:
        for i in range(n_reads):
            seq = "".join(bases[b] for b in rng.integers(0, 4, size=length))
            # embed an N run in some reads to exercise breakers
            if i % 3 == 0:
                seq = seq[:50] + "NNN" + seq[53:]
            f.write(f">r{i}\n{seq}\n")


@pytest.mark.slow
@pytest.mark.parametrize("nprocs,dpp", [(2, 4), (4, 2)])
def test_multihost_cli_count_matches_single(tmp_path, nprocs, dpp):
    rng = np.random.default_rng(42)
    fa = str(tmp_path / "reads.fa")
    _write_reads(fa, rng)
    db_mh = str(tmp_path / "mh.meryldb")
    db_1 = str(tmp_path / "single.meryldb")

    env = dict(os.environ)
    env["MERYL_TPU_CHUNK"] = "512"
    env.pop("MERYL_TPU_COORD", None)
    # children run on virtual CPU devices, never on a real card
    env["JAX_PLATFORMS"] = "cpu"

    # 2-process distributed job through the launcher + product CLI
    r = subprocess.run(
        [sys.executable, "-m", "meryl_tpu.parallel.launch",
         "--nprocs", str(nprocs), "--devices-per-proc", str(dpp),
         "--",
         "count", "k=21", fa, "output", db_mh],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"

    # single-process reference (forced non-distributed, sharded off)
    env1 = dict(env)
    env1["MERYL_TPU_SHARDED"] = "0"
    r1 = subprocess.run(
        [sys.executable, "-m", "meryl_tpu",
         "count", "k=21", fa, "output", db_1],
        env=env1, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r1.returncode == 0, f"stdout={r1.stdout}\nstderr={r1.stderr}"

    hi_m, lo_m, c_m = MerylDB.open(db_mh).load_all()
    hi_1, lo_1, c_1 = MerylDB.open(db_1).load_all()
    assert len(c_m) == len(c_1)
    assert (hi_m == hi_1).all() and (lo_m == lo_1).all()
    assert (c_m == c_1).all()

    # stored stats/histogram must match too (assembled from parts)
    s_m = MerylDB.open(db_mh).stats()
    s_1 = MerylDB.open(db_1).stats()
    assert s_m == s_1
    hv_m, ho_m = MerylDB.open(db_mh).histogram()
    hv_1, ho_1 = MerylDB.open(db_1).histogram()
    assert hv_m.tolist() == hv_1.tolist()
    assert ho_m.tolist() == ho_1.tolist()
    # no leftover part dir
    assert not os.path.exists(db_mh + ".mhparts")


@pytest.mark.slow
def test_multihost_uneven_input_keepalive(tmp_path):
    """One process's sequence-modulo segment is EMPTY (a single long
    sequence, 2 processes): the separator-padded keep-alive shards
    (multihost.count_to_arrays_multihost's exhausted-process loop) are
    the only thing standing between this shape and a collective
    deadlock.  Asserts the per-process read counts really were unequal
    (proc 1 read zero bases) and the result still decodes exactly."""
    rng = np.random.default_rng(7)
    fa = str(tmp_path / "one_seq.fa")
    bases = "ACGT"
    seq = "".join(bases[b] for b in rng.integers(0, 4, size=6000))
    with open(fa, "w") as f:
        f.write(f">only\n{seq}\n")
    db_mh = str(tmp_path / "mh.meryldb")
    db_1 = str(tmp_path / "single.meryldb")

    dbg = str(tmp_path / "mhdebug")
    env = dict(os.environ)
    env["MERYL_TPU_CHUNK"] = "512"   # many steps for proc 0, zero
    env["MERYL_TPU_MH_DEBUG"] = dbg  # for proc 1 -> all keep-alive
    env.pop("MERYL_TPU_COORD", None)
    env["JAX_PLATFORMS"] = "cpu"

    r = subprocess.run(
        [sys.executable, "-m", "meryl_tpu.parallel.launch",
         "--nprocs", "2", "--devices-per-proc", "2", "--",
         "count", "k=21", fa, "output", db_mh],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"

    # the per-process debug files prove the split really was uneven:
    # the modulo segmenting gives the single sequence to process 0 and
    # nothing to process 1, which fed only separator-padded keep-alives
    import json
    reads = {}
    for fn in os.listdir(dbg):
        with open(os.path.join(dbg, fn)) as f:
            j = json.load(f)
        reads[j["proc"]] = j["read_bases"]
    assert set(reads) == {0, 1}, reads
    assert reads[0] >= len(seq)  # chunker halo overlap can add bases
    assert reads[1] == 0

    env1 = dict(env)
    env1["MERYL_TPU_SHARDED"] = "0"
    r1 = subprocess.run(
        [sys.executable, "-m", "meryl_tpu",
         "count", "k=21", fa, "output", db_1],
        env=env1, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r1.returncode == 0, f"stdout={r1.stdout}\nstderr={r1.stderr}"

    hi_m, lo_m, c_m = MerylDB.open(db_mh).load_all()
    hi_1, lo_1, c_1 = MerylDB.open(db_1).load_all()
    assert len(c_m) == len(c_1)
    assert (hi_m == hi_1).all() and (lo_m == lo_1).all()
    assert (c_m == c_1).all()


def test_stream_sorted_parts_matches_bulk_write(tmp_path):
    """db.stream_sorted_parts (piece-at-a-time, straddling 6-bit file
    boundaries) writes a DB decode-identical to MerylDB.write of the
    concatenated arrays."""
    import numpy as np

    from meryl_tpu import kmer as km
    from meryl_tpu.db import MerylDB, stream_sorted_parts

    K = 21
    rng = np.random.default_rng(9)
    kk = np.unique(rng.integers(0, 1 << (2 * K), size=5000,
                                dtype=np.uint64))
    hi = np.zeros(len(kk), np.uint64)
    c = rng.integers(1, 50, size=len(kk)).astype(np.uint32)

    p_bulk = str(tmp_path / "bulk.meryl")
    MerylDB.write(p_bulk, K, hi, kk, c)

    # cut into uneven pieces that straddle bucket boundaries
    cuts = [0, 7, 8, 1203, 1204, 4000, len(kk)]
    parts = [(hi[a:b], kk[a:b], c[a:b]) for a, b in zip(cuts, cuts[1:])]
    p_str = str(tmp_path / "stream.meryl")
    stream_sorted_parts(p_str, K, iter(parts))

    a = MerylDB.open(p_bulk)
    b = MerylDB.open(p_str)
    for x, y in zip(a.load_all(), b.load_all()):
        assert (x == y).all()
    assert a.stats() == b.stats()
    av, ao = a.histogram()
    bv, bo = b.histogram()
    assert (av == bv).all() and (ao == bo).all()
