"""meryl2-namespace tool ports: import with labels, lookup/analyze/
simple over label-carrying DBs (reference src/meryl2-*/)."""

import io
import contextlib
import subprocess
import sys
import os

import numpy as np

from meryl_tpu import kmer as km
from meryl_tpu.db import MerylDB
from meryl_tpu.tools import import_tool

K = 9
BIN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bin")


def test_import_labels_and_persistent_lines(tmp_path):
    kf = tmp_path / "k.txt"
    kf.write_text(
        "value=5\n"
        "label=0x3\n"
        "AAAAAAAAC\n"            # -> value 5, label 3
        "AAAAAAAAG 7\n"          # -> value 7, label 3
        "AAAAAAAGG 2 0x9\n"      # -> value 2, label 9
        "AAAAAAAAC 1 0x4\n"      # dup: values sum, labels OR
    )
    out = str(tmp_path / "l.meryl")
    rc = import_tool.main(["-k", str(K), "-kmers", str(kf), "-output",
                           out, "-forward", "-labelwidth", "8"])
    assert rc == 0
    db = MerylDB.open(out)
    assert db.meta["labelBits"] == 8
    got = {}
    for ff in range(64):
        hi, lo, c, lab = db.load_bucket_labels(ff)
        for h, l, v, lb in zip(hi, lo, c,
                               lab if lab is not None else [0] * len(c)):
            s = km.kmer_to_string((int(h) << 64) | int(l), K)
            got[s] = (int(v), int(lb))
    assert got == {"AAAAAAAAC": (6, 3 | 4),
                   "AAAAAAAAG": (7, 3),
                   "AAAAAAAGG": (2, 9)}


def test_meryl2_import_bin_exists():
    for t in ("meryl2-import", "meryl2-lookup", "meryl2-analyze",
              "meryl2-simple"):
        p = os.path.join(BIN, t)
        assert os.path.exists(p) and os.access(p, os.X_OK), t


def test_meryl2_lookup_on_label_db(tmp_path):
    """Labels ride transparently through the lookup engine."""
    kf = tmp_path / "k.txt"
    kf.write_text("AAAAAAAAC 4 1\nAAAAAAAAG 2 2\n")
    dbp = str(tmp_path / "x.meryl")
    assert import_tool.main(["-k", str(K), "-kmers", str(kf), "-output",
                             dbp, "-forward", "-labelwidth", "4"]) == 0
    fa = tmp_path / "q.fa"
    fa.write_text(">q\nAAAAAAAACG\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(BIN, "meryl2-lookup"),
         "-existence", "-sequence", str(fa), "-mers", dbp],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    # q has 2 9-mers; AAAAAAAAC is present in the db
    line = r.stdout.strip().split("\n")[-1]
    fields = line.split("\t")
    assert fields[0] == "q"
    assert int(fields[1]) == 2
