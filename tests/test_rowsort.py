"""Row-batched chunk sorting (MERYL_TPU_ROWLEN): the device sorts a
chunk as independent rows (one long sort row is the slow shape) and
the host merge cascade
union-sums duplicates across rows.  Differential coverage vs the
1-row path and a brute-force dict."""

import numpy as np
import pytest

import meryl_tpu.kmer as km
from meryl_tpu.counter import count_to_arrays
from meryl_tpu.ops import count as cnt
from meryl_tpu.ops import extract as ext


def _brute(seq, k):
    counts = {}
    for i in range(len(seq) - k + 1):
        w = seq[i:i + k]
        if any(c not in "ACGT" for c in w):
            continue
        f = km.string_to_kmer(w)
        r = km.string_to_kmer(km.revcomp_string(w))
        counts[min(f, r)] = counts.get(min(f, r), 0) + 1
    return counts


@pytest.mark.parametrize("k", [5, 21, 33])
def test_sort_starts_rowlen_matches_flat(k):
    rng = np.random.default_rng(11)
    L, rowlen = 2048, 256
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    codes[rng.integers(0, L, size=17)] = 255  # invalid sprinkle
    import jax.numpy as jnp
    planes, valid = ext.extract_kmers(jnp.asarray(codes), k, "canonical")

    sp_f, st_f, inv_f = cnt.sort_starts(planes, valid)
    pf, cf, _ = cnt.host_rle_finish([np.asarray(p) for p in sp_f],
                                    np.asarray(st_f), int(inv_f))
    flat = {}
    hi, lo = km.hilo_from_planes(pf)
    for h, l, c in zip(hi, lo, cf):
        flat[(int(h) << 64) | int(l)] = int(c)

    sp_r, st_r, inv_r = cnt.sort_starts(planes, valid, rowlen)
    pr, cr, idx = cnt.host_rle_finish([np.asarray(p) for p in sp_r],
                                      np.asarray(st_r),
                                      np.asarray(inv_r), rowlen)
    hi, lo = km.hilo_from_planes(pr)
    rowed = {}
    for h, l, c in zip(hi, lo, cr):
        key = (int(h) << 64) | int(l)
        rowed[key] = rowed.get(key, 0) + int(c)
    assert rowed == flat
    # per-row output must be sorted within each row
    rows = L // rowlen
    cuts = np.searchsorted(idx, np.arange(1, rows) * rowlen)
    prev = 0
    for cut in list(cuts) + [len(cr)]:
        h, l = hi[prev:cut], lo[prev:cut]
        if len(h) > 1:
            key = (h.astype(object) * (1 << 64)) + l.astype(object)
            assert (key[1:] > key[:-1]).all()
        prev = cut


def test_count_to_arrays_with_rowlen(monkeypatch, tmp_path):
    monkeypatch.setenv("MERYL_TPU_ROWLEN", "256")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    rng = np.random.default_rng(5)
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, size=3000))
    seq = seq[:700] + "NN" + seq[700:]
    fa = tmp_path / "r.fa"
    fa.write_text(f">r\n{seq}\n")
    k = 21
    hi, lo, counts = count_to_arrays([str(fa)], k, chunk_len=1024)
    got = {(int(h) << 64) | int(l): int(c)
           for h, l, c in zip(hi, lo, counts)}
    assert got == _brute(seq, k)
    # globally sorted unique
    key = (hi.astype(object) * (1 << 64)) + lo.astype(object)
    assert (key[1:] > key[:-1]).all()


def test_rowlen_all_invalid_rows(monkeypatch, tmp_path):
    """Rows that are entirely separator/invalid must vanish."""
    monkeypatch.setenv("MERYL_TPU_ROWLEN", "128")
    monkeypatch.setenv("MERYL_TPU_SHARDED", "0")
    fa = tmp_path / "r.fa"
    # one short read -> the tail of the chunk is all separator
    fa.write_text(">r\n" + "ACGTACGTACGTACGTACGTACGT" + "\n")
    hi, lo, counts = count_to_arrays([str(fa)], 9, chunk_len=512)
    got = {(int(h) << 64) | int(l): int(c)
           for h, l, c in zip(hi, lo, counts)}
    assert got == _brute("ACGTACGTACGTACGTACGTACGT", 9)
