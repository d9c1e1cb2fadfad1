"""Differential tests for the device-accumulator counting path
(ops/accum.py + counter.DeviceAccCounter) against an inline brute
force, including the all-ones-kmer scalar, cell-overflow fallback,
accumulator regrowth, and multi-chunk merges."""

import numpy as np
import pytest

from meryl_tpu import counter
from meryl_tpu import kmer as km

COMP = {"A": "T", "C": "G", "T": "A", "G": "C"}


def _brute(seqs, k, mode="canonical"):
    out = {}
    for s in seqs:
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            if any(ch not in "ACGT" for ch in w):
                continue
            f = km.string_to_kmer(w)
            if mode == "canonical":
                rc = km.string_to_kmer(
                    "".join(COMP[ch] for ch in reversed(w)))
                f = min(f, rc)
            elif mode == "reverse":
                f = km.string_to_kmer(
                    "".join(COMP[ch] for ch in reversed(w)))
            out[f] = out.get(f, 0) + 1
    return out


def _write_fa(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n{s}\n")


def _count_acc(tmp_path, seqs, k, mode="canonical", chunk_len=1 << 15,
               monkeypatch=None, expected=None):
    fa = str(tmp_path / "in.fa")
    _write_fa(fa, seqs)
    exp = expected
    if exp is None:
        exp = counter._use_device_acc(None, [fa], k, chunk_len)
        assert exp > 0
    hi, lo, c = counter.count_to_arrays_device_acc(
        [fa], k, mode=mode, hpc=False, chunk_len=chunk_len,
        expected_uniques=exp)
    return {(int(h) << 64) | int(l): int(v)
            for h, l, v in zip(hi, lo, c)}


def _rand_seqs(rng, n, ln):
    return ["".join("ACTG"[c] for c in rng.integers(0, 4, size=ln))
            for _ in range(n)]


@pytest.fixture(autouse=True)
def force_acc(monkeypatch):
    monkeypatch.setenv("MERYL_TPU_DEVICE_ACC", "1")


@pytest.mark.parametrize("k,mode", [(21, "canonical"), (15, "forward"),
                                    (33, "canonical"), (9, "reverse")])
def test_acc_matches_brute(tmp_path, k, mode):
    rng = np.random.default_rng(21)
    # duplicated reads -> real accumulation across chunks
    base = _rand_seqs(rng, 40, 300)
    seqs = base * 3 + _rand_seqs(rng, 30, 200)
    got = _count_acc(tmp_path, seqs, k, mode=mode)
    assert got == _brute(seqs, k, mode)


def test_acc_allones_kmer(tmp_path):
    """k=16 poly-G forward counting: the all-ones kmer must come from
    the device scalar, not the sentinel-aliased cells."""
    rng = np.random.default_rng(5)
    seqs = _rand_seqs(rng, 20, 200) + ["G" * 40, "G" * 16]
    got = _count_acc(tmp_path, seqs, 16, mode="forward")
    want = _brute(seqs, 16, "forward")
    assert got == want
    allones = (1 << 32) - 1
    assert got[allones] == want[allones] == 26


def test_acc_allones_not_doubled_by_host_fallback(tmp_path):
    """A chunk that trips the host-recount fallback (poly-A cell
    overflow > OVF_CAP) AND contains all-ones kmers (poly-G, k=16
    forward): the host recount counts the all-ones kmer itself, so the
    chunk's device n_allones scalar must be dropped, not committed
    (advisor round-3 high finding)."""
    seqs = ["A" * 5000, "G" * 40]
    got = _count_acc(tmp_path, seqs, 16, mode="forward",
                     chunk_len=1 << 13)
    want = _brute(seqs, 16, "forward")
    assert got == want
    allones = (1 << 32) - 1
    assert got[allones] == 25  # 40 - 16 + 1, not doubled


def test_acc_overflow_fallback(tmp_path):
    """Poly-A input routes every window to one bucket cell: the chunk
    must overflow and be recounted exactly on the host path."""
    seqs = ["A" * 5000, "A" * 3000]
    got = _count_acc(tmp_path, seqs, 21, mode="forward",
                     chunk_len=1 << 13)
    want = _brute(seqs, 21, "forward")
    assert got == want  # one kmer, count 4960+2980


def test_acc_regrow(tmp_path):
    """A deliberately tiny expected-uniques forces La regrowth."""
    rng = np.random.default_rng(7)
    seqs = _rand_seqs(rng, 60, 400)
    got = _count_acc(tmp_path, seqs, 21, chunk_len=1 << 14,
                     expected=64)  # La0 = 2048 floor; still multi-merge
    assert got == _brute(seqs, 21, "canonical")


def test_acc_with_n_bases(tmp_path):
    rng = np.random.default_rng(9)
    seqs = ["ACGTNNACGTACGTACGTACGTTTTGCA" * 8,
            *_rand_seqs(rng, 10, 150)]
    got = _count_acc(tmp_path, seqs, 11)
    assert got == _brute(seqs, 11)


def test_acc_multi_chunk_merges(tmp_path):
    """Enough chunks to trigger several M-cadence merges."""
    rng = np.random.default_rng(13)
    seqs = _rand_seqs(rng, 200, 500)
    got = _count_acc(tmp_path, seqs, 21, chunk_len=1 << 13)
    assert got == _brute(seqs, 21)


def test_acc_overflow_capture(tmp_path):
    """A few hundred overflow windows (one hot cell, below OVF_CAP)
    take the capture path, not the whole-chunk fallback."""
    rng = np.random.default_rng(31)
    # ~1830 identical kmers + ~525 random ones overflow one
    # ~2187-capacity cell by ~170 windows (< OVF_CAP)
    seqs = ["A" * 1850] + _rand_seqs(rng, 30, 300)
    fa = str(tmp_path / "in.fa")
    _write_fa(fa, seqs)
    exp = counter._use_device_acc(None, [fa], 21, 1 << 15)
    acc = counter.DeviceAccCounter(21, "canonical", 1 << 15, exp)
    from meryl_tpu.io.sequence import SequenceChunker
    for chunk in SequenceChunker([fa], 21, 1 << 15):
        acc.add_codes(chunk)
    hi, lo, c = acc.finalize()
    assert not acc._fallback_runs          # capture, not full fallback
    assert acc._ovf_planes                 # capture path tripped
    got = {(int(h) << 64) | int(l): int(v)
           for h, l, v in zip(hi, lo, c)}
    assert got == _brute(seqs, 21, "canonical")


def test_acc_capacity_salvage(tmp_path, monkeypatch):
    """A tiny HBM budget forces AccCapacity mid-run; the salvage path
    must still produce exact counts (device state + host finish)."""
    monkeypatch.setenv("MERYL_TPU_ACC_CAP_GB", "0.000002")  # ~2 KB
    rng = np.random.default_rng(17)
    seqs = _rand_seqs(rng, 80, 400)
    got = _count_acc(tmp_path, seqs, 21, chunk_len=1 << 13, expected=64)
    assert got == _brute(seqs, 21, "canonical")


def test_route_capture_clean_on_fully_valid_row():
    """Round-4 regression: a routing row with NO invalid windows made
    the fixed-iteration bucket searchsorted diverge past the row end
    (clamped read keeps reporting less once lo == hi == L0), which
    overcounted the LAST bucket, shorted the pad fill by one, slid one
    overflow window into the cells and one sentinel pad into the
    capture — the --big phantom sentinel kmer.  A k-periodic region
    (no breakers) overflows one cell per rotation while keeping every
    window valid."""
    import jax.numpy as jnp

    from meryl_tpu import counter as ctr
    from meryl_tpu.ops import accum

    k = 21
    chunk_len = 1 << 17
    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, size=chunk_len).astype(np.uint8)
    hot = rng.integers(0, 4, size=k).astype(np.uint8)
    c = ctr.DeviceAccCounter(k, "canonical", chunk_len, 1 << 17)
    # plant exactly enough copies of ONE hot kmer to overflow its
    # cell by ~120 (capture-sized): measure the background occupancy
    # of the hot kmer's bucket first, then top it past the cap.  k
    # random spacer bases between copies keep every boundary window
    # unique and VALID (no breakers -> the all-less searchsorted path)
    from meryl_tpu.ops import extract as _ext
    bits, B = c.cfg[7], c.cfg[3]
    pl, vl = _ext.extract_kmers(jnp.asarray(base), k, "canonical")
    rows_bg = np.asarray(jnp.where(
        vl, accum.row_from_prefix_int(
            accum._top_bits(pl, k, bits).astype(jnp.uint32), bits, B,
            True), B))
    hotpl, _ = _ext.extract_kmers(jnp.asarray(
        np.concatenate([hot, np.full(1, 9, np.uint8)])), k,
        "canonical")
    hrow = int(np.asarray(accum.row_from_prefix_int(
        accum._top_bits(hotpl, k, bits).astype(jnp.uint32), bits, B,
        True))[0])
    bg = int((rows_bg[: c.cfg[5]] == hrow).sum())
    copies = max(60, c.cfg[6] - bg + 120)
    period = np.empty((copies, 2 * k), np.uint8)
    period[:, :k] = hot
    period[:, k:] = rng.integers(0, 4, size=(copies, k))
    period = period.reshape(-1)
    base[: len(period)] = period
    cells, ovf, n_ovf_row, n_allones = accum.route_chunk(
        jnp.asarray(base), c.cfg)
    nrow = np.asarray(n_ovf_row)
    assert nrow.max() > 0, "test must actually overflow a cell"
    assert nrow.max() <= accum.OVF_CAP, "overflow must fit the capture"
    ovf_np = [np.asarray(p) for p in ovf]
    for r in np.flatnonzero(nrow):
        n = int(nrow[r])
        sent = np.logical_and.reduce(
            [p[r, :min(n, p.shape[1])] == 0xFFFFFFFF for p in ovf_np])
        assert not sent.any(), (
            f"sentinel padding captured as overflow in row {r}")


def test_acc_decode_exact_with_overflow_no_breakers():
    """Engine-level: the same shape through the full counter must
    decode exactly (no phantom sentinel key, no lost counts)."""
    from meryl_tpu import counter as ctr

    k = 21
    chunk_len = 1 << 17
    rng = np.random.default_rng(8)
    base = rng.integers(0, 4, size=chunk_len).astype(np.uint8)
    hot = rng.integers(0, 4, size=k).astype(np.uint8)
    c = ctr.DeviceAccCounter(k, "canonical", chunk_len, 1 << 17)
    from meryl_tpu.ops import accum as _accum
    from meryl_tpu.ops import extract as _ext
    import jax.numpy as jnp
    bits, B = c.cfg[7], c.cfg[3]
    pl, vl = _ext.extract_kmers(jnp.asarray(base), k, "canonical")
    rows_bg = np.asarray(jnp.where(
        vl, _accum.row_from_prefix_int(
            _accum._top_bits(pl, k, bits).astype(jnp.uint32), bits, B,
            True), B))
    hotpl, _ = _ext.extract_kmers(jnp.asarray(
        np.concatenate([hot, np.full(1, 9, np.uint8)])), k,
        "canonical")
    hrow = int(np.asarray(_accum.row_from_prefix_int(
        _accum._top_bits(hotpl, k, bits).astype(jnp.uint32), bits, B,
        True))[0])
    bg = int((rows_bg[: c.cfg[5]] == hrow).sum())
    copies = max(60, c.cfg[6] - bg + 120)
    period = np.empty((copies, 2 * k), np.uint8)
    period[:, :k] = hot
    period[:, k:] = rng.integers(0, 4, size=(copies, k))
    period = period.reshape(-1)
    base[: len(period)] = period
    c.add_codes(base)
    hi, lo, cts = c.finalize()
    assert int(lo.max()) < (1 << (2 * k)), "phantom sentinel key"
    # brute force
    want = {}
    run = 0
    v = 0
    r = 0
    mask = (1 << (2 * k)) - 1
    rc_of = lambda x: int.from_bytes(
        bytes(reversed([((x >> (2 * i)) & 3) ^ 2
                        for i in range(k)])), "big") if False else None
    # canonical brute: fwd value + rc via per-window recompute
    def rc(x):
        y = 0
        for _ in range(k):
            y = (y << 2) | ((x & 3) ^ 2)
            x >>= 2
        return y
    for x in base:
        if x > 3:
            run, v = 0, 0
            continue
        v = ((v << 2) | int(x)) & mask
        run += 1
        if run >= k:
            cn = min(v, rc(v))
            want[cn] = want.get(cn, 0) + 1
    got = {int(b): int(n) for b, n in zip(lo.tolist(), cts.tolist())}
    assert got == want


def test_acc_deferred_regrow_exact():
    """The merge's row-overflow check is DEFERRED one merge cadence
    (counter._verify_merge): force an overflow that is only detected
    while later chunks are already staged, and assert (a) the regrow
    really ran (La grew past La0) and (b) the result is exact."""
    rng = np.random.default_rng(31)
    seqs = _rand_seqs(rng, 40, 600)
    acc = counter.DeviceAccCounter(21, "canonical", 1 << 13,
                                   expected_uniques=8)
    la0 = acc.La
    for s in seqs:  # one seq per chunk: no boundary-spanning windows
        acc.add_codes(km.encode_bases(s))
    hi, lo, c = acc.finalize()
    assert acc.La > la0  # the deferred regrow path actually ran
    got = {(int(h) << 64) | int(l): int(v)
           for h, l, v in zip(hi, lo, c)}
    assert got == _brute(seqs, 21)


def test_row_maps_monotone_at_product_bits():
    """The plane-keyed routing sort (accum._route_core) requires the
    row map to be monotone non-decreasing in the prefix, and the SPMD
    path requires the host (numpy) map to equal the device (jnp) map
    bit for bit.  Pins both for every bits/B the planners can emit,
    canonical and forward."""
    import itertools

    import jax
    import jax.numpy as jnp

    from meryl_tpu.ops import accum

    with jax.default_device(jax.devices("cpu")[0]):
        for bits, B in itertools.product((10, 14, 16), (8, 12, 1024)):
            pref = np.arange(1 << bits, dtype=np.uint32)
            for canonical in (True, False):
                ri = accum.row_from_prefix_int(pref, bits, B,
                                               canonical, xp=np)
                assert (np.diff(ri) >= 0).all(), (bits, B, canonical)
                assert ri[0] == 0 and ri[-1] <= B - 1
                rd = np.asarray(accum.row_from_prefix_int(
                    jnp.asarray(pref), bits, B, canonical))
                np.testing.assert_array_equal(rd, ri)


def test_plan_route_bits_capped():
    from meryl_tpu.ops import accum
    for chunk in (1 << 15, 1 << 22):
        for exp in (1 << 10, 1 << 24):
            assert accum.plan_route(chunk, 31, exp)["bits"] <= 16
