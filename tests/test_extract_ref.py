"""extract_kmers / extract_kmers_packed against an inline numpy
reference (2 bits per base A=00 C=01 T=10 G=11, complement = code ^ 2,
canonical = min of the k-mer and its reverse complement)."""

import jax.numpy as jnp
import numpy as np
import pytest

from meryl_tpu import kmer as km
from meryl_tpu.ops import extract as ext

SEP = 255


def ref_planes(codes: np.ndarray, k: int):
    """Canonical window starting at each position as P u32 planes
    (least-significant first), plus validity (no base > 3 inside and
    the window fits)."""
    L = len(codes)
    P = km.num_planes(k)
    planes = np.zeros((P, L), np.uint32)
    valid = np.zeros(L, bool)
    for i in range(L - k + 1):
        w = codes[i:i + k]
        if (w > 3).any():
            continue
        f = r = 0
        for t, b in enumerate(w.tolist()):
            f = (f << 2) | b
            r |= (b ^ 2) << (2 * t)
        v = min(f, r)
        for p in range(P):
            planes[p, i] = (v >> (32 * p)) & 0xFFFFFFFF
        valid[i] = True
    return planes, valid


def _codes(rng, L, k):
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    codes[rng.integers(0, L, size=L // 97)] = SEP   # sequence breaks
    codes[200:200 + k + 3] = 4                       # an N run
    return codes


def _check(planes, valid, want_p, want_v):
    v = np.asarray(valid)
    np.testing.assert_array_equal(v, want_v)
    for p, w in zip(planes, want_p):
        np.testing.assert_array_equal(np.asarray(p)[v], w[v])


@pytest.mark.parametrize("k", [5, 16, 21, 31, 33, 63])
def test_extract_matches_reference(k):
    rng = np.random.default_rng(k)
    codes = _codes(rng, 1 << 10, k)
    want_p, want_v = ref_planes(codes, k)
    _check(*ext.extract_kmers(jnp.asarray(codes), k, "canonical"),
           want_p, want_v)
    p2, exc, n_real = km.pack_codes_2bit(codes)
    _check(*ext.extract_kmers_packed(jnp.asarray(p2), jnp.asarray(exc),
                                     jnp.uint32(n_real), k, "canonical"),
           want_p, want_v)


def test_extract_packed_chunk_tail():
    """A final chunk shorter than the device chunk: the packed wire pads
    it (no exception entries for the pad), windows that would reach into
    the pad are invalid, and windows across 16-base wire words match."""
    k = 21
    rng = np.random.default_rng(99)
    chunk = 1 << 11
    real = rng.integers(0, 4, size=chunk - 300).astype(np.uint8)
    real[-1] = SEP                         # the sequence's separator
    codes = np.concatenate([real, np.full(300, SEP, np.uint8)])
    want_p, want_v = ref_planes(codes, k)
    p2, exc, n_real = km.pack_codes_2bit(real, pad_to=chunk)
    assert n_real == len(real) - 1 and len(p2) == chunk // 16
    _check(*ext.extract_kmers_packed(jnp.asarray(p2), jnp.asarray(exc),
                                     jnp.uint32(n_real), k, "canonical"),
           want_p, want_v)
    _check(*ext.extract_kmers(jnp.asarray(codes), k, "canonical"),
           want_p, want_v)
