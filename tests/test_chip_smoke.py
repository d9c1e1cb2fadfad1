"""The chip smoke script's own reference and its refusal to run off the
card (the GPU run itself is tests/test_gpu.py)."""

import numpy as np
import pytest

import chip_smoke as cs
from meryl_tpu.counter import count_to_db


@pytest.mark.parametrize("k", [21, 33])
def test_reference_matches_count_to_db(tmp_path, k):
    """The script's numpy reference and DB decoder agree with the
    package's counter on a tiny seeded data set."""
    data = cs.Data(str(tmp_path), seed=3, genome_len=3000, coverage=4,
                   n_runs=3)
    out = str(tmp_path / f"k{k}.meryl")
    count_to_db([data.fq1, data.fq2], out, k, chunk_len=1 << 13)
    want = cs.ref_count_rows(np.concatenate([data.r1, data.r2]), k)
    assert len(want[2]) > 1000
    cs.expect_db(f"k={k}", out, want)
    hi, lo, c, labels = cs.read_db(out)
    assert labels is None and (hi != 0).any() == (k > 32)


def test_main_refuses_cpu(monkeypatch, capsys):
    """On the CPU backend the script exits non-zero and prints no
    result line."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rc = cs.main(["--seed", "0"])
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert rc != 0
    assert capsys.readouterr().out == ""
