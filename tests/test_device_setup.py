"""Device-facing setup: compile-cache placement, memory budgets derived
from the device's bytes_limit, per-process cards in the launcher, and
the -C counting plan."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from meryl_tpu import budget
from meryl_tpu.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_child(env_extra: dict, drop=()) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in drop and k != "MERYL_TPU_NO_CACHE"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c",
         "import meryl_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_cache_dir_from_env_is_left_alone(tmp_path):
    want = str(tmp_path / "jaxcache")
    assert _cache_dir_in_child({"JAX_COMPILATION_CACHE_DIR": want}) == want


def test_cache_dir_defaults_to_checkout():
    got = _cache_dir_in_child({}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert got == os.path.join(REPO, ".jax_cache")


class FakeDevice:
    def __init__(self, platform="gpu", stats=None):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("name,share", sorted(budget.SHARES.items()))
def test_budget_is_share_of_bytes_limit(monkeypatch, name, share):
    for env in budget.ENV.values():
        monkeypatch.delenv(env, raising=False)
    dev = FakeDevice(stats={"bytes_limit": 60_000_000_000})
    assert budget.budget_bytes(name, dev) == int(share * 60e9)


def test_budget_env_override_and_cpu_default(monkeypatch):
    monkeypatch.setenv("MERYL_TPU_ACC_CAP_GB", "0.5")
    dev = FakeDevice(stats={"bytes_limit": 60_000_000_000})
    assert budget.budget_bytes("acc", dev) == 500_000_000
    monkeypatch.delenv("MERYL_TPU_ACC_CAP_GB")
    assert budget.budget_bytes("acc", FakeDevice("cpu")) == 4_000_000_000
    assert budget.budget_bytes("hbm", FakeDevice("cpu")) == 16_000_000_000


def test_budgets_reach_planner_and_lookup(tmp_path, monkeypatch):
    """configure_counting plans with the derived device budget, and the
    lookup table leaves the device when it outgrows its share."""
    from meryl_tpu.counter import configure_counting
    from meryl_tpu.db import MerylDB
    from meryl_tpu.lookup import ExactLookup

    monkeypatch.delenv("MERYL_TPU_LOOKUP_DEVICE_GB", raising=False)
    fa = tmp_path / "r.fa"
    fa.write_text(">r\nACGTACGTTTGACCA\n")
    big = FakeDevice(stats={"bytes_limit": 80_000_000_000})
    monkeypatch.setattr(budget, "_default_device", lambda: big)
    assert configure_counting([str(fa)], 21)["hbm_gb"] == 80.0

    kk = np.arange(1, 4001, dtype=np.uint64) * 977
    db = MerylDB.write(str(tmp_path / "t.meryl"), 21,
                       np.zeros(len(kk), np.uint64), kk,
                       np.ones(len(kk), np.uint32))
    assert ExactLookup(db)._device_resident
    tiny = FakeDevice(stats={"bytes_limit": 100_000})
    monkeypatch.setattr(budget, "_default_device", lambda: tiny)
    L = ExactLookup(db)
    assert not L._device_resident
    assert L.values_np(kk[:3] * 0, kk[:3]).tolist() == [1, 1, 1]


def test_device_without_memory_stats_raises(monkeypatch):
    monkeypatch.delenv("MERYL_TPU_BACJ_CAP_GB", raising=False)
    with pytest.raises(RuntimeError, match="bytes_limit"):
        budget.budget_bytes("bacj", FakeDevice("gpu", stats=None))
    with pytest.raises(RuntimeError, match="bytes_limit"):
        budget.budget_bytes("hbm", FakeDevice("gpu", stats={}))


def test_launcher_gives_each_process_its_own_cards(monkeypatch):
    envs = []

    class FakeProc:
        def __init__(self, argv, env, **kw):
            envs.append(env)

        def wait(self):
            return 0

    monkeypatch.setattr(launch.subprocess, "Popen", FakeProc)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    assert launch.main(["--nprocs", "2", "--", "count"]) == 0
    cards = [e["CUDA_VISIBLE_DEVICES"] for e in envs]
    assert cards == ["0,1", "2,3"]
    assert all("MERYL_TPU_LOCAL_DEVICES" not in e for e in envs)
    envs.clear()
    assert launch.main(["--nprocs", "4", "--devices-per-proc", "1",
                        "--", "count"]) == 0
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2", "3"]
    assert launch.main(["--nprocs", "3", "--devices-per-proc", "2",
                        "--", "count"]) == 2     # 6 cards asked, 4 seen
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert launch.visible_gpus(os.environ) == []


def test_configure_prints_plan_without_scaling_table(tmp_path,
                                                     monkeypatch):
    from meryl_tpu import cli
    fa = tmp_path / "r.fa"
    rng = np.random.default_rng(0)
    fa.write_text(">r\n" + "".join(
        "ACTG"[c] for c in rng.integers(0, 4, 500)) + "\n")
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    assert cli.main(["-C", "count", "k=21", str(fa), "output",
                     str(tmp_path / "o.meryl")]) == 0
    text = err.getvalue()
    for key in ("expected_kmers", "chunk_len", "hbm_gb", "batches"):
        assert f"  {key}: " in text
    assert "scaling" not in text and "Gbases/s" not in text
    assert not os.path.exists(tmp_path / "o.meryl")
