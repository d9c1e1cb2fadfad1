"""Device time of k-mer extraction against the counting step, one GPU.

At the production chunk (2^22 bases, k=21, packed 2-bit wire) this
  * times XLA's jitted extract_kmers_packed on the host clock (each
    call ends in block_until_ready) and compares it with the memory
    bound of the bytes it must move;
  * traces three programs with jax.profiler, each in its own window:
    extraction alone, the device accumulator's route step (extract +
    routing sorts) and its merge step (M staged cell groups folded into
    the accumulator), and reports the device busy time per call of
    each, read from the trace (union of kernel intervals on the GPU
    plane), and extraction's share of one counting step
    (route + merge / M).

    python scripts/profile_count.py [--reps N]

Prints one line per number, then one JSON line with all of them.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CHUNK = 1 << 22
K = 21
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # NVIDIA data sheet


def device_busy_ns(trace_dir: str) -> tuple[int, list]:
    """Union of event intervals on the GPU device planes of the one
    trace under trace_dir, and the names of the lines read."""
    import jax
    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if len(paths) != 1:
        raise RuntimeError(f"expected one trace under {trace_dir}: {paths}")
    pd = jax.profiler.ProfileData.from_file(paths[0])
    spans, lines = [], []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.append(f"{plane.name}:{line.name}")
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        raise RuntimeError("no device events in the trace")
    spans.sort()
    busy, end = 0.0, -1.0
    for a, b in spans:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return int(busy), sorted(set(lines))


def traced(fn, args_list, name: str) -> float:
    """Device busy ns per call of fn over args_list, from a trace."""
    import jax
    jax.block_until_ready(fn(*args_list[0]))  # compile outside the window
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            for a in args_list:
                jax.block_until_ready(fn(*a))
        busy, lines = device_busy_ns(td)
    print(f"  trace {name}: lines {lines}")
    return busy / len(args_list)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import jax
    import jax.numpy as jnp

    from meryl_tpu import counter, kmer
    from meryl_tpu.ops import accum
    from meryl_tpu.ops import extract as ext

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"profile_count: needs a GPU, JAX has {dev}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i",
         os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0]],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; jax {jax.__version__}")

    rng = np.random.default_rng(1)

    def wire():
        codes = rng.integers(0, 4, size=CHUNK).astype(np.uint8)
        codes[rng.integers(0, CHUNK, size=CHUNK // 2000)] = 4  # N bases
        p2, exc, n_real = kmer.pack_codes_2bit(codes, pad_to=CHUNK)
        return (jnp.asarray(p2), jnp.asarray(exc), jnp.uint32(n_real))

    wires = [wire() for _ in range(args.reps)]
    extract = jax.jit(lambda p, e, n: ext.extract_kmers_packed(
        p, e, n, K, "canonical"))
    out = jax.block_until_ready(extract(*wires[0]))
    moved = (sum(int(x.nbytes) for x in wires[0])
             + sum(int(p.nbytes) for p in out[0]) + int(out[1].nbytes))
    times = []
    for w in wires:
        t0 = time.perf_counter()
        jax.block_until_ready(extract(*w))
        times.append(time.perf_counter() - t0)
    host_s = float(np.median(times))
    bw = HBM_BYTES_PER_S.get(dev.device_kind)
    bound_s = moved / bw if bw else None

    acc = counter.DeviceAccCounter(K, "canonical", CHUNK, 280_000_000)
    route = jax.jit(lambda p, e, n: accum.route_chunk_packed(
        p, e, n, cfg=acc.cfg))
    staged = tuple(route(*w)[0] for w in wires[:acc.M])
    zacc = acc._fresh_acc()
    merge = jax.jit(lambda ap, ac, st: accum.merge_cells(
        ap, ac, st, acc.P, acc.La, int(kmer.VALUE_MAX)))

    ext_ns = traced(extract, wires, "extract")
    route_ns = traced(route, wires, "route")
    merge_ns = traced(merge, [(zacc[0], zacc[1], staged)] * 4, "merge")
    step_ns = route_ns + merge_ns / acc.M
    res = {
        "card": card, "device_kind": dev.device_kind,
        "chunk": CHUNK, "k": K, "B": acc.B, "La": acc.La, "M": acc.M,
        "extract_bytes": moved,
        "extract_host_median_s": host_s,
        "extract_memory_bound_s": bound_s,
        "extract_device_ns": ext_ns,
        "route_device_ns": route_ns,
        "merge_device_ns": merge_ns,
        "step_device_ns": step_ns,
        "extract_share_of_step": ext_ns / step_ns,
        "extract_over_bound": (ext_ns * 1e-9 / bound_s) if bound_s else None,
    }
    for kk, v in res.items():
        print(f"  {kk}: {v}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
