"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m portbench.run --workload flow_1m.fused --seed 7 \\
        --seconds 20 --trace 0

Run from the root of a checkout, on a machine with the card(s) the cell
asks for; it refuses to run (exit 2) where there are none, and never
falls back to the CPU. The last line of standard output is the result
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number the
comparison with the plain reference read, beside its limit); the last
lines of standard error repeat the checks. Exit 3 when a forbidden
package (JAX, the JAX package) was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: torch's intra-op threads: the caller's thread and the pipeline's
#: dispatch thread do the host work; a pool of a thread a core besides
#: them oversubscribes the cores, and its waiting threads spin
HOST_THREADS = 1


def process_start() -> float:
    """Wall-clock time this process started (Linux ``/proc``), else
    now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def set_paths() -> None:
    """Where the program writes: its build cache at the fixed directory
    inside the checkout, its logs under ``TMPDIR``."""
    os.environ["SENTINEL_COMPILE_CACHE"] = os.path.join(
        CHECKOUT, "sentinel_tpu_torch", "_build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(
        CHECKOUT, ".portbench_cache", "triton")
    os.environ["SENTINEL_TPU_LOG_DIR"] = os.path.join(
        tempfile.gettempdir(), "portbench-logs")


def set_threads() -> None:
    """:data:`HOST_THREADS` for torch's pool (before torch is imported,
    so that its OpenMP runtime starts with that many)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def main(argv=None) -> int:
    t_proc = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_paths()
    set_threads()
    import torch
    torch.set_num_threads(HOST_THREADS)

    from portbench import harness, isolation
    bench = harness.load_benchmark(CHECKOUT)
    chips = harness.cell_of(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f"; not run", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_proc, bench)
    forbidden = sorted(set(result.pop("forbidden_modules"))
                       | set(isolation.loaded_forbidden()))
    if forbidden:
        print(f"portbench: forbidden modules loaded: {forbidden}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
