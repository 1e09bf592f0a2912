"""Spawn N coordinated processes on one machine — the testable multihost
harness.

Port of ``sentinel_tpu/multihost/launch.py``. Real deployments start one
process a rank (k8s pod / MPI rank) with the ``SENTINEL_*`` bootstrap
variables set by the orchestrator. For CI, laptops and a one-card
machine, :func:`launch` fakes the topology on one machine: N
subprocesses, each told its platform (``SENTINEL_MH_PLATFORM``: the card
by default, ``cpu`` when asked) and its shard count, rendezvous on a
coordinator port on localhost. The worker script just calls
``multihost.initialize()`` — the env contract is the same either way.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
from typing import Dict, List, Optional, Sequence


class LaunchError(RuntimeError):
    """A worker exited non-zero (or timed out); carries every log."""

    def __init__(self, message: str, procs: List["WorkerResult"]):
        super().__init__(message)
        self.procs = procs


@dataclasses.dataclass
class WorkerResult:
    process_id: int
    returncode: Optional[int]
    stdout: str
    stderr: str


def free_port() -> int:
    """An OS-assigned free TCP port (released before use: tiny race,
    fine for tests — the coordinator binds it back immediately)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(worker_argv: Sequence[str], num_processes: int, *,
           devices_per_process: int = 4,
           env: Optional[Dict[str, str]] = None,
           timeout_s: float = 300.0,
           platform: str = "cuda") -> List[WorkerResult]:
    """Run ``worker_argv`` as ``num_processes`` coordinated subprocesses.

    ``worker_argv`` is the python argv tail (e.g.
    ``["-m", "sentinel_tpu_torch.multihost._parity_worker"]``); each child
    gets the bootstrap env (coordinator address, process id/count, shard
    count, ``SENTINEL_MH_PLATFORM=platform``, ``LOCAL_WORLD_SIZE``: every
    rank on this host, and ``GLOO_SOCKET_IFNAME=lo`` unless set). Returns
    per-worker results once ALL exit cleanly; raises :class:`LaunchError`
    with every captured log otherwise (one worker dying would otherwise
    hang the rest on the collective, so failure kills the whole gang).
    """
    coord = f"127.0.0.1:{free_port()}"
    # the parent's JAX settings mean nothing to the port's workers
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("JAX_") and k != "XLA_FLAGS"}
    # every rank is on this machine: gloo's sockets on the loopback
    base.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if env:
        base.update(env)
    base.update({
        "SENTINEL_COORDINATOR": coord,
        "SENTINEL_NUM_PROCESSES": str(num_processes),
        "SENTINEL_LOCAL_DEVICES": str(devices_per_process),
        "SENTINEL_MH_PLATFORM": platform,
        "LOCAL_WORLD_SIZE": str(num_processes),
    })

    procs = []
    for pid in range(num_processes):
        child_env = dict(base)
        child_env["SENTINEL_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, *worker_argv], env=child_env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    results: List[WorkerResult] = []
    failed = False
    try:
        for pid, p in enumerate(procs):
            try:
                # once one worker died the rest are hung on collectives —
                # don't wait the full budget again for each of them
                out, err = p.communicate(
                    timeout=10.0 if failed else timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                results.append(WorkerResult(pid, None, out, err))
                failed = True
                continue
            results.append(WorkerResult(pid, p.returncode, out, err))
            failed = failed or p.returncode != 0
    finally:
        for p in procs:           # gang teardown on any failure path
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        logs = "\n".join(
            f"--- worker {r.process_id} rc={r.returncode} ---\n"
            f"{r.stdout}\n{r.stderr}" for r in results)
        raise LaunchError(
            f"multihost launch of {num_processes} processes failed:\n{logs}",
            results)
    return results
