"""Port parity: the port's SPI demos (``demos/torch/``) against the
reference's (``demos/``).

Each port demo runs with ``--device cpu`` in a subprocess, and its stdout
must equal, line for line, the reference demo's as ``tests/test_demos.py``
runs it (``JAX_PLATFORMS=cpu``, ``SENTINEL_DEMO_ONESHOT=1``), with one
addition: the reference demo runs with a frozen global clock. Its
``plugin_spi.py`` reads the wall clock, so how many of its ten calls a
5-QPS rule admits depends on how long the first call's compile takes
(six where it outlasts the 1 s window); the port's demo runs on a virtual
clock. ``slot_spi.py`` and ``command_handler_spi.py`` carry their own
virtual clocks in both packages. The reference's stderr (its GC warning
"PendingVerdicts dropped...") is not compared.

Without ``--device``, a port demo runs on ``cuda``: here, with no card,
it fails at once, printing nothing.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
DEMOS = ["slot_spi.py", "plugin_spi.py", "command_handler_spi.py"]

_REFERENCE_RUNNER = """
import runpy, sys
from sentinel_tpu.core.clock import ManualClock, set_global_clock
set_global_clock(ManualClock(start_ms=1_700_000_000_000))
runpy.run_path(sys.argv[1], run_name="__main__")
"""


def _env(**extra):
    return {**os.environ, "PYTHONPATH": str(REPO), **extra}


def test_every_port_demo_is_covered():
    assert sorted(p.name for p in (REPO / "demos" / "torch").glob("*.py")) \
        == sorted(DEMOS)
    for name in DEMOS:
        assert (REPO / "demos" / name).exists()


@pytest.mark.parametrize("script", DEMOS)
def test_port_demo_stdout_equals_the_reference(script, tmp_path):
    port = subprocess.run(
        [sys.executable, str(REPO / "demos" / "torch" / script),
         "--device", "cpu"], env=_env(), cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert port.returncode == 0, port.stderr[-2000:]
    ref = subprocess.run(
        [sys.executable, "-c", _REFERENCE_RUNNER,
         str(REPO / "demos" / script)],
        env=_env(JAX_PLATFORMS="cpu", SENTINEL_DEMO_ONESHOT="1"),
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert port.stdout.strip()
    assert port.stdout.splitlines() == ref.stdout.splitlines()


@pytest.mark.parametrize("script", DEMOS)
def test_port_demo_needs_a_card_by_default(script, tmp_path):
    out = subprocess.run(
        [sys.executable, str(REPO / "demos" / "torch" / script)],
        env=_env(CUDA_VISIBLE_DEVICES=""), cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr
