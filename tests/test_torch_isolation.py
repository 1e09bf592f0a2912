"""The port stands alone: ``sentinel_tpu_torch``, ``chip_smoke.py`` and
``tests/test_torch_gpu_kernels.py`` import neither JAX nor the JAX
package ``sentinel_tpu``.

The test process already holds JAX (``conftest.py`` imports it), so the
import check runs in a fresh subprocess; an AST scan of every source file
backs it up for imports that only run on some paths.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sentinel_tpu_torch")

_PROBE = """
import sys
import sentinel_tpu_torch
import sentinel_tpu_torch.convert
import sentinel_tpu_torch.runtime
import sentinel_tpu_torch.ops.sortfree
import sentinel_tpu_torch.ops.segments
import sentinel_tpu_torch.core.context
import sentinel_tpu_torch.engine.pipeline
import sentinel_tpu_torch.engine.fastpath
import sentinel_tpu_torch.engine.slots
import sentinel_tpu_torch.rules.param_flow
import sentinel_tpu_torch.rules.flow
import sentinel_tpu_torch.rules.degrade
import sentinel_tpu_torch.stats.window
import sentinel_tpu_torch.obs
import sentinel_tpu_torch.obs.counters
import sentinel_tpu_torch.obs.eventlog
import sentinel_tpu_torch.obs.flight
import sentinel_tpu_torch.obs.hist
import sentinel_tpu_torch.obs.spans
import sentinel_tpu_torch.obs.traceexport
import sentinel_tpu_torch.metrics
import sentinel_tpu_torch.metrics.node
import sentinel_tpu_torch.metrics.searcher
import sentinel_tpu_torch.metrics.timer
import sentinel_tpu_torch.metrics.writer
import sentinel_tpu_torch.core.callbacks
import sentinel_tpu_torch.core.logs
import sentinel_tpu_torch.core.property
import sentinel_tpu_torch.core.statlog
import sentinel_tpu_torch.serving
import sentinel_tpu_torch.frontend
import sentinel_tpu_torch.frontend.batcher
import sentinel_tpu_torch.frontend.workloads
import sentinel_tpu_torch.obs.telemetry
import sentinel_tpu_torch.obs.resource_hist
import sentinel_tpu_torch.parallel.local_shard
import sentinel_tpu_torch.tiering
import sentinel_tpu_torch.tiering.coldtier
import sentinel_tpu_torch.tiering.manager
import sentinel_tpu_torch.tiering.sketch
import sentinel_tpu_torch.control
import sentinel_tpu_torch.control.actuators
import sentinel_tpu_torch.control.loop
import sentinel_tpu_torch.control.policy
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "sentinel_tpu")
             or m.startswith(("jax.", "jaxlib.", "sentinel_tpu.")))
print("BAD=" + ",".join(bad))
"""


_BLOCKED_PROBE = """
import sys
class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sentinel_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Refuse())
for name in [m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "sentinel_tpu")]:
    del sys.modules[name]
import importlib
for mod in sys.argv[1:]:
    importlib.import_module(mod)
print("OK")
"""

#: every module of the observability slice, imported with JAX and the
#: JAX package made unimportable
OBS_MODULES = [
    "sentinel_tpu_torch.obs", "sentinel_tpu_torch.obs.counters",
    "sentinel_tpu_torch.obs.eventlog", "sentinel_tpu_torch.obs.flight",
    "sentinel_tpu_torch.obs.hist", "sentinel_tpu_torch.obs.spans",
    "sentinel_tpu_torch.obs.traceexport", "sentinel_tpu_torch.metrics",
    "sentinel_tpu_torch.metrics.node", "sentinel_tpu_torch.metrics.searcher",
    "sentinel_tpu_torch.metrics.timer", "sentinel_tpu_torch.metrics.writer",
    "sentinel_tpu_torch.core.callbacks", "sentinel_tpu_torch.core.logs",
    "sentinel_tpu_torch.core.property", "sentinel_tpu_torch.core.statlog",
    "sentinel_tpu_torch.runtime",
]

#: the serving tier and the telemetry slice, imported the same way (the
#: HTTP server, which needs aiohttp, has a case of its own below)
SERVING_MODULES = [
    "sentinel_tpu_torch.serving", "sentinel_tpu_torch.frontend",
    "sentinel_tpu_torch.frontend.batcher",
    "sentinel_tpu_torch.frontend.workloads",
    "sentinel_tpu_torch.obs.telemetry", "sentinel_tpu_torch.obs.resource_hist",
    "sentinel_tpu_torch.parallel.local_shard",
]

#: tiered resource state, the overload controller and the conversion
#: helpers that carry their tables, imported the same way
TIER_CONTROL_MODULES = [
    "sentinel_tpu_torch.tiering", "sentinel_tpu_torch.tiering.coldtier",
    "sentinel_tpu_torch.tiering.manager", "sentinel_tpu_torch.tiering.sketch",
    "sentinel_tpu_torch.control", "sentinel_tpu_torch.control.actuators",
    "sentinel_tpu_torch.control.loop", "sentinel_tpu_torch.control.policy",
    "sentinel_tpu_torch.convert", "sentinel_tpu_torch.engine.pipeline",
    "sentinel_tpu_torch.stats.window",
]


def _import_blocked(*modules):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_PROBE, *modules],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


@pytest.mark.parametrize("module", OBS_MODULES + SERVING_MODULES
                         + TIER_CONTROL_MODULES)
def test_module_imports_with_jax_blocked(module):
    _import_blocked(module)


def test_frontend_server_imports_with_jax_blocked():
    """``frontend.server`` imports aiohttp (which the GPU machine lacks:
    nothing else of the port imports this module)."""
    pytest.importorskip("aiohttp")
    _import_blocked("sentinel_tpu_torch.frontend.server")


def test_package_and_runtime_never_import_aiohttp_server():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    probe = ("import sys, sentinel_tpu_torch, sentinel_tpu_torch.frontend, "
             "chip_smoke\n"
             "print(sorted(m for m in sys.modules if m == "
             "'sentinel_tpu_torch.frontend.server' or m.startswith('aiohttp')))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "sentinel_tpu")


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("BAD=")]
    assert line == ["BAD="], proc.stdout


def _sources():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    # the card's test file runs where there is no JAX
    yield os.path.join(REPO, "tests", "test_torch_gpu_kernels.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_anywhere_in_source(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0 and _forbidden(node.module):
            found.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and _forbidden(node.args[0].value):
            found.append(node.args[0].value)
    assert found == []
