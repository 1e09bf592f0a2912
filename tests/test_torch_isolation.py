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
import sentinel_tpu_torch.parallel.shard_math
import sentinel_tpu_torch.parallel.cluster
import sentinel_tpu_torch.parallel.concurrent
import sentinel_tpu_torch.cluster
import sentinel_tpu_torch.cluster.codec
import sentinel_tpu_torch.cluster.client
import sentinel_tpu_torch.cluster.server
import sentinel_tpu_torch.cluster.coordinator
import sentinel_tpu_torch.rules.codec
import sentinel_tpu_torch.core.spi
import sentinel_tpu_torch.core.initexec
import sentinel_tpu_torch.transport
import sentinel_tpu_torch.transport.command
import sentinel_tpu_torch.transport.http_server
import sentinel_tpu_torch.transport.async_http_server
import sentinel_tpu_torch.transport.mounted
import sentinel_tpu_torch.transport.heartbeat
import sentinel_tpu_torch.transport.handlers
import sentinel_tpu_torch.transport.bootstrap
import sentinel_tpu_torch.datasource
import sentinel_tpu_torch.datasource.base
import sentinel_tpu_torch.datasource.registry
import sentinel_tpu_torch.datasource.converters
import sentinel_tpu_torch.datasource.http
import sentinel_tpu_torch.datasource.named
import sentinel_tpu_torch.cluster.commands
import sentinel_tpu_torch.api
import sentinel_tpu_torch.adapters
import sentinel_tpu_torch.adapters.decorator
import sentinel_tpu_torch.adapters.wsgi
import sentinel_tpu_torch.adapters.asgi
import sentinel_tpu_torch.adapters.asyncio_support
import sentinel_tpu_torch.gateway
import sentinel_tpu_torch.gateway.api
import sentinel_tpu_torch.gateway.codec
import sentinel_tpu_torch.gateway.param
import sentinel_tpu_torch.gateway.rules
import sentinel_tpu_torch.adapters.asgi_gateway
import sentinel_tpu_torch.metrics.exporter
import sentinel_tpu_torch.native
import sentinel_tpu_torch.core.registry
sentinel_tpu_torch.native.native_available()
import sentinel_tpu_torch.dashboard
import sentinel_tpu_torch.dashboard.auth
import sentinel_tpu_torch.dashboard.client
import sentinel_tpu_torch.dashboard.discovery
import sentinel_tpu_torch.dashboard.fetcher
import sentinel_tpu_torch.dashboard.repository
import sentinel_tpu_torch.dashboard.rulepipeline
import sentinel_tpu_torch.dashboard.server
import sentinel_tpu_torch.adapters.http_client
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


#: the cluster token tier (sharded engine, routing math, concurrent
#: tokens, wire codec, token server and client, coordinator), imported
#: the same way
CLUSTER_MODULES = [
    "sentinel_tpu_torch.parallel.shard_math",
    "sentinel_tpu_torch.parallel.cluster",
    "sentinel_tpu_torch.parallel.concurrent",
    "sentinel_tpu_torch.cluster", "sentinel_tpu_torch.cluster.codec",
    "sentinel_tpu_torch.cluster.client", "sentinel_tpu_torch.cluster.server",
    "sentinel_tpu_torch.cluster.coordinator",
]


#: the command plane (rule JSON codec, SPI loader and init hooks, command
#: center and its HTTP frontends, heartbeat, datasources, cluster server
#: commands, the static facade and the web adapters), imported the same way
COMMAND_MODULES = [
    "sentinel_tpu_torch.rules.codec", "sentinel_tpu_torch.core.spi",
    "sentinel_tpu_torch.core.initexec", "sentinel_tpu_torch.transport",
    "sentinel_tpu_torch.transport.command",
    "sentinel_tpu_torch.transport.http_server",
    "sentinel_tpu_torch.transport.async_http_server",
    "sentinel_tpu_torch.transport.mounted",
    "sentinel_tpu_torch.transport.heartbeat",
    "sentinel_tpu_torch.transport.handlers",
    "sentinel_tpu_torch.transport.bootstrap", "sentinel_tpu_torch.datasource",
    "sentinel_tpu_torch.datasource.base",
    "sentinel_tpu_torch.datasource.registry",
    "sentinel_tpu_torch.datasource.converters",
    "sentinel_tpu_torch.datasource.http",
    "sentinel_tpu_torch.datasource.named",
    "sentinel_tpu_torch.cluster.commands", "sentinel_tpu_torch.api",
    "sentinel_tpu_torch.adapters", "sentinel_tpu_torch.adapters.decorator",
    "sentinel_tpu_torch.adapters.wsgi", "sentinel_tpu_torch.adapters.asgi",
    "sentinel_tpu_torch.adapters.asyncio_support",
]


#: the gateway, the Prometheus exporter and the native interning tables,
#: imported the same way
GATEWAY_EXPORTER_NATIVE_MODULES = [
    "sentinel_tpu_torch.gateway", "sentinel_tpu_torch.gateway.api",
    "sentinel_tpu_torch.gateway.codec", "sentinel_tpu_torch.gateway.param",
    "sentinel_tpu_torch.gateway.rules",
    "sentinel_tpu_torch.adapters.asgi_gateway",
    "sentinel_tpu_torch.metrics.exporter", "sentinel_tpu_torch.native",
    "sentinel_tpu_torch.core.registry",
]


#: the dashboard and the outbound HTTP-client adapter, imported the same
#: way (the aiohttp and gRPC adapters, which import those packages at
#: module top, have cases of their own below)
DASHBOARD_ADAPTER_MODULES = [
    "sentinel_tpu_torch.dashboard", "sentinel_tpu_torch.dashboard.auth",
    "sentinel_tpu_torch.dashboard.client",
    "sentinel_tpu_torch.dashboard.discovery",
    "sentinel_tpu_torch.dashboard.fetcher",
    "sentinel_tpu_torch.dashboard.repository",
    "sentinel_tpu_torch.dashboard.rulepipeline",
    "sentinel_tpu_torch.dashboard.server",
    "sentinel_tpu_torch.adapters.http_client",
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
                         + TIER_CONTROL_MODULES + CLUSTER_MODULES
                         + COMMAND_MODULES
                         + GATEWAY_EXPORTER_NATIVE_MODULES
                         + DASHBOARD_ADAPTER_MODULES)
def test_module_imports_with_jax_blocked(module):
    _import_blocked(module)


def test_frontend_server_imports_with_jax_blocked():
    """``frontend.server`` imports aiohttp (which the GPU machine lacks:
    nothing else of the port imports this module)."""
    pytest.importorskip("aiohttp")
    _import_blocked("sentinel_tpu_torch.frontend.server")


@pytest.mark.parametrize("module,package", [
    ("sentinel_tpu_torch.adapters.aiohttp_server", "aiohttp"),
    ("sentinel_tpu_torch.adapters.grpc_interceptor", "grpc")])
def test_optional_adapter_imports_with_jax_blocked(module, package):
    """The aiohttp and gRPC adapters import their packages at module
    top, as the reference's do; they import where those are installed."""
    pytest.importorskip(package)
    _import_blocked(module)


def test_package_and_runtime_never_import_aiohttp_server():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    probe = ("import sys, sentinel_tpu_torch, sentinel_tpu_torch.frontend, "
             "sentinel_tpu_torch.adapters, sentinel_tpu_torch.dashboard, "
             "chip_smoke\n"
             "print(sorted(m for m in sys.modules if m in ("
             "'sentinel_tpu_torch.frontend.server', "
             "'sentinel_tpu_torch.adapters.aiohttp_server', "
             "'sentinel_tpu_torch.adapters.grpc_interceptor') "
             "or m.startswith(('aiohttp', 'grpc', 'requests'))))")
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


def test_scan_covers_the_gateway_exporter_and_native_sources():
    """The AST scan below walks the whole package: the gateway, the ASGI
    gateway adapter, the exporter and the native tables among it."""
    scanned = {os.path.relpath(p, PORT) for p in _sources()}
    for rel in ("gateway/__init__.py", "gateway/api.py", "gateway/codec.py",
                "gateway/param.py", "gateway/rules.py",
                "adapters/asgi_gateway.py", "metrics/exporter.py",
                "native/__init__.py"):
        assert rel in scanned, rel


def test_scan_covers_the_dashboard_and_adapter_sources():
    """The AST scan below walks the dashboard and the three outbound
    adapters too, function-level imports included: the dashboard server's
    imports of the record log and the two codecs, made where they are
    used, name the port's modules."""
    scanned = {os.path.relpath(p, PORT) for p in _sources()}
    for rel in ("dashboard/__init__.py", "dashboard/auth.py",
                "dashboard/client.py", "dashboard/discovery.py",
                "dashboard/fetcher.py", "dashboard/repository.py",
                "dashboard/rulepipeline.py", "dashboard/server.py",
                "adapters/http_client.py", "adapters/aiohttp_server.py",
                "adapters/grpc_interceptor.py"):
        assert rel in scanned, rel
    with open(os.path.join(PORT, "dashboard", "server.py")) as fh:
        tree = ast.parse(fh.read())
    local = sorted(
        node.module for fn in ast.walk(tree)
        if isinstance(fn, ast.FunctionDef)
        for node in ast.walk(fn)
        if isinstance(node, ast.ImportFrom) and node.module
        and node.module.startswith("sentinel_tpu"))
    assert local == ["sentinel_tpu_torch.core.logs",
                     "sentinel_tpu_torch.gateway",
                     "sentinel_tpu_torch.gateway",
                     "sentinel_tpu_torch.rules"]


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
