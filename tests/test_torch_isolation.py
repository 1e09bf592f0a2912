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
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "sentinel_tpu")
             or m.startswith(("jax.", "jaxlib.", "sentinel_tpu.")))
print("BAD=" + ",".join(bad))
"""


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
