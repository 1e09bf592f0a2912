"""DEV001 — CUDA touched at import time.

The reference rule catches a module-scope device constant (the JAX
backend initialised before ``jax.distributed.initialize``). Torch's
spelling of the same bug is a module that creates the CUDA context, pins
memory or puts a tensor on the card while it is imported:

* a process that initialised CUDA cannot hand it to a ``fork``-ed child
  ("Cannot re-initialize CUDA in forked subprocess"), so every worker
  pool or ``multiprocessing`` user that merely imports the module breaks;
* it runs before the program can choose its card: ``CUDA_VISIBLE_DEVICES``
  set after the import, ``torch.cuda.set_device`` and
  ``torch.distributed.init_process_group`` come too late.

The fix pattern is a CPU tensor, a numpy or plain-Python constant at
module scope, and placement on the card at first use.

Import-time contexts scanned, as the reference's: module body, class
bodies, function decorators, and function default arguments.

What flags: every ``torch.cuda.*`` call (``init``, ``set_device``,
``Stream``, ``Event``, ``synchronize``, ``mem_get_info``,
``manual_seed``, ``get_device_name`` ... each creates the context or
needs it) but the metadata queries in :data:`SAFE_CUDA`; ``.cuda()``;
``.pin_memory()`` and a factory's ``pin_memory=True`` (pinned host
memory is allocated through the CUDA context); ``.to(<cuda>)``; a
tensor factory or
``torch.Generator`` whose ``device=`` names CUDA; every
``torch.distributed.*`` call but its availability predicates.

What does not flag, like the reference's dtype references: CPU tensor
factories and ``torch.device("cuda")`` (metadata: no context), and
``torch.cuda.is_available()`` / ``device_count()``. Decision: those two
stay silent. They read the device count without running torch's lazy
CUDA initialisation, which is what poisons a fork, and they are how a
module picks its fallback; with ``PYTORCH_NVML_BASED_CUDA_CHECK=1`` they
do not even initialise CUDA. (Without it CUDA reads
``CUDA_VISIBLE_DEVICES`` at that first query, so a program that sets the
variable itself must do so before importing such a module.)
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from sentinel_tpu_torch.analysis import project
from sentinel_tpu_torch.analysis.core import Finding, ModuleContext, Rule
from sentinel_tpu_torch.analysis.rules import _shared

#: torch.cuda entry points that only read metadata (no CUDA context).
SAFE_CUDA = frozenset({
    "is_available", "device_count", "is_initialized", "get_arch_list",
    "_is_compiled", "amp",
})

#: torch.distributed entry points that only probe what is built in.
SAFE_DIST = frozenset({
    "is_available", "is_initialized", "is_nccl_available",
    "is_gloo_available", "is_mpi_available", "is_torchelastic_launched",
})

#: Tensor methods that put the tensor on the card or in pinned memory.
DEVICE_METHODS = frozenset({"cuda", "pin_memory"})


class DeviceImportRule(Rule):
    id = "DEV001"
    name = "import-time-device-access"
    rationale = (
        "CUDA initialised at import breaks every forked worker of an "
        "importing process and runs before CUDA_VISIBLE_DEVICES, "
        "set_device or init_process_group can take effect")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        consts = project.module_string_constants(ctx)
        for node in _shared.iter_import_time_nodes(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.call_name(node)
            attr = node.func.attr if isinstance(node.func, ast.Attribute) \
                else None
            if name is not None and name.startswith("torch.cuda."):
                if name.split(".")[2] in SAFE_CUDA:
                    continue
                yield self.finding(
                    ctx, node,
                    "'%s' at import time creates the CUDA context (forked "
                    "workers then fail to re-initialise CUDA, and "
                    "CUDA_VISIBLE_DEVICES / set_device set later are "
                    "ignored); defer it into the function that first "
                    "needs the card" % name)
            elif name is not None and name.startswith("torch.distributed."):
                if name.split(".")[2] in SAFE_DIST:
                    continue
                yield self.finding(
                    ctx, node,
                    "'%s' at import time touches the process group / "
                    "device before the program sets up its rank and "
                    "card; defer it into a function that runs after "
                    "bootstrap" % name)
            elif attr in DEVICE_METHODS and (
                    name is None or not name.startswith("torch.")):
                yield self.finding(
                    ctx, node,
                    "'.%s()' at import time initialises CUDA (a module-"
                    "scope tensor on the card or in pinned memory); keep "
                    "host constants on the CPU and move them at first "
                    "use" % attr)
            elif attr == "to" and any(
                    _cudaish(a, ctx, consts)
                    for a in list(node.args) + [
                        k.value for k in node.keywords
                        if k.arg in (None, "device")]):
                yield self.finding(
                    ctx, node,
                    "'.to(<cuda>)' at import time materialises a device "
                    "tensor and initialises CUDA; keep it on the CPU and "
                    "move it at first use")
            elif name is not None and name.startswith("torch.") and (
                    any(k.arg == "device" and _cudaish(k.value, ctx, consts)
                        for k in node.keywords)
                    or any(k.arg == "pin_memory" and _true(k.value)
                           for k in node.keywords)):
                yield self.finding(
                    ctx, node,
                    "module-scope '%s' allocates on the card (or in "
                    "pinned memory) at import, initialising CUDA before "
                    "the program chooses its device; build it on the CPU "
                    "or at first use" % name)


def _true(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _cudaish(node: ast.AST, ctx: ModuleContext, consts) -> bool:
    """Does this device expression name CUDA statically: a ``"cuda"`` /
    ``"cuda:N"`` literal (or a module constant holding one), or
    ``torch.device(<that>)``?"""
    value: Optional[str] = None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        value = node.value
    elif isinstance(node, ast.Name) and node.id in consts:
        value = consts[node.id]
    elif isinstance(node, ast.Call) and \
            ctx.call_name(node) == "torch.device" and node.args:
        return _cudaish(node.args[0], ctx, consts)
    return value is not None and value.split(":")[0] == "cuda"
