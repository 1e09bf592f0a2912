"""Provider SPI loader — the Python analog of the reference's custom
service loader (``spi/SpiLoader.java:73-179``, ``spi/Spi.java``).

The reference discovers providers through ``META-INF/services`` files and
an ``@Spi(value, order, isDefault)`` annotation; the Python equivalents
are:

* direct registration — the :func:`spi` decorator (or
  :meth:`SpiLoader.register`) at import time of the providing module;
* the ``SENTINEL_TPU_PLUGINS`` environment variable — a comma-separated
  list of module paths imported once on first SPI access (the analog of
  dropping a provider jar on the classpath); importing the module runs its
  ``@spi`` decorators;
* ``importlib.metadata`` entry points in group ``sentinel_tpu_torch.plugins``
  (for installed packages), loaded on the same first access. The group is
  the port's own: a plugin written for ``sentinel_tpu`` imports that
  package, and so JAX, and is never loaded through an entry point here.
  A module named in ``SENTINEL_TPU_PLUGINS`` is imported whatever it
  imports: name only modules written for this package there.

Semantics preserved from the reference: providers carry an ``order``
(lower sorts first; default ``LOWEST_PRECEDENCE`` like
``InitOrder.LOWEST_PRECEDENCE``), an optional alias, and an optional
``is_default`` flag; instances are singletons per provider unless the
caller asks for fresh instances (``load_new_instance_list_sorted`` — used
for per-engine providers such as processor slots, whose state must not be
shared between Sentinel instances).

Well-known service names (the analog of the reference's SPI interfaces):

* ``init_func`` — ``fn(sentinel)`` startup hooks (``InitFunc.java``),
  executed once per process by
  :class:`~sentinel_tpu_torch.core.initexec.InitExecutor`.
* ``processor_slot`` — :class:`~sentinel_tpu_torch.engine.slots.HostGate` /
  :class:`~sentinel_tpu_torch.engine.slots.DeviceSlot` subclasses, auto-
  registered into every new ``Sentinel`` (``ProcessorSlot`` SPI,
  ``DefaultSlotChainBuilder.java:39``).
* ``command_handler`` — callables with ``command_name``/``command_desc``
  attributes, auto-registered into every command center built by
  ``register_default_handlers`` (``CommandHandler`` SPI).

The PyTorch port's own copy of ``sentinel_tpu/core/spi.py``.
"""

from __future__ import annotations

import importlib
import os
import threading
from typing import Any, Dict, List, Optional

LOWEST_PRECEDENCE = 2 ** 31 - 1      # InitOrder.LOWEST_PRECEDENCE

SERVICE_INIT_FUNC = "init_func"
SERVICE_PROCESSOR_SLOT = "processor_slot"
SERVICE_COMMAND_HANDLER = "command_handler"

PLUGINS_ENV = "SENTINEL_TPU_PLUGINS"
ENTRY_POINT_GROUP = "sentinel_tpu_torch.plugins"

_plugins_lock = threading.Lock()
_plugins_loaded = False


def load_plugins(force: bool = False) -> List[str]:
    """Import plugin modules (env var + entry points) exactly once;
    importing runs their ``@spi`` decorators. → names imported this call."""
    global _plugins_loaded
    with _plugins_lock:
        if _plugins_loaded and not force:
            return []
        _plugins_loaded = True
        imported: List[str] = []
        for mod in filter(None,
                          (m.strip() for m in
                           os.environ.get(PLUGINS_ENV, "").split(","))):
            try:
                importlib.import_module(mod)
                imported.append(mod)
            except Exception as exc:
                from sentinel_tpu_torch.core.logs import record_log
                record_log().warning("plugin module %s failed to import: %r",
                                     mod, exc)
        try:
            from importlib.metadata import entry_points
            for ep in entry_points(group=ENTRY_POINT_GROUP):
                try:
                    ep.load()
                    imported.append(ep.name)
                except Exception as exc:
                    from sentinel_tpu_torch.core.logs import record_log
                    record_log().warning(
                        "plugin entry point %s failed: %r", ep.name, exc)
        except Exception:
            pass                      # no importlib.metadata / old API
        return imported


class _Provider:
    __slots__ = ("obj", "alias", "order", "is_default", "seq")

    def __init__(self, obj: Any, alias: str, order: int,
                 is_default: bool, seq: int):
        self.obj = obj
        self.alias = alias
        self.order = order
        self.is_default = is_default
        self.seq = seq


class SpiLoader:
    """One loader per service name; ``SpiLoader.of(service)`` is the
    cached accessor like the reference's ``SpiLoader.of(Class)``."""

    _loaders: Dict[str, "SpiLoader"] = {}
    _global_lock = threading.Lock()

    def __init__(self, service: str):
        self.service = service
        self._lock = threading.Lock()
        self._providers: List[_Provider] = []
        self._singletons: Dict[int, Any] = {}
        self._seq = 0

    # ------------------------------------------------------------- access
    @classmethod
    def of(cls, service: str) -> "SpiLoader":
        with cls._global_lock:
            loader = cls._loaders.get(service)
            if loader is None:
                loader = cls._loaders[service] = SpiLoader(service)
            return loader

    @classmethod
    def reset_and_clear_all(cls) -> None:
        """Test hygiene (reference ``resetAndClearAll``)."""
        global _plugins_loaded
        with cls._global_lock:
            cls._loaders.clear()
        with _plugins_lock:
            _plugins_loaded = False

    # ----------------------------------------------------------- register
    def register(self, provider: Any, *, alias: Optional[str] = None,
                 order: int = LOWEST_PRECEDENCE,
                 is_default: bool = False) -> Any:
        """Register a provider: a class (instantiated lazily, singleton
        per class unless fresh instances are requested) or any
        non-class object/callable used as-is. → the provider (decorator-
        friendly)."""
        name = alias or getattr(provider, "__name__",
                                provider.__class__.__name__)
        with self._lock:
            self._providers.append(_Provider(
                provider, name, int(order), bool(is_default), self._seq))
            self._seq += 1
        return provider

    def unregister(self, provider: Any) -> None:
        with self._lock:
            self._providers = [p for p in self._providers
                               if p.obj is not provider]

    # --------------------------------------------------------------- load
    def _sorted(self) -> List[_Provider]:
        load_plugins()
        with self._lock:
            return sorted(self._providers, key=lambda p: (p.order, p.seq))

    def _instantiate(self, p: _Provider, fresh: bool) -> Any:
        if not isinstance(p.obj, type):
            return p.obj
        if fresh:
            return p.obj()
        with self._lock:
            inst = self._singletons.get(p.seq)
            if inst is None:
                inst = self._singletons[p.seq] = p.obj()
            return inst

    def load_instance_list_sorted(self) -> List[Any]:
        return [self._instantiate(p, False) for p in self._sorted()]

    def load_new_instance_list_sorted(self) -> List[Any]:
        """Fresh instances for class providers — for per-engine services
        (processor slots) whose state must not leak across Sentinels."""
        return [self._instantiate(p, True) for p in self._sorted()]

    def load_highest_priority_instance(self) -> Optional[Any]:
        ps = self._sorted()
        return self._instantiate(ps[0], False) if ps else None

    def load_default_instance(self) -> Optional[Any]:
        """The ``is_default`` provider, else the first sorted (reference
        ``loadFirstInstanceOrDefault``)."""
        ps = self._sorted()
        for p in ps:
            if p.is_default:
                return self._instantiate(p, False)
        return self._instantiate(ps[0], False) if ps else None

    def load_instance_by_alias(self, alias: str) -> Optional[Any]:
        for p in self._sorted():
            if p.alias == alias:
                return self._instantiate(p, False)
        return None

    def aliases(self) -> List[str]:
        return [p.alias for p in self._sorted()]


def spi(service: str, *, alias: Optional[str] = None,
        order: int = LOWEST_PRECEDENCE, is_default: bool = False):
    """Class/function decorator registering a provider (``@Spi`` analog)::

        @spi("processor_slot", order=100)
        class AuditGate(HostGate): ...
    """
    def wrap(provider):
        return SpiLoader.of(service).register(
            provider, alias=alias, order=order, is_default=is_default)
    return wrap
