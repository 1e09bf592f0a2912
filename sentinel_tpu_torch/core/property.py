"""Observable config cells.

Reference: ``sentinel-core/.../property/DynamicSentinelProperty.java`` — every
hot-reloadable knob (rules, sample counts, cluster config) is a property cell
with listeners; rule managers subscribe and rebuild derived state on update.
Same pattern here: datasources push into a cell, the rule manager listener
recompiles the device rule tables and swaps them atomically.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


class SentinelProperty(Generic[T]):
    def __init__(self, value: Optional[T] = None):
        self._value = value
        self._listeners: List[Callable[[T], None]] = []
        # RLock, and listeners fire WHILE HELD: guarantees each listener sees
        # a total order of values (initial fire can't race an update_value and
        # deliver stale-last). Listeners may re-enter the property.
        self._lock = threading.RLock()

    def get(self) -> Optional[T]:
        return self._value

    def add_listener(self, listener: Callable[[T], None]) -> None:
        """Registers and immediately fires with the current value if set
        (reference: PropertyListener.configLoad on register)."""
        with self._lock:
            self._listeners.append(listener)
            if self._value is not None:
                listener(self._value)

    def remove_listener(self, listener: Callable[[T], None]) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def update_value(self, new_value: T) -> bool:
        """Fires listeners only when the value actually changed
        (DynamicSentinelProperty.updateValue)."""
        with self._lock:
            if self._value == new_value:
                return False
            self._value = new_value
            for listener in list(self._listeners):
                listener(new_value)
        return True
