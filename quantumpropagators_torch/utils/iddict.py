"""Identity-keyed dictionary.

The reference's evaluation protocol overrides controls *by identity*
(Julia ``IdDict``, see ``src/controls.jl:302``): the same
function/array object that appears inside a generator is used as the key
for replacement values.  Python dict semantics hash by value (and numpy
arrays are unhashable), so we provide an explicit identity-keyed mapping.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

__all__ = ["IdDict"]


class IdDict:
    """A mapping keyed on object identity (``id(key)``).

    Keeps a reference to each key so ids cannot be recycled.
    """

    def __init__(self, items: Mapping | "IdDict" | list | None = None):
        self._keys: dict[int, Any] = {}
        self._vals: dict[int, Any] = {}
        if items is not None:
            pairs = items.items() if hasattr(items, "items") else items
            for k, v in pairs:
                self[k] = v

    def __setitem__(self, key, value):
        self._keys[id(key)] = key
        self._vals[id(key)] = value

    def __getitem__(self, key):
        try:
            return self._vals[id(key)]
        except KeyError:
            raise KeyError(key) from None

    def __contains__(self, key) -> bool:
        return id(key) in self._vals

    def get(self, key, default=None):
        return self._vals.get(id(key), default)

    def __len__(self) -> int:
        return len(self._vals)

    def __iter__(self) -> Iterator:
        return iter(self._keys.values())

    def keys(self):
        return self._keys.values()

    def values(self):
        return self._vals.values()

    def items(self):
        return [(self._keys[i], self._vals[i]) for i in self._keys]

    def __repr__(self):
        inner = ", ".join(f"{k!r}: {v!r}" for k, v in self.items())
        return f"IdDict({{{inner}}})"
