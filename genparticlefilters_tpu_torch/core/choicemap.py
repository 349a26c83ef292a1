"""Choice maps and selections with presence masks.

A ``ChoiceMap`` is a flat mapping from a static address tuple to an
``Entry(value, mask)``: ``value`` is a tensor (possibly with a leading
combinator axis, e.g. the time axis of an :class:`~.combinators.Unfold`),
``mask`` is the Python ``True`` (fully present, the static fast path) or a
bool tensor over the leading axes of ``value``. A ``Selection`` maps
addresses to ``True`` or bool-tensor masks.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

__all__ = ["Entry", "ChoiceMap", "EMPTY", "Selection", "select",
           "ALL", "normalize_address"]

AddressComponent = Union[str, int]
Address = Tuple[AddressComponent, ...]


def normalize_address(addr) -> Address:
    if isinstance(addr, tuple):
        return addr
    return (addr,)


class Entry:
    """A value plus a presence mask over its leading (combinator) axes."""

    __slots__ = ("value", "mask")

    def __init__(self, value, mask=True):
        self.value = value
        self.mask = mask

    def __repr__(self):
        return f"Entry({self.value!r}, mask={self.mask!r})"

    # pytree protocol (core/tree.py): a static-True mask is not a leaf
    def tree_flatten(self):
        if self.mask is True:
            return (self.value,), True
        return (self.value, self.mask), False

    @classmethod
    def tree_unflatten(cls, static_full, children):
        if static_full:
            return cls(children[0], True)
        return cls(children[0], children[1])


class ChoiceMap:
    """Immutable flat map from address tuples to entries."""

    __slots__ = ("entries",)

    def __init__(self, entries: Dict[Address, Entry] | None = None):
        self.entries = dict(entries) if entries else {}

    def scope(self, name: AddressComponent) -> "ChoiceMap":
        """Sub-map of entries under the first address component ``name``."""
        return ChoiceMap({k[1:]: v for k, v in self.entries.items()
                          if k and k[0] == name})

    def int_keyed(self):
        """Entries whose first component is an int: {int: sub-ChoiceMap}."""
        out: Dict[int, Dict[Address, Entry]] = {}
        for k, v in self.entries.items():
            if k and isinstance(k[0], int):
                out.setdefault(k[0], {})[k[1:]] = v
        return {i: ChoiceMap(d) for i, d in out.items()}

    def locate(self, addr):
        """Resolve ``addr`` to ``(entry_key, idxs, entry)``: the stored
        address that matched, the int components consumed as indices into
        the entry's leading combinator axes, and the raw entry — or None
        when absent."""
        d = {k: (k, v) for k, v in self.entries.items()}
        idxs = []
        for c in normalize_address(addr):
            if isinstance(c, int) and not any(k and k[0] == c for k in d):
                idxs.append(c)
            else:
                d = {k[1:]: kv for k, kv in d.items() if k and k[0] == c}
        kv = d.get(())
        if kv is None:
            return None
        return kv[0], tuple(idxs), kv[1]

    def resolve(self, addr):
        """The entry stored at exactly ``addr``, or None."""
        return self.entries.get(normalize_address(addr))

    def __getitem__(self, addr):
        e = self.resolve(addr)
        if e is None:
            raise KeyError(addr)
        return e.value

    def __repr__(self):
        items = ", ".join(f"{k}: {v!r}" for k, v in self.entries.items())
        return f"ChoiceMap({{{items}}})"


EMPTY = ChoiceMap()


class Selection:
    """A (possibly masked) set of addresses, used by ``regenerate``."""

    __slots__ = ("entries", "all_")

    def __init__(self, entries=None, all_: bool = False):
        self.entries = dict(entries) if entries else {}
        self.all_ = all_

    def scope(self, name: AddressComponent) -> "Selection":
        if self.all_:
            return ALL
        return Selection({k[1:]: v for k, v in self.entries.items()
                          if k and k[0] == name})

    def mask_at_leaf(self):
        """Selection mask at the empty address: True / False / bool tensor."""
        if self.all_:
            return True
        return self.entries.get((), False)

    def __repr__(self):
        if self.all_:
            return "Selection(ALL)"
        return f"Selection({list(self.entries.keys())})"


ALL = Selection(all_=True)


def select(*addrs) -> Selection:
    return Selection({normalize_address(a): True for a in addrs})
