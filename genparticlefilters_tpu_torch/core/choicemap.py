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

import numpy as np
import torch

__all__ = ["Address", "Entry", "ChoiceMap", "EMPTY", "Selection", "select",
           "ALL", "NONE", "choicemap", "normalize_address"]

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

    def mask_array(self):
        """The mask broadcast to the value's shape as a bool tensor."""
        v = torch.as_tensor(self.value)
        if self.mask is True:
            return torch.ones(v.shape, dtype=torch.bool, device=v.device)
        m = torch.as_tensor(self.mask).to(torch.bool)
        extra = v.dim() - m.dim()
        if extra > 0:
            m = m.reshape(tuple(m.shape) + (1,) * extra)
        return m.expand(v.shape)

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

    def is_empty(self) -> bool:
        """Structurally empty (no entries at all)."""
        return not self.entries

    def int_keyed(self):
        """Entries whose first component is an int: {int: sub-ChoiceMap}."""
        out: Dict[int, Dict[Address, Entry]] = {}
        for k, v in self.entries.items():
            if k and isinstance(k[0], int):
                out.setdefault(k[0], {})[k[1:]] = v
        return {i: ChoiceMap(d) for i, d in out.items()}

    def str_keyed(self) -> "ChoiceMap":
        """Entries whose first component is NOT an int."""
        return ChoiceMap({k: v for k, v in self.entries.items()
                          if not (k and isinstance(k[0], int))})

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
        """The entry at ``addr``, or None. Int components that no stored
        address holds index the leading combinator axes of a dense entry,
        as ``("line", 3, "y")`` does a dense ``("line", "y")`` entry."""
        loc = self.locate(addr)
        if loc is None:
            return None
        _, idxs, e = loc
        if not idxs:
            return e
        if e.mask is True:
            return Entry(e.value[idxs], True)
        m = torch.as_tensor(e.mask).to(torch.bool)
        return Entry(e.value[idxs], m[idxs[:m.dim()]])

    def __getitem__(self, addr):
        e = self.resolve(addr)
        if e is None:
            raise KeyError(addr)
        return e.value

    def merge(self, other: "ChoiceMap") -> "ChoiceMap":
        """Merge; where both maps hold an entry at one address, ``other``
        wins wherever its mask is set (mask algebra, no host read)."""
        entries = dict(self.entries)
        for k, e2 in other.entries.items():
            e1 = entries.get(k)
            if e1 is None or e2.mask is True:
                entries[k] = e2
                continue
            m2 = e2.mask_array()
            v1 = value_on(e1.value, m2.device)
            v2 = value_on(e2.value, m2.device)
            dt = torch.result_type(v1, v2)
            value = torch.where(m2, v2.to(dt).expand(m2.shape),
                                v1.to(dt).expand(m2.shape))
            mask = True if e1.mask is True else torch.logical_or(
                e1.mask_array(), m2)
            entries[k] = Entry(value, mask)
        return ChoiceMap(entries)

    def total_mask_any(self):
        """Does any entry have a set mask bit? A Python bool when every mask
        is static, else a device bool (read only by a caller that checks)."""
        flags = []
        for e in self.entries.values():
            if e.mask is True:
                return True
            if e.mask is not False:
                flags.append(torch.any(torch.as_tensor(e.mask)))
        if not flags:
            return False
        return torch.any(torch.stack(flags))

    # tree protocol (core/tree.py): entries in the JAX package's key order
    def tree_flatten(self):
        keys = tuple(sorted(self.entries, key=repr))
        return tuple(self.entries[k] for k in keys), keys

    @classmethod
    def tree_unflatten(cls, keys, children):
        return cls(dict(zip(keys, children)))

    def __repr__(self):
        items = ", ".join(f"{k}: {v!r}" for k, v in self.entries.items())
        return f"ChoiceMap({{{items}}})"


EMPTY = ChoiceMap()


def _as_value(v):
    """A choice value as the JAX package stores it with 64-bit mode off:
    Python and numpy floats become float32, ints int32, bools bool. Host
    values stay numpy arrays, with no device of their own (the interpreter
    that reads them places them with :func:`value_on`); tensors pass
    through."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return np.array(a)


def value_on(v, device) -> torch.Tensor:
    """A choice value as a tensor on ``device``. A one-element host value
    enters by a fill kernel: copying it from pageable host memory would
    wait for the device queue (a host sync per value)."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(_as_value(v))
    if v.device.type == "cpu" and v.numel() == 1:
        if torch.device(device).type == "cpu":
            return v
        return torch.full(v.shape, v.item(), dtype=v.dtype, device=device)
    return v.to(device)


def choicemap(*pairs) -> ChoiceMap:
    """A :class:`ChoiceMap` from ``(addr, value)`` pairs (Gen's
    ``choicemap``); every entry is fully present. Python and numpy values
    are kept on the host and placed on the run's device by the verb that
    reads them."""
    if len(pairs) == 1 and isinstance(pairs[0], list):
        pairs = tuple(pairs[0])
    return ChoiceMap({normalize_address(a): (v if isinstance(v, Entry)
                                             else Entry(_as_value(v)))
                      for a, v in pairs})


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

    def int_keyed(self):
        """Entries whose first component is an int: {int: sub-Selection}."""
        out: Dict[int, Dict[Address, object]] = {}
        for k, v in self.entries.items():
            if k and isinstance(k[0], int):
                out.setdefault(k[0], {})[k[1:]] = v
        return {i: Selection(d) for i, d in out.items()}

    def str_keyed(self) -> "Selection":
        """Entries whose first component is NOT an int."""
        if self.all_:
            return ALL
        return Selection({k: v for k, v in self.entries.items()
                          if not (k and isinstance(k[0], int))})

    def mask_at_leaf(self):
        """Selection mask at the empty address: True / False / bool tensor."""
        if self.all_:
            return True
        return self.entries.get((), False)

    # tree protocol: static True/False masks are structure, not leaves
    def tree_flatten(self):
        keys = tuple(sorted(self.entries, key=repr))
        vals = [self.entries[k] for k in keys]
        static = tuple(v if isinstance(v, bool) else None for v in vals)
        return (tuple(v for v in vals if not isinstance(v, bool)),
                (keys, static, self.all_))

    @classmethod
    def tree_unflatten(cls, aux, children):
        keys, static, all_ = aux
        it = iter(children)
        return cls({k: (next(it) if s is None else s)
                    for k, s in zip(keys, static)}, all_=all_)

    def __repr__(self):
        if self.all_:
            return "Selection(ALL)"
        return f"Selection({list(self.entries.keys())})"


ALL = Selection(all_=True)
#: the empty selection
NONE = Selection()


def select(*addrs) -> Selection:
    return Selection({normalize_address(a): True for a in addrs})
