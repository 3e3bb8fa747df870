"""The CRRM compute-on-demand dependency graph ("smart update").

The paper's ``_Node`` protocol, as in ``repro.core.graph``:

* every block is a node holding a tensor;
* ``watchers`` are downstream dependents, ``watchees`` upstream inputs;
* mutating a root floods ``up_to_date = False`` downstream -- the
  invalidation phase;
* querying a terminal walks ``update()`` upstream and recomputes only
  stale nodes -- the recursive update phase.

Nodes also track *which UE rows* are dirty.  A node with a row-local
recompute patches just those rows, in place in its own tensor (the
counterpart of the JAX package's buffer donation: a tensor a query
returned is overwritten by a later row update of the same node).  Dirty
row sets are padded to power-of-two buckets with a repeated valid index
(``pad_indices``), exactly like the JAX graph.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sim.radio import pad_indices  # noqa: F401


class _AllRows:
    """Sentinel: every row is dirty (or row tracking is not applicable)."""

    def __repr__(self):  # pragma: no cover
        return "ALL"


ALL = _AllRows()


class Node:
    """Base class for all computational blocks (the paper's ``_Node``)."""

    #: subclasses that implement :meth:`update_rows` set this True
    supports_row_update = False

    def __init__(self, name: str):
        self.name = name
        self.watchers: list[Node] = []   # downstream dependents
        self.watchees: list[Node] = []   # upstream dependencies
        self.up_to_date = False
        self.dirty_rows: set | _AllRows = ALL
        self._data = None
        self.n_full_updates = 0
        self.n_row_updates = 0

    def watch(self, *nodes: "Node") -> "Node":
        for n in nodes:
            self.watchees.append(n)
            n.watchers.append(self)
        return self

    # -- invalidation phase ---------------------------------------------------
    def flood_out_of_date(self, rows=ALL) -> None:
        """Mark this node and everything downstream stale (no math here)."""
        changed = False
        if rows is ALL:
            if self.dirty_rows is not ALL:
                self.dirty_rows = ALL
                changed = True
        elif self.dirty_rows is not ALL:
            new_rows = self.dirty_rows | set(rows)
            if len(new_rows) != len(self.dirty_rows):
                self.dirty_rows = new_rows
                changed = True
        if self.up_to_date:
            self.up_to_date = False
            changed = True
        if changed:
            prop = self.propagate_rows(self.dirty_rows)
            for w in self.watchers:
                w.flood_out_of_date(prop)

    def propagate_rows(self, rows):
        """How this node's dirt maps onto its dependents' rows (default:
        row-local; nodes that mix rows return ``ALL``)."""
        return rows

    # -- recursive update phase ------------------------------------------------
    def update(self):
        """Bring this node up to date (recursively) and return its data."""
        if self.up_to_date:
            return self._data
        for w in self.watchees:
            w.update()
        rows = self.dirty_rows
        if (rows is ALL or self._data is None
                or not self.supports_row_update):
            self._data = self.update_data()
            self.n_full_updates += 1
        else:
            idx = torch.as_tensor(pad_indices(rows), dtype=torch.int64,
                                  device=self.device())
            self._data = self.update_rows(idx)
            self.n_row_updates += 1
        self.up_to_date = True
        self.dirty_rows = set()
        return self._data

    def device(self):
        d = self._data[0] if isinstance(self._data, tuple) else self._data
        return d.device

    def update_data(self):
        raise NotImplementedError(f"{self.name}.update_data")

    def update_rows(self, idx: torch.Tensor):
        raise NotImplementedError(f"{self.name}.update_rows")

    @property
    def data(self):
        return self.update()

    def __repr__(self):  # pragma: no cover
        state = "fresh" if self.up_to_date else f"stale({self.dirty_rows})"
        return f"<{type(self).__name__} {self.name} {state}>"


class RootNode(Node):
    """An input node: its data is set from outside, never computed.

    Writes replace the root's tensor with a patched copy, so a tensor read
    from a root earlier (an episode state, say) never changes under its
    holder.
    """

    def __init__(self, name: str, value=None):
        super().__init__(name)
        self._data = value
        self.up_to_date = self._data is not None
        self.dirty_rows = set()

    def set(self, value) -> None:
        """Replace the whole tensor -> flood ALL rows downstream."""
        self._data = value
        self.up_to_date = True
        for w in self.watchers:
            w.flood_out_of_date(ALL)

    def set_at(self, idx, values) -> None:
        """Element/submatrix assignment; floods ALL rows downstream."""
        data = self._data.clone()
        data[idx] = torch.as_tensor(values, dtype=data.dtype,
                                    device=data.device)
        self._data = data
        self.up_to_date = True
        for w in self.watchers:
            w.flood_out_of_date(ALL)

    def set_rows(self, idx, values) -> None:
        """Patch selected rows -> flood only those rows downstream."""
        idx = np.asarray(idx, dtype=np.int64)
        data = self._data.clone()
        data[torch.as_tensor(idx, device=data.device)] = torch.as_tensor(
            values, dtype=data.dtype, device=data.device)
        self._data = data
        rows = set(int(i) for i in idx)
        for w in self.watchers:
            w.flood_out_of_date(rows)

    def update(self):
        if self._data is None:
            raise RuntimeError(f"root node {self.name} was never set")
        return self._data

    def update_data(self):  # pragma: no cover - roots are never recomputed
        return self._data


class Graph:
    """Bookkeeping for a set of nodes + the global smart-update switch.

    ``smart=False`` is the paper's control experiment: every invalidation
    widens to ALL rows, so every stale node recomputes in full.
    """

    def __init__(self, smart: bool = True):
        self.smart = smart
        self.nodes: dict[str, Node] = {}

    def add(self, node: Node) -> Node:
        self.nodes[node.name] = node
        if not self.smart:
            node.propagate_rows = lambda rows: ALL  # type: ignore[assignment]
            node.supports_row_update = False
        return node

    def stats(self) -> dict[str, tuple[int, int]]:
        """{name: (full_updates, row_updates)} instrumentation snapshot."""
        return {k: (n.n_full_updates, n.n_row_updates)
                for k, n in self.nodes.items()}

    def invalidate_all(self) -> None:
        for n in self.nodes.values():
            if not isinstance(n, RootNode):
                n.up_to_date = False
                n.dirty_rows = ALL
