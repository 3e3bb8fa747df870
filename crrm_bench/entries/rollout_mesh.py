"""``rollout_mesh``: the ``rollout`` kind with the UE axis sharded over the
run's ranks, ``CRRM(...).episode_fns(mesh=Mesh((world,), ("ue",), device),
inc_backend=...)``, the state threaded through the calls.  Every rank is
called with the global state and hands the global state back
(``core.distributed``'s ``shard_map`` convention); the pf denominators,
the scheduler's per-cell reductions and the reassembly of the outputs are
all-reduces over the default group (NCCL on the card).

``correct`` is ``rollout``'s: rank 0's global outputs against the plain
reference (``reference/engine.py``) run on one device, so the mesh is held
to the limits of one device."""
from __future__ import annotations

from crrm_bench.entries import rollout

numbers = rollout.numbers


class Entry(rollout.Entry):
    """The TTI engine's rollout on a UE mesh of every rank."""

    spans_ranks = True

    def episode_fns(self):
        from repro_torch.core.distributed import Mesh
        mesh = Mesh((self.ranks.world,), ("ue",), self.device)
        return self.sim.episode_fns(
            mesh=mesh, inc_backend=self.traffic.get("inc_backend", "auto"))

    def dirty_rows(self, calls: int) -> float:
        """This rank's share of the window's movers: its own launches of
        the radio rows take the movers of its block of UEs."""
        return super().dirty_rows(calls) / self.ranks.world
