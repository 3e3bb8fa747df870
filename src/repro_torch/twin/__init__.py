"""Digital-twin serving: a long-running simulation server over the engine.

``repro_torch.twin.server`` hosts :class:`TwinServer` -- chunked stepping
of the TTI engine under a birth-death UE process, with streaming KPI
summaries, live control updates (cell power, scheduler fairness),
checkpoint/restore and an optional self-healing watchdog.
"""

__all__ = ["TwinServer"]


def __getattr__(name):
    # lazy: keeps ``python -m repro_torch.twin.server`` free of the runpy
    # double-import warning while ``from repro_torch.twin import
    # TwinServer`` works
    if name == "TwinServer":
        from repro_torch.twin.server import TwinServer
        return TwinServer
    raise AttributeError(name)
