"""Observability: the in-engine per-TTI KPI telemetry
(:mod:`repro_torch.obs.telemetry`).  The reference's profiling hooks and
compiled-program reports wait for a later slice."""
from repro_torch.obs.telemetry import (Telemetry, format_summary,  # noqa: F401
                                       summarize)
