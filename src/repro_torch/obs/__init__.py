"""Observability: the in-engine per-TTI KPI telemetry
(:mod:`repro_torch.obs.telemetry`), the profiling hooks
(:mod:`repro_torch.obs.profile`) and the episode reports
(:mod:`repro_torch.obs.report`)."""
from repro_torch.obs.profile import StageTimer, annotate, trace  # noqa: F401
from repro_torch.obs.telemetry import (Telemetry, format_summary,  # noqa: F401
                                       summarize)
