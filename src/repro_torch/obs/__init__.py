"""Unified telemetry (DESIGN.md §18): span tracing, counters, and the
search flight recorder — no-op by default.

``repro_torch.obs.trace``    — ``Tracer`` (nested spans with ids and
                         parents, mirrored into a recording
                         ``torch.profiler`` session as ``obs:`` ranges;
                         counters), the process-global no-op default,
                         the Chrome trace-event exporter.
``repro_torch.obs.recorder`` — ``FlightRecorder``: one structured JSONL record
                         per search trial plus run header/footer.
``repro_torch.obs.log``      — tiny level-filtered logger routed through the
                         tracer (instant events when tracing is on).
"""
from repro_torch.obs.trace import (NULL_TRACER, Counters, NullTracer, Tracer,
                             get_tracer, set_tracer, use_tracer)
from repro_torch.obs.recorder import FlightRecorder, load_run, read_records

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "Counters", "get_tracer",
           "set_tracer", "use_tracer", "FlightRecorder", "read_records",
           "load_run"]
