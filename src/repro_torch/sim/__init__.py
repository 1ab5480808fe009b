"""Deployment simulation of the port. So far the seeded request traces
(``sim.trace``) that drive the serving loop; the event engine, fault
injection and SLO search follow (see ROADMAP.md)."""
from repro_torch.sim.trace import (Trace, backlogged_trace, bucket_sizes,
                                   diurnal_trace, mmpp_trace, poisson_trace,
                                   replay_trace, request_rate)

__all__ = [
    "Trace", "backlogged_trace", "bucket_sizes", "diurnal_trace",
    "mmpp_trace", "poisson_trace", "replay_trace", "request_rate",
]
