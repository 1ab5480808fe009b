"""Discrete-event deployment simulator (DESIGN.md §13).

The layer between search and serving: seeded request traces
(``sim.trace``), an event-driven simulator of a partitioned multi-chip
dataflow deployment (``sim.engine``), and SLO-aware partition selection
(``sim.slo`` — wired into ``partition_pipeline(objective="slo")`` and the
``hass_search`` Eq. 6 lambdas).
"""
from repro_torch.sim.engine import (SIM_TOL, SimReport, saturation_throughput,
                              simulate_partition)
from repro_torch.sim.faults import (FaultTrace, inject_faults, replica_loss,
                              zero_fault_trace)
from repro_torch.sim.slo import (SLO, SimLatencyEvaluator,
                           autoscale_policy_search, latency_percentile,
                           slo_partition_search)
from repro_torch.sim.trace import (Trace, backlogged_trace, bucket_sizes,
                             diurnal_trace, mmpp_trace, poisson_trace,
                             replay_trace, request_rate)

__all__ = [
    "SIM_TOL", "SimReport", "saturation_throughput", "simulate_partition",
    "FaultTrace", "inject_faults", "replica_loss", "zero_fault_trace",
    "SLO", "SimLatencyEvaluator", "autoscale_policy_search",
    "latency_percentile",
    "slo_partition_search", "Trace", "backlogged_trace", "bucket_sizes",
    "diurnal_trace", "mmpp_trace", "poisson_trace", "replay_trace",
    "request_rate",
]
