"""Observability plane: flight recorder, CMP protection gauges, exporters
(DESIGN.md §13).

Zero-added-atomics tracing and metrics over the whole fabric: per-replica
event rings with deterministic head-sampling (``trace_rate``), gauges read
from the domain counters the system already maintains, and exporters for
Chrome/Perfetto traces, Prometheus text exposition, and JSONL snapshots.
Wired end-to-end via ``FabricConfig(obs=ObsConfig(...))``; the
:class:`MetricsHub` rolling window is the future autoscaler's sensor
input (ROADMAP: closed-loop control plane).

The same rings hold the serving loop's step spans (``fabric.step`` >
``engine.step`` > its phases; names and nesting in
``repro_torch.obs.recorder.SPAN_PARENTS``), recorded whenever a recorder
is attached, whatever ``trace_rate``. Each recorder also keeps running
totals per span name and per counter (``host_reads``: the step's
device->host reads, counted where they happen, against the innermost open
span), which :meth:`MetricsHub.totals` sums; while a ``torch.profiler``
records, each span is a ``repro.<span>`` range on the device trace's
timeline. ``perfetto_trace`` draws the spans as nested slices.
"""

from repro_torch.obs.export import (append_jsonl_snapshot, format_class_lines,
                              perfetto_trace, prometheus_text,
                              stage_breakdown, strip_samples)
from repro_torch.obs.gauges import (flatten_gauges, sample_admission_ring,
                              sample_class_shards, sample_cmp_shard,
                              sample_fabric_gauges, sample_transport)
from repro_torch.obs.hub import MetricsHub
from repro_torch.obs.recorder import (CLAIM_BLOCK, COMPLETE, CONTROL,
                                CONTROL_EVENTS, DECODE, DRAIN, FLUSH,
                                LANE_PREFILL, LIFECYCLE_STAGES,
                                PRODUCER_RID, REQUEUE, RESCUE, SEAT,
                                SHARD_ENQUEUE, STEAL, SUBMIT, WINDOW_ADMIT,
                                FlightRecorder, ObsConfig, sample_stride)

__all__ = [
    "ObsConfig", "FlightRecorder", "MetricsHub", "sample_stride",
    "LIFECYCLE_STAGES", "CONTROL_EVENTS", "PRODUCER_RID",
    "SUBMIT", "WINDOW_ADMIT", "SHARD_ENQUEUE", "DRAIN", "SEAT",
    "LANE_PREFILL", "DECODE", "COMPLETE",
    "STEAL", "REQUEUE", "RESCUE", "CLAIM_BLOCK", "FLUSH", "CONTROL",
    "perfetto_trace", "prometheus_text", "stage_breakdown",
    "append_jsonl_snapshot", "strip_samples", "format_class_lines",
    "sample_cmp_shard", "sample_class_shards", "sample_admission_ring",
    "sample_transport", "sample_fabric_gauges", "flatten_gauges",
]
