"""Deploy bundle generator — config, units, scrape config, dashboards.

Reference parity: installer/helm/ (chart with values + CRDs) and
benchmark/manifests/monitoring/ (Grafana + Prometheus manifests for
the exported metric families).  volcano-tpu is a standalone control
plane, so its "chart" is a rendered directory an operator can run
as-is: systemd units OR a docker-compose file (both rendered from the
same values), the scheduler conf, a generated cluster bearer token,
a Prometheus scrape config that carries that token, and Grafana
dashboard JSON over the families volcano_tpu_torch.metrics actually
exports.

    python -m volcano_tpu_torch.bundle --out ./bundle \
        --topology nvl-a:dgx-h100-256@ib-0,h0:hgx-h100-8@ib-1 --port 8700

renders:
    bundle/
      values.json            the resolved values (re-render input)
      token                  cluster bearer token (0600)
      scheduler.conf.yaml    actions/tiers the scheduler loads
      topology.json          NVLink domains and their IB fabrics,
                             consumed by cluster-init
      cluster-init.sh        registers the nodes via vtpctl
      systemd/*.service      one unit per role
      docker-compose.yaml    same roles as containers
      prometheus.yml         scrape config (bearer token wired)
      grafana/*.json         dashboards over the exported families
      README.md              bring-up order
"""

from __future__ import annotations

import argparse
import json
import os
import secrets
from typing import Dict, List

# Every metric family the control plane exports, by type — dashboards
# are generated from (and tests validated against) THIS table, so a
# renamed family breaks the build, not the operator's dashboard.
# Histogram-typed families export <name>_count / <name>_sum.
FAMILIES: Dict[str, str] = {
    # scheduler core (metrics.py call sites)
    "e2e_scheduling_latency_seconds": "histogram",
    "pod_scheduling_latency_seconds": "histogram",
    "task_scheduling_latency_seconds": "histogram",
    "predicate_sweep_seconds": "histogram",
    # process-pool sweep backend (actions/procpool.py): mirror sync
    # traffic, pool self-healing and the staleness-refusal contract
    "sweep_snapshot_delta_bytes_total": "counter",
    "sweep_worker_restarts_total": "counter",
    "sweep_stale_refusals_total": "counter",
    "action_latency_seconds": "histogram",
    "plugin_latency_seconds": "histogram",
    "open_session_duration_seconds": "histogram",
    "schedule_attempts_total": "counter",
    "unschedule_job_count": "gauge",
    "unschedule_task_count": "gauge",
    "job_retry_counts": "counter",
    # preemption / reclaim
    "pod_preemption_total": "counter",
    "preemption_victims_total": "counter",
    "gang_preemption_total": "counter",
    "pod_reclaim_total": "counter",
    "reclaim_commits_total": "counter",
    "shuffle_victims_total": "counter",
    # fair share — proportion exports deserved/allocated/request and
    # capacity exports real_capacity/inqueue/capacity/overused, each
    # resource vector as the three per-dimension gauges
    # (metrics.resource_gauge_rows); every generated name is declared
    # here or vtplint's family-coverage check fails the build
    "job_share": "gauge",
    "queue_share": "gauge",
    "queue_weight": "gauge",
    "queue_overused": "gauge",
    "queue_allocated_milli_cpu": "gauge",
    "queue_allocated_memory_bytes": "gauge",
    "queue_allocated_scalar_resources": "gauge",
    "queue_deserved_milli_cpu": "gauge",
    "queue_deserved_memory_bytes": "gauge",
    "queue_deserved_scalar_resources": "gauge",
    "queue_request_milli_cpu": "gauge",
    "queue_request_memory_bytes": "gauge",
    "queue_request_scalar_resources": "gauge",
    "queue_real_capacity_milli_cpu": "gauge",
    "queue_real_capacity_memory_bytes": "gauge",
    "queue_real_capacity_scalar_resources": "gauge",
    "queue_inqueue_milli_cpu": "gauge",
    "queue_inqueue_memory_bytes": "gauge",
    "queue_inqueue_scalar_resources": "gauge",
    "queue_capacity_milli_cpu": "gauge",
    "queue_capacity_memory_bytes": "gauge",
    "queue_capacity_scalar_resources": "gauge",
    # agent scheduler (fast path)
    "agent_pod_e2e_latency_seconds": "histogram",
    "agent_bind_conflicts_total": "counter",
    "agent_unschedulable_total": "counter",
    # audit-derived latency exporter (server/audit_exporter.py): job
    # submit -> terminal phase, the batchjob completion analogue
    "batchjob_completion_latency_seconds": "histogram",
    # client mirror resync paths (cache/remote_cluster.py): how a
    # mirror recovered — delta catch-up, refused-stale re-route, or a
    # full re-list (bounded mode enum)
    "mirror_resync_total": "counter",
    # node-agent DCN bandwidth accounting (agent/handlers.py
    # netaccounting: measured per-pod rates + watermark violations)
    "pod_dcn_tx_mbps": "gauge",
    "pod_dcn_rx_mbps": "gauge",
    "node_dcn_measured_mbps": "gauge",
    "bandwidth_violating_pods": "gauge",
    "bandwidth_violations_total": "counter",
    # slice-failure failover (controllers/failover.py): the detect ->
    # drain -> reschedule -> resume loop, each phase timed, plus the
    # end-to-end MTTR and the checkpoint recompute window
    "failover_detect_seconds": "histogram",
    "failover_drain_seconds": "histogram",
    "failover_reschedule_seconds": "histogram",
    "failover_resume_seconds": "histogram",
    "failover_mttr_seconds": "histogram",
    "failover_resume_step_gap": "histogram",
    "slice_failovers_total": "counter",
    "quarantined_slices": "gauge",
    # state-server durability (server/durability.py): the WAL journal-
    # before-ack loop, snapshot compaction cadence, and boot replay
    "server_wal_fsync_seconds": "histogram",
    "server_wal_records": "gauge",
    "server_wal_bytes": "gauge",
    "server_snapshot_seconds": "histogram",
    "server_snapshot_total": "counter",
    "server_snapshot_rv": "gauge",
    "server_replay_seconds": "histogram",
    "server_replay_records": "gauge",
    # replicated control plane (server/replication.py): shipping
    # volume, follower lag, promotions, role — labels bounded (the
    # role enum and the operator-configured replica ids, never
    # job/pod/node keys)
    "server_replication_lag_seconds": "gauge",
    "server_replication_applied_rv": "gauge",
    "server_replication_last_shipped_rv": "gauge",
    "server_replication_follower_lag_rv": "gauge",
    "server_replication_shipped_records_total": "counter",
    "server_replication_shipped_bytes_total": "counter",
    "server_replication_promotions_total": "counter",
    "server_replication_bootstraps_total": "counter",
    "server_replication_refused_batches_total": "counter",
    "server_replication_role": "gauge",
    "server_replication_term": "gauge",
    # client wire resilience: every transient retry the unified
    # backoff policy performs, labeled by route
    "client_retries_total": "counter",
    # gray-failure chaos engine (volcano_tpu_torch/faults.py +
    # docs/design/chaos.md): every injected fault counted by bounded
    # site/kind enums, the read-only degrade flag (1 while the WAL is
    # poisoned and writes 503), and WAL records dropped by bounded
    # reason (readonly, append-error, duplicate-seq, force-truncate)
    "fault_injected_total": "counter",
    "server_readonly": "gauge",
    "server_wal_dropped_records_total": "counter",
    # scheduling flight recorder (trace.py): per-phase lifecycle
    # segments (created->enqueued->allocated->bound->admitted->
    # running, plus the telescoped e2e), span time by action/plugin,
    # kept-trace accounting, and the normalized unschedulable-reason
    # tallies (label values are the bounded REASON_ENUM — free text
    # never labels a metric)
    "sched_phase_seconds": "histogram",
    "sched_span_seconds": "histogram",
    "sched_traces_total": "counter",
    "sched_unschedulable_reasons_total": "counter",
    # sharded planes (actions/gangcommit.py + cache/partitioned.py):
    # one observation per spec drained as a batch, and every bind the
    # server's check-and-bind refused to a losing scheduler shard,
    # counted by the bounded outcome enum (refused = per-item 409,
    # requeued = the loser re-queued the gang for its next cycle)
    "sched_gang_commit_seconds": "histogram",
    "sched_cross_shard_conflicts_total": "counter",
    # elastic gangs (actions/elastic.py decisions, controllers/
    # elastic.py execution): every label is the bounded resize-kind
    # enum (grow|shrink|migrate) — job keys and slice names never
    # label these families (the bounded-cardinality rule)
    "elastic_decisions_total": "counter",
    "elastic_resizes_total": "counter",
    "elastic_resize_seconds": "histogram",
    "elastic_drain_seconds": "histogram",
    "elastic_shrink_seconds": "histogram",
    "elastic_migration_mttr_seconds": "histogram",
    "elastic_resume_step_gap": "histogram",
    "elastic_jobs": "gauge",
    "elastic_slices_total": "gauge",
    # goodput observatory (volcano_tpu_torch/goodput.py + agent goodput
    # handler): measured fleet throughput, learned-vector update
    # tally, grow-gate decisions, NVLink-domain fragmentation and per-queue
    # starvation — labels are bounded (generation enum,
    # allowed|declined, operator queue config; never job/pod/node)
    "goodput_jobs": "gauge",
    "goodput_fleet_steps_per_second": "gauge",
    "goodput_fraction": "gauge",
    "goodput_vector_updates_total": "counter",
    "goodput_gated_grows_total": "counter",
    "frag_index": "gauge",
    "frag_idle_chips": "gauge",
    "frag_largest_block_chips": "gauge",
    "starvation_age_seconds": "gauge",
    "starvation_pending_gangs": "gauge",
    # serving plane (controllers/serving.py + agent serving handler +
    # actions/elastic.py burst preemption): group census, folded fleet
    # QPS, worst-group SLO attainment, scale decisions (bounded
    # up|down enum) and serving-funded victim shrinks — never
    # group/pod/node labels
    "serving_groups": "gauge",
    "serving_qps_total": "gauge",
    "serving_slo_attainment_min": "gauge",
    "serving_scale_decisions_total": "counter",
    "serving_victim_shrinks_total": "counter",
    # federation tier (federation/router.py + federation/mirror.py):
    # region census by bounded state enum, per-region capacity and
    # learned goodput (region names are operator config), global-queue
    # depth, admission/requeue/migration tallies, the cutover timing
    # and its stale-mirror refusals, and the async object mirror's
    # stream accounting — job keys never label these families
    "federation_regions": "gauge",
    "federation_pending_jobs": "gauge",
    "federation_region_capacity_chips": "gauge",
    "federation_region_idle_chips": "gauge",
    "federation_region_goodput_steps_per_chip": "gauge",
    "federation_admissions_total": "counter",
    "federation_requeues_total": "counter",
    "federation_migrations_total": "counter",
    "federation_cutover_seconds": "histogram",
    "federation_cutover_refusals_total": "counter",
    "federation_source_reaps_total": "counter",
    "federation_mirror_records_total": "counter",
    "federation_mirror_resyncs_total": "counter",
    "federation_mirror_delta_resyncs_total": "counter",
    "federation_mirror_refused_batches_total": "counter",
    # router HA (federation/ha.py + federation/retry.py + the server
    # fence): leadership + lease term, adoption passes, the shared
    # cross-region RPC policy's failure/skip tallies, per-region
    # breaker state (bounded closed|open|half-open code), serving QPS
    # headroom folded into routing, and writes refused by the
    # term fence — region names and lease names are operator config
    "federation_router_is_leader": "gauge",
    "federation_router_term": "gauge",
    "federation_router_adoptions_total": "counter",
    "federation_router_rpc_failures_total": "counter",
    "federation_router_rpc_skipped_total": "counter",
    "federation_router_breaker_opens_total": "counter",
    "federation_router_breaker_state": "gauge",
    "federation_region_serving_headroom": "gauge",
    "fenced_writes_total": "counter",
    # fleet observability (federation/stitch.py + federation/slo.py +
    # router._observability): stitched-trace tally, observed mirror
    # staleness, per-region breaker detail (learned region health a
    # promoted standby adopts), per-region rollups of the bounded
    # family set (the `family` label is closed over this very schema),
    # rollup scrape failures, and the multi-window SLO burn-rate
    # gauges — episode IDs and job keys NEVER label any of these
    "federation_stitched_traces_total": "counter",
    "federation_mirror_staleness_seconds": "gauge",
    "federation_router_breaker_failures": "gauge",
    "federation_router_breaker_half_opens": "gauge",
    "federation_router_breaker_opens": "gauge",
    "federation_router_breaker_last_trip_ts": "gauge",
    "federation_router_breaker_retry_in_seconds": "gauge",
    "federation_rollup_scrape_failures_total": "counter",
    "federation_rollup_sum": "gauge",
    "federation_rollup_max": "gauge",
    "federation_rollup_count": "gauge",
    "slo_burn_rate": "gauge",
}

# the rollup's `family` label value set IS the family schema: closed
# by construction, so fleet-wide aggregation can never mint an
# unbounded label value
ROLLUP_FAMILY_ENUM = tuple(FAMILIES)

# -- label schema (enforced by volcano_tpu_torch/analysis + tests/test_lint) --
#
# Every family's ALLOWED label keys, and what may appear as a value:
#   a tuple                  closed enum, values must be members
#   "enum:<module>:<NAME>"   closed enum resolved lazily from code (the
#                            single source of truth stays next to the
#                            subsystem that owns it)
#   CONFIG                   operator-bounded value (queue names, node
#                            names, replica ids, wire routes, resource
#                            dimensions): cardinality is capped by the
#                            deployment's configuration, not by
#                            workload churn
#   OBJECT                   per-object key (job keys, pod keys).  Only
#                            legal on families with a declared deletion
#                            lifecycle (swap_gauge_families scope swap
#                            or metrics.delete_labeled on object
#                            removal) — anything else would mint one
#                            immortal series per job forever.
#
# A family absent from this table carries NO labels.  The static half
# (analysis/astlint.py metric-family/metric-labels rules) checks call
# sites; the runtime half (analysis/schema.check_exposition) checks a
# live exposition — together they subsume the three per-PR label-
# cardinality tests this table replaced.
CONFIG = "config"
OBJECT = "object"

FAMILY_LABELS: Dict[str, Dict[str, object]] = {
    "task_scheduling_latency_seconds": {"action": CONFIG},
    "predicate_sweep_seconds": {"mode": ("serial", "thread",
                                         "process")},
    "sweep_snapshot_delta_bytes_total": {
        "kind": ("full", "delta", "ops")},
    "sweep_worker_restarts_total": {
        "reason": ("crash", "timeout")},
    "sweep_stale_refusals_total": {},
    "action_latency_seconds": {"action": CONFIG},
    "plugin_latency_seconds": {"plugin": CONFIG,
                               "point": ("open", "close")},
    "schedule_attempts_total": {"result": ("scheduled", "error")},
    "job_retry_counts": {"job": OBJECT},
    # fair share: job_share is the per-object gauge precedent — swapped
    # wholesale each session and delete_labeled on GC (metrics/job.go)
    "job_share": {"job": OBJECT},
    "queue_share": {"queue": CONFIG},
    "queue_weight": {"queue": CONFIG},
    "queue_overused": {"queue": CONFIG},
    **{f"queue_{m}{s}": ({"queue": CONFIG, "resource": CONFIG}
                         if s == "_scalar_resources"
                         else {"queue": CONFIG})
       for m in ("allocated", "deserved", "request", "real_capacity",
                 "inqueue", "capacity")
       for s in ("_milli_cpu", "_memory_bytes", "_scalar_resources")},
    # node-agent bandwidth accounting: per-pod gauges live inside a
    # per-node scope swap (handlers.py), so pod keys have a deletion
    # lifecycle; tier is the offline/online DCN split
    "pod_dcn_tx_mbps": {"pod": OBJECT, "node": CONFIG,
                        "tier": ("offline", "online")},
    "pod_dcn_rx_mbps": {"pod": OBJECT, "node": CONFIG,
                        "tier": ("offline", "online")},
    "node_dcn_measured_mbps": {"node": CONFIG,
                               "tier": ("offline", "online")},
    "bandwidth_violating_pods": {"node": CONFIG},
    "bandwidth_violations_total": {"pod": OBJECT, "node": CONFIG},
    # failover: slice names are topology configuration
    "slice_failovers_total": {"slice": CONFIG},
    "failover_detect_seconds": {"slice": CONFIG},
    "failover_drain_seconds": {"slice": CONFIG},
    "failover_reschedule_seconds": {"slice": CONFIG},
    "failover_resume_seconds": {"slice": CONFIG},
    "failover_mttr_seconds": {"slice": CONFIG},
    "failover_resume_step_gap": {"slice": CONFIG},
    # durability / replication
    "server_wal_dropped_records_total": {
        "reason": ("readonly", "append-error", "duplicate-seq",
                   "force-truncate")},
    "server_replication_role": {
        "role": ("leader", "follower", "candidate")},
    "server_replication_follower_lag_rv": {"follower": CONFIG},
    # client wire
    "client_retries_total": {"route": CONFIG},
    "mirror_resync_total": {"mode": ("delta", "stale-refused", "full")},
    # chaos engine
    "fault_injected_total": {"site": "enum:volcano_tpu_torch.faults:SITES",
                             "kind": "enum:volcano_tpu_torch.faults:ALL_KINDS"},
    # flight recorder: bounded enums only, free text never labels
    "sched_phase_seconds": {
        "phase": ("queue", "schedule", "bind", "admit", "start", "e2e")},
    "sched_span_seconds": {"action": CONFIG, "plugin": CONFIG,
                           "point": CONFIG},
    "sched_traces_total": {
        "kept": ("error", "unschedulable", "slow", "sampled")},
    "sched_unschedulable_reasons_total": {
        "reason": "enum:volcano_tpu_torch.trace:REASON_ENUM"},
    "sched_cross_shard_conflicts_total": {
        "outcome": ("refused", "requeued")},
    # elastic gangs: the bounded resize-kind enum, never job keys
    "elastic_decisions_total": {
        "kind": "enum:volcano_tpu_torch.api.elastic:RESIZE_KINDS"},
    "elastic_resizes_total": {
        "kind": "enum:volcano_tpu_torch.api.elastic:RESIZE_KINDS"},
    "elastic_resize_seconds": {
        "kind": "enum:volcano_tpu_torch.api.elastic:RESIZE_KINDS"},
    "elastic_drain_seconds": {
        "kind": "enum:volcano_tpu_torch.api.elastic:RESIZE_KINDS"},
    # goodput observatory
    "goodput_vector_updates_total": {
        "generation": "enum:volcano_tpu_torch.api.goodput:GENERATIONS"},
    "goodput_gated_grows_total": {
        "decision": "enum:volcano_tpu_torch.goodput:GATE_DECISIONS"},
    "frag_index": {"generation": "enum:volcano_tpu_torch.api.goodput:"
                                 "GENERATIONS"},
    "frag_idle_chips": {"generation": "enum:volcano_tpu_torch.api.goodput:"
                                      "GENERATIONS"},
    "frag_largest_block_chips": {
        "generation": "enum:volcano_tpu_torch.api.goodput:GENERATIONS"},
    "starvation_age_seconds": {"queue": CONFIG},
    "starvation_pending_gangs": {"queue": CONFIG},
    # serving plane: the bounded scale-direction enum, never group keys
    "serving_scale_decisions_total": {
        "kind": "enum:volcano_tpu_torch.api.serving:SCALE_KINDS"},
    # federation tier: region names are operator configuration (the
    # registry), states/kinds bounded enums — never job keys
    "federation_regions": {
        "state": "enum:volcano_tpu_torch.api.federation:REGION_STATES"},
    "federation_region_capacity_chips": {"region": CONFIG},
    "federation_region_idle_chips": {"region": CONFIG},
    "federation_region_goodput_steps_per_chip": {"region": CONFIG},
    "federation_admissions_total": {"region": CONFIG},
    "federation_requeues_total": {"region": CONFIG},
    "federation_migrations_total": {
        "kind": ("pending", "running")},
    "federation_cutover_refusals_total": {"region": CONFIG},
    "federation_source_reaps_total": {"region": CONFIG},
    "federation_mirror_records_total": {"region": CONFIG},
    "federation_mirror_resyncs_total": {"region": CONFIG},
    "federation_mirror_delta_resyncs_total": {"region": CONFIG},
    "federation_mirror_refused_batches_total": {"region": CONFIG},
    # router HA: regions are registry config; `op` is the router's
    # closed set of mutating RPC verbs (code, not workload); `fence`
    # is a lease name (operator config, e.g. federation-router)
    "federation_router_rpc_failures_total": {"region": CONFIG,
                                             "op": CONFIG},
    "federation_router_rpc_skipped_total": {"region": CONFIG},
    "federation_router_breaker_opens_total": {"region": CONFIG},
    "federation_router_breaker_state": {"region": CONFIG},
    "federation_region_serving_headroom": {"region": CONFIG},
    "fenced_writes_total": {"fence": CONFIG},
    # fleet observability: staleness + breaker detail are per-region
    # (registry config); the rollups add ONLY (family, region) with
    # `family` closed over the schema itself; the SLO burn labels are
    # the closed enums owned by federation/slo.py.  Episode IDs are
    # annotation/trace-label values only — never metric labels.
    "federation_mirror_staleness_seconds": {"region": CONFIG},
    "federation_router_breaker_failures": {"region": CONFIG},
    "federation_router_breaker_half_opens": {"region": CONFIG},
    "federation_router_breaker_opens": {"region": CONFIG},
    "federation_router_breaker_last_trip_ts": {"region": CONFIG},
    "federation_router_breaker_retry_in_seconds": {"region": CONFIG},
    "federation_rollup_scrape_failures_total": {"region": CONFIG},
    "federation_rollup_sum": {
        "family": "enum:volcano_tpu_torch.bundle:ROLLUP_FAMILY_ENUM",
        "region": CONFIG},
    "federation_rollup_max": {
        "family": "enum:volcano_tpu_torch.bundle:ROLLUP_FAMILY_ENUM",
        "region": CONFIG},
    "federation_rollup_count": {
        "family": "enum:volcano_tpu_torch.bundle:ROLLUP_FAMILY_ENUM",
        "region": CONFIG},
    "slo_burn_rate": {
        "slo": "enum:volcano_tpu_torch.federation.slo:SLO_NAMES",
        "window": "enum:volcano_tpu_torch.federation.slo:SLO_WINDOWS"},
}


def _mean_expr(family: str) -> str:
    return (f"rate({family}_sum[5m]) / "
            f"clamp_min(rate({family}_count[5m]), 1e-9)")


def _panel(panel_id: int, title: str, exprs: List[str], x: int, y: int,
           unit: str = "short") -> dict:
    return {
        "id": panel_id, "type": "timeseries", "title": title,
        "gridPos": {"h": 8, "w": 12, "x": x, "y": y},
        "fieldConfig": {"defaults": {"unit": unit}, "overrides": []},
        "targets": [{"expr": e, "refId": chr(ord("A") + i)}
                    for i, e in enumerate(exprs)],
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
    }


def scheduler_dashboard() -> dict:
    """Latency + throughput + fairness over the scheduler families."""
    panels = [
        _panel(1, "End-to-end scheduling latency (mean)",
               [_mean_expr("e2e_scheduling_latency_seconds"),
                _mean_expr("pod_scheduling_latency_seconds")],
               0, 0, unit="s"),
        _panel(2, "Action latency by action (mean)",
               [f"sum by (action) (rate(action_latency_seconds_sum[5m]))"
                f" / sum by (action) "
                f"(clamp_min(rate(action_latency_seconds_count[5m]),"
                f" 1e-9))"], 12, 0, unit="s"),
        _panel(3, "Plugin latency by plugin (mean)",
               [f"sum by (plugin) (rate(plugin_latency_seconds_sum[5m]))"
                f" / sum by (plugin) "
                f"(clamp_min(rate(plugin_latency_seconds_count[5m]),"
                f" 1e-9))"], 0, 8, unit="s"),
        _panel(4, "Schedule attempts / retries",
               ["rate(schedule_attempts_total[5m])",
                "rate(job_retry_counts[5m])"], 12, 8),
        _panel(5, "Unschedulable jobs / tasks",
               ["unschedule_job_count", "unschedule_task_count"],
               0, 16),
        _panel(6, "Preemption + reclaim activity",
               ["rate(pod_preemption_total[5m])",
                "rate(preemption_victims_total[5m])",
                "rate(gang_preemption_total[5m])",
                "rate(pod_reclaim_total[5m])",
                "rate(shuffle_victims_total[5m])"], 12, 16),
        _panel(7, "Queue dominant share vs weight",
               ["queue_share", "queue_weight"], 0, 24),
        _panel(8, "Queue allocated mCPU / GPUs",
               ["queue_allocated_milli_cpu",
                "queue_allocated_scalar_resources"], 12, 24),
        _panel(9, "State-server durability (mean)",
               [_mean_expr("server_wal_fsync_seconds"),
                _mean_expr("server_snapshot_seconds"),
                _mean_expr("server_replay_seconds")], 0, 32,
               unit="s"),
        _panel(10, "WAL backlog + wire retries",
               ["server_wal_records",
                "rate(server_snapshot_total[5m])",
                "sum by (route) (rate(client_retries_total[5m]))"],
               12, 32),
        # latency waterfall: one series per lifecycle phase, stacked
        # in the panel they sum to the e2e series — where a pod's
        # seconds went (queue / schedule / bind / admit / start)
        _panel(11, "Lifecycle phase waterfall (mean)",
               ["sum by (phase) (rate(sched_phase_seconds_sum[5m]))"
                " / sum by (phase) "
                "(clamp_min(rate(sched_phase_seconds_count[5m]),"
                " 1e-9))"], 0, 40, unit="s"),
        _panel(12, "Span time by action / plugin (mean)",
               ["sum by (action) (rate(sched_span_seconds_sum[5m]))"
                " / sum by (action) "
                "(clamp_min(rate(sched_span_seconds_count[5m]),"
                " 1e-9))",
                "sum by (plugin, point) "
                "(rate(sched_span_seconds_sum[5m])) / "
                "sum by (plugin, point) "
                "(clamp_min(rate(sched_span_seconds_count[5m]),"
                " 1e-9))"], 12, 40, unit="s"),
        _panel(13, "Unschedulable reasons (normalized enum)",
               ["sum by (reason) "
                "(rate(sched_unschedulable_reasons_total[5m]))",
                "sum by (kept) (rate(sched_traces_total[5m]))"],
               0, 48),
        _panel(14, "Elastic resize latency by kind (mean)",
               ["sum by (kind) (rate(elastic_resize_seconds_sum[5m]))"
                " / sum by (kind) "
                "(clamp_min(rate(elastic_resize_seconds_count[5m]),"
                " 1e-9))",
                _mean_expr("elastic_shrink_seconds"),
                _mean_expr("elastic_migration_mttr_seconds")],
               12, 48, unit="s"),
        _panel(15, "Elastic gangs / slices / decisions",
               ["elastic_jobs", "elastic_slices_total",
                "sum by (kind) (rate(elastic_decisions_total[5m]))",
                "sum by (kind) (rate(elastic_resizes_total[5m]))",
                _mean_expr("elastic_resume_step_gap")], 0, 56),
        # goodput observatory: measured fleet throughput + goodput
        # fraction, learned-vector updates and the grow-gate verdicts
        _panel(16, "Goodput: fleet steps/s, fraction, gated grows",
               ["goodput_fleet_steps_per_second", "goodput_jobs",
                "goodput_fraction",
                "sum by (generation) "
                "(rate(goodput_vector_updates_total[5m]))",
                "sum by (decision) "
                "(rate(goodput_gated_grows_total[5m]))"], 12, 56),
        _panel(17, "NVLink-domain fragmentation / queue starvation",
               ["frag_index",
                "sum by (generation) (frag_idle_chips)",
                "sum by (generation) (frag_largest_block_chips)",
                "max by (queue) (starvation_age_seconds)",
                "sum by (queue) (starvation_pending_gangs)"], 0, 64),
        # replicated control plane: who leads at what term, how far
        # each replica trails (the divergence an operator must see
        # before it pages them), shipping volume, and the
        # promotion/bootstrap/refusal event counters
        _panel(18, "Control-plane replication: role / term / lag",
               ["sum by (role) (server_replication_role)",
                "server_replication_term",
                "server_replication_lag_seconds",
                "max by (follower) "
                "(server_replication_follower_lag_rv)"], 12, 64),
        _panel(19, "WAL shipping + promotions",
               ["rate(server_replication_shipped_records_total[5m])",
                "rate(server_replication_shipped_bytes_total[5m])",
                "rate(server_replication_promotions_total[5m])",
                "rate(server_replication_bootstraps_total[5m])",
                "rate(server_replication_refused_batches_total[5m])"],
               0, 72),
        # parallel scheduler cycle: sweep latency by backend, mirror
        # sync traffic by kind, and the pool's self-healing/staleness
        # counters — the waterfall an operator reads when a cycle's
        # fan-out stops paying for itself
        _panel(20, "Predicate sweep: latency by mode / mirror sync",
               ["sum by (mode) "
                "(rate(predicate_sweep_seconds_sum[5m])) / sum by "
                "(mode) (clamp_min("
                "rate(predicate_sweep_seconds_count[5m]), 1e-9))",
                "sum by (kind) "
                "(rate(sweep_snapshot_delta_bytes_total[5m]))",
                "sum by (reason) "
                "(rate(sweep_worker_restarts_total[5m]))",
                "rate(sweep_stale_refusals_total[5m])"], 12, 72),
    ]
    return {
        "title": "volcano-tpu / scheduler", "uid": "vtp-scheduler",
        "timezone": "browser", "schemaVersion": 39, "version": 1,
        "refresh": "10s", "panels": panels,
        "templating": {"list": [{
            "name": "datasource", "type": "datasource",
            "query": "prometheus"}]},
    }


def agent_dashboard() -> dict:
    """Fast-path + session health over the agent families."""
    panels = [
        _panel(1, "Agent-scheduler pod e2e latency (mean)",
               [_mean_expr("agent_pod_e2e_latency_seconds")], 0, 0,
               unit="s"),
        _panel(2, "Bind conflicts / unschedulable (fast path)",
               ["rate(agent_bind_conflicts_total[5m])",
                "rate(agent_unschedulable_total[5m])"], 12, 0),
        _panel(3, "Session open duration (mean)",
               [_mean_expr("open_session_duration_seconds")], 0, 8,
               unit="s"),
        _panel(4, "Per-job dominant share",
               ["topk(20, job_share)"], 12, 8),
        _panel(5, "DCN measured bandwidth by node/tier (mbps)",
               ["sum by (node, tier) (node_dcn_measured_mbps)",
                "topk(20, pod_dcn_tx_mbps)"], 0, 16),
        _panel(6, "Bandwidth watermark violations",
               ["sum by (node) (bandwidth_violating_pods)",
                "rate(bandwidth_violations_total[5m])"], 12, 16),
        _panel(7, "Slice failover MTTR breakdown (mean)",
               [_mean_expr("failover_mttr_seconds"),
                _mean_expr("failover_detect_seconds"),
                _mean_expr("failover_drain_seconds"),
                _mean_expr("failover_reschedule_seconds"),
                _mean_expr("failover_resume_seconds")], 0, 24,
               unit="s"),
        _panel(8, "Slice failures / quarantined slices / resume gap",
               ["rate(slice_failovers_total[5m])",
                "quarantined_slices",
                _mean_expr("failover_resume_step_gap")], 12, 24),
    ]
    return {
        "title": "volcano-tpu / agents", "uid": "vtp-agents",
        "timezone": "browser", "schemaVersion": 39, "version": 1,
        "refresh": "10s", "panels": panels,
        "templating": {"list": [{
            "name": "datasource", "type": "datasource",
            "query": "prometheus"}]},
    }


def federation_dashboard() -> dict:
    """Fleet rollups + SLO burn over the router-side families: every
    panel reads the LEASEHOLDER ROUTER's /metrics (the only process
    that sees all regions), so one Grafana datasource covers the
    federation without scraping N regional planes."""
    panels = [
        # burn > 1.0 sustained = the SLO will be missed; the two
        # windows make fast-burn pages and slow-burn tickets
        _panel(1, "SLO burn rate by SLO x window",
               ["slo_burn_rate"], 0, 0),
        _panel(2, "Mirror staleness by region",
               ["federation_mirror_staleness_seconds"], 12, 0,
               unit="s"),
        _panel(3, "Region breaker state",
               ["federation_router_breaker_failures",
                "federation_router_breaker_opens",
                "federation_router_breaker_half_opens",
                "federation_router_breaker_retry_in_seconds"], 0, 8),
        _panel(4, "Fleet scheduling latency rollup (per region)",
               ["sum by (region) (federation_rollup_sum{family="
                "\"e2e_scheduling_latency_seconds\"}) / clamp_min("
                "sum by (region) (federation_rollup_count{family="
                "\"e2e_scheduling_latency_seconds\"}), 1e-9)"],
               12, 8, unit="s"),
        _panel(5, "Fleet failover MTTR rollup (per region)",
               ["sum by (region) (federation_rollup_sum{family="
                "\"failover_mttr_seconds\"}) / clamp_min("
                "sum by (region) (federation_rollup_count{family="
                "\"failover_mttr_seconds\"}), 1e-9)"], 0, 16,
               unit="s"),
        _panel(6, "Worst serving attainment across fleet",
               ["min(federation_rollup_max{family="
                "\"serving_slo_attainment_min\"})"], 12, 16),
        _panel(7, "Stitched episode traces / scrape failures",
               ["rate(federation_stitched_traces_total[5m])",
                "sum by (region) "
                "(rate(federation_rollup_scrape_failures_total[5m]))"],
               0, 24),
        _panel(8, "Federation queue + migration activity",
               ["federation_pending_jobs",
                "rate(federation_migrations_total[5m])",
                "sum by (region) "
                "(rate(federation_router_rpc_failures_total[5m]))"],
               12, 24),
    ]
    return {
        "title": "volcano-tpu / federation", "uid": "vtp-federation",
        "timezone": "browser", "schemaVersion": 39, "version": 1,
        "refresh": "10s", "panels": panels,
        "templating": {"list": [{
            "name": "datasource", "type": "datasource",
            "query": "prometheus"}]},
    }


def dashboard_metric_names(dash: dict) -> set:
    """Metric families referenced by a dashboard's exprs (validation
    seam: tests cross-check these against FAMILIES and a live
    exposition)."""
    import re
    names = set()
    for panel in dash.get("panels", []):
        for tgt in panel.get("targets", []):
            for m in re.finditer(r"[a-z_][a-z0-9_]*", tgt["expr"]):
                tok = m.group(0)
                if tok in FAMILIES:
                    # exact family first: gauge names may themselves
                    # end in _count (unschedule_job_count)
                    names.add(tok)
                    continue
                base = re.sub(r"_(count|sum)$", "", tok)
                if base in FAMILIES:
                    names.add(base)
    return names


DEFAULT_CONF = {
    "actions": "enqueue, allocate, elastic, backfill, preempt, reclaim",
    "tiers": [
        {"plugins": [
            {"name": "priority"}, {"name": "gang"},
            # failover: quarantined-slice filter + requeued-gang
            # priority (controllers/failover.py is the other half)
            {"name": "failover"},
            # elastic: shrink-before-preempt veto + migration steering
            # (actions/elastic.py decides, controllers/elastic.py
            # executes)
            {"name": "elastic"},
            {"name": "conformance"}]},
        {"plugins": [
            {"name": "overcommit"}, {"name": "drf"},
            {"name": "predicates"}, {"name": "proportion"},
            {"name": "nodeorder"}, {"name": "binpack"},
            {"name": "network-topology-aware"}]},
    ],
}

# role -> (command template, metrics port offset from the server
# port).  The scheduler/controllers/agents processes each carry their
# own Prometheus registry (the families the dashboards query live
# THERE, not on the state server), so every role gets a --metrics-port
# and the scrape config targets all of them.
ROLES = [
    # --data-dir: the WAL + snapshot durability layer — with
    # Restart=always a kill -9/OOM replays the journal and loses no
    # acked write (docs/design/durability.md)
    ("server", "python3 -m volcano_tpu_torch.server --port {port} --data-dir "
               "{data_dir}/state --token-file {bundle_dir}/token",
     0),
    ("scheduler", "python3 -m volcano_tpu_torch "
                  "--cluster-url http://127.0.0.1:{port} "
                  "--components scheduler --leader-elect --holder %H "
                  "--conf {bundle_dir}/scheduler.conf.yaml "
                  "--metrics-port {port1} "
                  "--token-file {bundle_dir}/token", 1),
    ("controllers", "python3 -m volcano_tpu_torch "
                    "--cluster-url http://127.0.0.1:{port}"
                    " --components controllers "
                    "--metrics-port {port2} "
                    "--token-file {bundle_dir}/token", 2),
    # netaccounting reads the same volcano-owned cgroup subtree the
    # cgroup enforcer narrows to (its default root), closing the
    # shape->measure loop in the deployed agent; goodput reads the
    # workload progress files (api/goodput.py default root)
    ("agents", "python3 -m volcano_tpu_torch "
               "--cluster-url http://127.0.0.1:{port} "
               "--components none --agent-scheduler --node-agents all "
               "--usage-source collectors:local,gpu,netaccounting,"
               "goodput,serving "
               "--enforcer cgroup:/sys/fs/cgroup,tc:eth0 "
               "--metrics-port {port3} "
               "--token-file {bundle_dir}/token", 3),
]

UNIT_TEMPLATE = """[Unit]
Description=volcano-tpu {role}
After=network-online.target {after}
[Service]
ExecStart={cmd}
Restart=always
RestartSec=2
[Install]
WantedBy=multi-user.target
"""


# yaml is not a baked-in dependency everywhere; the conf loader
# accepts JSON (a YAML subset), so the bundle writes JSON-formatted
# .yaml files that both PyYAML and the loader parse.
def render(out_dir: str, topology: str = "nvl-a:dgx-h100-256",
           port: int = 8700, data_dir: str = "/var/lib/volcano-tpu",
           token: str = "") -> Dict[str, str]:
    """Render the bundle; returns {relative path: absolute path}."""
    bundle_dir = os.path.abspath(out_dir)
    os.makedirs(bundle_dir, exist_ok=True)
    values = {"topology": topology, "port": port,
              "port1": port + 1, "port2": port + 2, "port3": port + 3,
              "data_dir": data_dir, "bundle_dir": bundle_dir}
    written: Dict[str, str] = {}

    def emit(rel: str, content: str, mode: int = 0o644):
        path = os.path.join(bundle_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # secret-permissioned BEFORE any secret byte lands: a default-
        # umask create would leave a world-readable window
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode)
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(content)
        os.chmod(path, mode)    # pre-existing files keep umask bits
        written[rel] = path

    emit("values.json", json.dumps(values, indent=2) + "\n")
    token_path = os.path.join(bundle_dir, "token")
    if not token and os.path.exists(token_path):
        # re-render of a live bundle: rotating the credential would
        # 401 every running daemon until restart — keep it (pass
        # --token to rotate deliberately)
        token = open(token_path, encoding="utf-8").read().strip()
    emit("token", (token or secrets.token_urlsafe(32)) + "\n", 0o600)
    emit("scheduler.conf.yaml",
         json.dumps(DEFAULT_CONF, indent=2) + "\n")

    # NAME:KIND[@FABRIC]: an NVLink domain of a topology.WELL_KNOWN
    # kind in an InfiniBand fabric (default ib-0)
    slices = []
    for item in (s for s in topology.split(",") if s):
        name, _, rest = item.partition(":")
        kind, _, fabric = rest.partition("@")
        slices.append({"name": name, "kind": kind or "dgx-h100-256",
                       "ib_fabric": fabric or "ib-0"})
    emit("topology.json", json.dumps({"slices": slices}, indent=2)
         + "\n")
    by_fabric: Dict[str, List[str]] = {}
    for s in slices:
        by_fabric.setdefault(s["ib_fabric"], []).append(
            f"{s['name']}={s['kind']}")
    emit("cluster-init.sh", "\n".join(
        ["#!/bin/sh", "# registers the NVLink domains on the state "
         "server (run once), one call per IB fabric", "set -e",
         'PY="${PYTHON:-python3}"']
        + [f'"$PY" -m volcano_tpu_torch.cli.vtpctl --server '
           f"http://127.0.0.1:{port} --token-file {bundle_dir}/token "
           f"init --ib-fabric {fabric} --slices {' '.join(args)}"
           for fabric, args in by_fabric.items()] + [""]), 0o755)

    after = {"server": "", "scheduler": "volcano-tpu-server.service",
             "controllers": "volcano-tpu-server.service",
             "agents": "volcano-tpu-server.service"}
    for role, cmd_tmpl, _off in ROLES:
        cmd = cmd_tmpl.format(**values)
        emit(f"systemd/volcano-tpu-{role}.service",
             UNIT_TEMPLATE.format(role=role, cmd=cmd,
                                  after=after[role]))

    compose_services = {}
    for role, cmd_tmpl, _off in ROLES:
        cmd = cmd_tmpl.format(**dict(
            values, bundle_dir="/bundle", data_dir="/data"))
        # %H is a systemd specifier (hostname: unique per host, one
        # scheduler unit per host).  Compose runs with host networking
        # where every scaled replica reports the SAME hostname — and
        # identical lease holders would BOTH hold the lease — so each
        # container derives a per-boot unique holder from the kernel
        # instead.  (A restarted replica gets a fresh identity and
        # simply re-contends once the old lease expires.)
        compose_services[role] = {
            "image": "volcano-tpu:latest",
            "command": ["sh", "-c", cmd.replace(
                "%H",
                "$(cat /proc/sys/kernel/random/uuid)")],
            "network_mode": "host",
            "volumes": [f"{bundle_dir}:/bundle:ro", "data:/data"],
            **({} if role == "server"
               else {"depends_on": ["server"]}),
        }
    emit("docker-compose.yaml", json.dumps(
        {"services": compose_services, "volumes": {"data": {}}},
        indent=2) + "\n")

    emit("prometheus.yml", json.dumps({
        "global": {"scrape_interval": "10s"},
        "scrape_configs": [{
            "job_name": "volcano-tpu",
            "bearer_token_file": f"{bundle_dir}/token",
            "static_configs": [{
                # the state server's own registry AND every role
                # process's --metrics-port (scheduler latency/fair-
                # share families live in those registries)
                "targets": [f"127.0.0.1:{port + off}"
                            for _, _, off in ROLES],
                "labels": {"control_plane": "volcano-tpu"}}],
        }]}, indent=2) + "\n")

    for fname, dash in (("scheduler.json", scheduler_dashboard()),
                        ("agents.json", agent_dashboard()),
                        ("federation.json", federation_dashboard())):
        emit(f"grafana/{fname}", json.dumps(dash, indent=2) + "\n")

    emit("README.md", BUNDLE_README.format(**values))
    return written


BUNDLE_README = """# volcano-tpu deploy bundle

Rendered by `python -m volcano_tpu_torch.bundle` — edit values.json and
re-render rather than hand-editing outputs.

Bring-up order:
1. `systemd/`: `systemctl enable --now volcano-tpu-server`, then the
   other units (they After= the server).  Or: `docker compose up`.
2. `./cluster-init.sh` once to register the topology
   ({topology}).
3. Point Prometheus at `prometheus.yml` (the scrape carries the
   bearer token — ALL state-server routes except /healthz and
   /metrics require it) and import `grafana/*.json`.

The token in `token` (mode 0600) guards every read and write on the
state server at port {port}.
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="render the volcano-tpu deploy bundle")
    parser.add_argument("--out", required=True)
    parser.add_argument("--topology", default="nvl-a:dgx-h100-256",
                        help="NAME:KIND[@FABRIC],... NVLink domains "
                             "(kind hgx-h100-8 or dgx-h100-256) and "
                             "their IB fabrics")
    parser.add_argument("--port", type=int, default=8700)
    parser.add_argument("--data-dir", default="/var/lib/volcano-tpu")
    parser.add_argument("--token", default="",
                        help="cluster token (default: generate)")
    args = parser.parse_args(argv)
    written = render(args.out, args.topology, args.port,
                     args.data_dir, args.token)
    for rel in sorted(written):
        print(rel)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
