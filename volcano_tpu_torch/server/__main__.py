"""Run the state server standalone.

    python -m volcano_tpu_torch.server --port 8700 --data-dir ./state \
        --tick-period 1.0

--data-dir enables the crash-safe layer (WAL + snapshots, fsync
before every ack; server/durability.py): a kill -9 loses nothing that
was acked, and the next boot replays snapshot-then-WAL and resumes
the event counter monotonically.  --state remains as the legacy
single-file mode: it loads EITHER the old pickle or the snapshot-JSON
format, and the graceful save is routed through the same atomic
snapshot writer (but a hard kill still loses everything since the
last save — use --data-dir for durability).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="volcano-tpu-server")
    parser.add_argument("--port", type=int, default=8700)
    parser.add_argument("--data-dir", default="",
                        help="durable state directory (WAL + "
                             "snapshots, fsync before ack); survives "
                             "kill -9")
    parser.add_argument("--state", default="",
                        help="legacy single-file state to load/save "
                             "on graceful shutdown (pickle or "
                             "snapshot JSON — both load); when "
                             "--data-dir already holds state, that "
                             "wins and --state only receives the "
                             "shutdown export")
    parser.add_argument("--tick-period", type=float, default=0.0,
                        help="self-tick the simulated kubelet every N "
                             "seconds (0 = external /tick only)")
    parser.add_argument("--webhook-url", default="",
                        help="external webhook-manager to call for "
                             "admission instead of the embedded chain "
                             "(vc-webhook-manager analogue)")
    parser.add_argument("--webhook-failure-policy",
                        choices=["Fail", "Ignore"], default="Fail")
    parser.add_argument("--tls-cert", default="",
                        help="serve TLS with this certificate (PEM); "
                             "plaintext clients are refused")
    parser.add_argument("--tls-key", default="")
    parser.add_argument("--gen-tls", action="store_true",
                        help="generate a self-signed cert/key at the "
                             "--tls-cert/--tls-key paths first")
    parser.add_argument("--token", default="",
                        help="cluster bearer token: required on every "
                             "route except /healthz and /metrics "
                             "(also presented on webhook callouts)")
    parser.add_argument("--token-file", default="")
    parser.add_argument("--fault-plan", default="",
                        help="ARM THE CHAOS ENGINE: a faults.FaultPlan "
                             "JSON doc (inline, or @/path/to/plan.json)"
                             " injecting wire/disk/clock faults in "
                             "this process; also read from the "
                             "VTP_FAULT_PLAN env var.  Never use in "
                             "production")
    parser.add_argument("--replica-id", default="",
                        help="join a replica group under this id "
                             "(requires --data-dir); without "
                             "--replicate-from this process is the "
                             "seed leader")
    parser.add_argument("--peers", default="",
                        help="comma-separated URLs of the OTHER "
                             "replicas (quorums are majorities of "
                             "the full group, this replica included)")
    parser.add_argument("--replicate-from", default="",
                        help="start as a FOLLOWER of this leader URL "
                             "('auto' discovers the leader among "
                             "--peers): ship + replay its WAL, serve "
                             "reads at advertised staleness, refuse "
                             "writes with a leader hint, campaign on "
                             "leader death")
    parser.add_argument("--commit-quorum", type=int, default=0,
                        help="replicas (leader included) that must "
                             "hold a write durably before its ack "
                             "(default: group majority; 1 = async "
                             "shipping)")
    parser.add_argument("--election-quorum", type=int, default=0,
                        help="votes (candidate included) needed to "
                             "promote (default: group majority; a "
                             "2-node lab needs the explicit 1 — see "
                             "docs/design/replication.md on split "
                             "brain)")
    parser.add_argument("--repl-ttl", type=float, default=3.0,
                        help="leader-silence window before followers "
                             "campaign")
    parser.add_argument("--wal-force-truncate", action="store_true",
                        help="explicit operator override for mid-WAL "
                             "corruption: truncate the log at the "
                             "corrupt record and ACCEPT THE DATA LOSS "
                             "instead of refusing to boot")
    parser.add_argument("--webhook-ca-cert", default="",
                        help="CA bundle for --webhook-url callouts")
    parser.add_argument("--webhook-insecure", action="store_true")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    log = logging.getLogger("volcano_tpu_torch.server")

    from volcano_tpu_torch.cache.fake_cluster import FakeCluster
    from volcano_tpu_torch.server.state_server import serve
    from volcano_tpu_torch.server.tlsutil import generate_self_signed, load_token
    from volcano_tpu_torch.webhooks import default_admission

    token = load_token(args.token, args.token_file)
    if args.gen_tls:
        if not (args.tls_cert and args.tls_key):
            parser.error("--gen-tls needs --tls-cert and --tls-key paths")
        generate_self_signed(args.tls_cert, args.tls_key)
        log.info("self-signed TLS material written to %s / %s",
                 args.tls_cert, args.tls_key)

    from volcano_tpu_torch import faults as faults_mod
    from volcano_tpu_torch.server.durability import (DurableStore,
                                               WALCorruptionError,
                                               atomic_write_json,
                                               load_cluster_file)
    plan = None
    if args.fault_plan:
        raw = args.fault_plan
        if raw.startswith("@"):
            with open(raw[1:], encoding="utf-8") as f:
                raw = f.read()
        import json as _json
        plan = faults_mod.FaultPlan.from_doc(_json.loads(raw))
        log.warning("fault plan ACTIVE (seed=%d, %d rules)",
                    plan.seed, len(plan.rules))
    else:
        plan = faults_mod.FaultPlan.from_env()
    if plan is not None:
        faults_mod.install_clock_faults(plan)

    durable = None
    cluster = None
    if args.data_dir:
        vfs = None
        if plan is not None and any(r.site == "disk"
                                    for r in plan.rules):
            vfs = faults_mod.FaultyVFS(plan)
        durable = DurableStore(args.data_dir, vfs=vfs,
                               force_truncate=args.wal_force_truncate)
        try:
            rec = durable.recover()
        except WALCorruptionError as e:
            # REFUSE TO START: replaying past mid-WAL corruption
            # silently drops every later acked write.  The operator
            # restores the segment or accepts the loss explicitly.
            log.critical("%s", e)
            return 3
        cluster = rec.cluster
        if cluster is not None:
            log.info("recovered durable state from %s (%d nodes, %d "
                     "pods, rv %d, %d WAL records replayed in %.3fs, "
                     "epoch %s)", args.data_dir, len(cluster.nodes),
                     len(cluster.pods), rec.rv, rec.replay_records,
                     rec.replay_seconds, rec.epoch)
    if cluster is None and args.state and os.path.exists(args.state):
        # legacy alias: sniffs pickle vs snapshot JSON.  With an empty
        # --data-dir this seeds the durable store (the initial
        # snapshot lands before the first ack).
        cluster = load_cluster_file(args.state)
        if cluster.admission is None:
            cluster.admission = default_admission()
        log.info("loaded state from %s (%d nodes, %d pods)",
                 args.state, len(cluster.nodes), len(cluster.pods))
    elif args.state and os.path.exists(args.state) and \
            cluster is not None:
        log.info("durable state in %s takes precedence; %s will only "
                 "receive the shutdown export", args.data_dir,
                 args.state)

    from volcano_tpu_torch.webhooks.server import RemoteAdmission
    if args.webhook_url:
        if cluster is None:
            cluster = FakeCluster()
        cluster.admission = RemoteAdmission(
            args.webhook_url,
            failure_policy=args.webhook_failure_policy,
            token=token, ca_cert=args.webhook_ca_cert,
            insecure=args.webhook_insecure)
        log.info("admission delegated to webhook manager at %s "
                 "(failurePolicy=%s)", args.webhook_url,
                 args.webhook_failure_policy)
    elif cluster is not None and \
            isinstance(cluster.admission, RemoteAdmission):
        # a RemoteAdmission pickled into the state file must not
        # outlive the flag: restarting without --webhook-url means
        # embedded admission, not a (likely dead) webhook endpoint
        log.info("state file carried a webhook admission proxy; "
                 "reverting to the embedded chain (no --webhook-url)")
        cluster.admission = default_admission()

    replication = None
    if args.replica_id or args.replicate_from:
        if durable is None:
            parser.error("replication requires --data-dir (followers "
                         "journal the shipped WAL before serving it)")
        from volcano_tpu_torch.server.replication import Replication
        replication = Replication(
            replica_id=args.replica_id or f"replica-{args.port}",
            peers=[p for p in args.peers.split(",") if p],
            replicate_from=args.replicate_from,
            commit_quorum=args.commit_quorum,
            election_quorum=args.election_quorum,
            ttl=args.repl_ttl, token=token)

    httpd, state = serve(port=args.port, cluster=cluster,
                         tick_period=args.tick_period,
                         tls_cert=args.tls_cert, tls_key=args.tls_key,
                         token=token, durable=durable, faults=plan,
                         replication=replication)
    if replication is not None:
        log.info("replication: id=%s role=%s term=%d peers=%s "
                 "commit-quorum=%d election-quorum=%d",
                 replication.replica_id, replication.role,
                 replication.term, replication.peers,
                 replication.commit_quorum,
                 replication.election_quorum)
    log.info("state server on %s://127.0.0.1:%d%s%s",
             "https" if args.tls_cert else "http",
             httpd.server_address[1],
             " (bearer auth on writes)" if token else "",
             f" [durable: {args.data_dir}]" if durable else "")

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()

    state.tick_stop.set()   # no kubelet mutations during save
    if replication is not None:
        replication.stop()
    httpd.shutdown()
    if durable is not None:
        if durable.poisoned:
            log.error("shutting down READ-ONLY (%s): skipping the "
                      "final compaction — the last durable snapshot + "
                      "WAL prefix is the recovery point",
                      durable.poisoned)
        else:
            # final compaction so the next boot replays zero WAL
            state.write_snapshot()
            log.info("durable state compacted in %s", args.data_dir)
        durable.close()
    if args.state:
        # the graceful save routes through the same snapshot capture +
        # atomic writer the WAL compactor uses: the store/event locks
        # make the capture consistent even if a straggling handler
        # thread is still mutating (the old direct pickle raced them),
        # and write-temp + rename means a crash mid-save never tears
        # the last good file
        atomic_write_json(args.state, state.disk_snapshot_doc())
        log.info("state saved to %s (snapshot format)", args.state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
