"""Run the control plane — single-process or split across a wire.

The binaries parity point (reference cmd/: vc-scheduler,
vc-controller-manager, vc-agent-scheduler, vc-agent): by default one
daemon runs the batch scheduler, the controller manager, optionally the
agent fast path and per-node agents, with a Prometheus /metrics
endpoint and the SIGUSR2 cache dumper.

    python -m volcano_tpu_torch --state cluster.pkl --period 1 \
        --metrics-port 9090 --cycles 0        # 0 = run forever

With --cluster-url the process becomes ONE control-plane component
talking to the state server (volcano_tpu_torch.server) the way the
reference binaries only meet at the apiserver:

    python -m volcano_tpu_torch.server --port 8700 --tick-period 0.5 &
    python -m volcano_tpu_torch --cluster-url http://127.0.0.1:8700 \
        --components scheduler --leader-elect --holder sched-1 &
    python -m volcano_tpu_torch --cluster-url http://127.0.0.1:8700 \
        --components controllers &
    python -m volcano_tpu_torch --cluster-url http://127.0.0.1:8700 \
        --components none --agent-scheduler --node-agents all &

--leader-elect takes a server lease before scheduling and renews it
each cycle; losing the lease pauses the component until re-acquired
(reference: cmd/scheduler/app/server.go:99-128).
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import signal
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="volcano-tpu")
    parser.add_argument("--state", default="",
                        help="pickled FakeCluster to load (default: "
                             "empty in-memory cluster)")
    parser.add_argument("--cluster-url", default="",
                        help="state-server URL; the process runs its "
                             "components against the wire instead of an "
                             "in-memory cluster")
    parser.add_argument("--token", default="",
                        help="cluster bearer token (required on all "
                             "state-server routes except /healthz "
                             "and /metrics)")
    parser.add_argument("--token-file", default="")
    parser.add_argument("--ca-cert", default="",
                        help="CA bundle to verify an https state "
                             "server")
    parser.add_argument("--insecure", action="store_true",
                        help="skip state-server cert verification")
    parser.add_argument("--components", default="scheduler,controllers",
                        help="comma list: scheduler,controllers — or "
                             "'none' for an agent-only process "
                             "(--agent-scheduler / --node-agents)")
    parser.add_argument("--leader-elect", action="store_true",
                        help="gate the scheduler on a server lease")
    parser.add_argument("--holder", default="",
                        help="leader-election holder identity "
                             "(default: pid-derived)")
    parser.add_argument("--lease-ttl", type=float, default=5.0)
    parser.add_argument("--feature-gates", default="",
                        help="A=true,B=false overrides "
                             "(volcano_tpu_torch/features.py)")
    parser.add_argument("--conf", default="",
                        help="scheduler conf YAML path (hot-reloaded)")
    parser.add_argument("--period", type=float, default=1.0)
    parser.add_argument("--cycles", type=int, default=0,
                        help="stop after N cycles (0 = forever)")
    parser.add_argument("--metrics-port", type=int, default=0,
                        help="serve /metrics on this port (0 = off)")
    parser.add_argument("--agent-scheduler", action="store_true",
                        help="also run the fast-path scheduler")
    parser.add_argument("--controllers", default="job,podgroup,queue,"
                        "hypernode,garbagecollector,jobflow,jobtemplate,"
                        "cronjob,sharding,hyperjob,failover,elastic,"
                        "serving")
    parser.add_argument("--node-agents", default="",
                        help="run per-node QoS agents: 'all' or a "
                             "comma-separated list of node names")
    parser.add_argument("--usage-source", default="",
                        help="agent usage backend: prometheus:URL, "
                             "es:URL, or collectors:NAME[,NAME...] "
                             "(registered collectors, e.g. local,gpu;"
                             " default: static zeros)")
    parser.add_argument("--enforcer", default="none",
                        help="node-agent OS enforcement: 'none' "
                             "(publish only), 'record' (in-memory "
                             "ledger), or a comma list of "
                             "'cgroup:ROOT' and 'tc:IFACE' "
                             "(agent/enforcer.py)")
    parser.add_argument("--member-cluster", action="append", default=[],
                        metavar="NAME=URL",
                        help="HyperJob multi-cluster forwarding: a "
                             "member control plane's state-server URL "
                             "(repeatable); split members whose domain "
                             "is NAME are created THERE")
    parser.add_argument("--shard-index", type=int, default=None,
                        help="this scheduler's subtree-shard index "
                             "(0-based); with --shard-count, the "
                             "process schedules only the hypernode "
                             "subtrees its shard owns")
    parser.add_argument("--shard-count", type=int, default=None,
                        help="total scheduler shards in the plane")
    parser.add_argument("--hypernode-discovery", default="label",
                        help="topology provider: 'label' (node labels) "
                             "or 'fabric:ENDPOINT[#TOKEN]' (fabric-"
                             "inventory HTTP API, the UFM analogue)")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    log = logging.getLogger("volcano_tpu_torch.main")

    from volcano_tpu_torch import features, metrics
    from volcano_tpu_torch.cache.fake_cluster import FakeCluster
    from volcano_tpu_torch.controllers import ControllerManager
    from volcano_tpu_torch.dumper import Dumper
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.webhooks import default_admission

    if args.feature_gates:
        try:
            features.parse(args.feature_gates)
        except features.UnknownFeatureError as e:
            parser.error(str(e))
    remote = bool(args.cluster_url)
    if remote:
        from volcano_tpu_torch.server.tlsutil import load_token
        if ";" in args.cluster_url:
            # semicolon-separated leader GROUPS (each a comma-
            # separated replica list): the keyspace-partitioned
            # write plane
            from volcano_tpu_torch.cache.partitioned import PartitionedCluster
            cluster = PartitionedCluster(
                args.cluster_url,
                token=load_token(args.token, args.token_file),
                ca_cert=args.ca_cert, insecure=args.insecure)
        else:
            from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
            cluster = RemoteCluster(
                args.cluster_url,
                token=load_token(args.token, args.token_file),
                ca_cert=args.ca_cert, insecure=args.insecure)
    elif args.state:
        try:
            # sniffs legacy pickle vs the snapshot-JSON format the
            # server's graceful save writes now
            from volcano_tpu_torch.server.durability import load_cluster_file
            cluster = load_cluster_file(args.state)
            if cluster.admission is None:
                cluster.admission = default_admission()
        except FileNotFoundError:
            cluster = FakeCluster()
            cluster.admission = default_admission()
    else:
        cluster = FakeCluster()
        cluster.admission = default_admission()

    components = {c.strip() for c in args.components.split(",") if c}
    unknown = components - {"scheduler", "controllers", "none"}
    if unknown or not components:
        parser.error(f"--components must be a non-empty subset of "
                     f"scheduler,controllers (or 'none' for an "
                     f"agent-only process; got {args.components!r})")
    if "none" in components and len(components) > 1:
        parser.error("--components none excludes other components")
    if components == {"none"} and not (args.agent_scheduler or
                                       args.node_agents):
        parser.error("--components none needs --agent-scheduler "
                     "and/or --node-agents")
    components -= {"none"}
    run_sched = "scheduler" in components
    run_ctrls = "controllers" in components

    if (args.shard_index is None) != (args.shard_count is None):
        parser.error("--shard-index and --shard-count go together")
    if args.shard_count is not None and not (
            0 <= args.shard_index < args.shard_count):
        parser.error(f"--shard-index {args.shard_index} out of range "
                     f"for --shard-count {args.shard_count}")
    sched = None
    if run_sched:
        sched = Scheduler(cluster, conf_path=args.conf or None,
                          schedule_period=args.period,
                          shard_index=args.shard_index,
                          shard_count=args.shard_count)
    mgr = None
    if run_ctrls:
        ctrl_overrides = {}
        if args.hypernode_discovery != "label":
            from volcano_tpu_torch.controllers import hypernode as hn_mod
            try:
                disc = hn_mod.make_discoverer(args.hypernode_discovery)
            except ValueError as e:
                parser.error(str(e))
            ctrl_overrides["hypernode"] = \
                lambda: hn_mod.HyperNodeController(discoverer=disc)
        if args.member_cluster:
            from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
            from volcano_tpu_torch.controllers import hyperjob as hj_mod
            from volcano_tpu_torch.server.tlsutil import load_token
            fleet_token = load_token(args.token, args.token_file)
            remotes = {}
            for item in args.member_cluster:
                name, sep, url = item.partition("=")
                if not sep or not name or not url:
                    parser.error(f"--member-cluster {item!r} "
                                 "(want NAME=URL)")
                # member planes share the hub's credential flags (one
                # fleet CA/token); per-member credentials would go in
                # a kubeconfig-style file if ever needed
                # a member down at hub start must not crash-loop the
                # hub: the client self-heals and the hyperjob
                # controller retries forwarding from its stored plan
                remotes[name] = RemoteCluster(
                    url, token=fleet_token,
                    ca_cert=args.ca_cert, insecure=args.insecure,
                    tolerate_unreachable=True)
            ctrl_overrides["hyperjob"] = \
                lambda: hj_mod.HyperJobController(
                    binder=hj_mod.MultiClusterBinder(cluster, remotes))
        mgr = ControllerManager(
            cluster, enabled=[c for c in args.controllers.split(",") if c],
            overrides=ctrl_overrides)
    elif args.hypernode_discovery != "label":
        log.warning("--hypernode-discovery has no effect without "
                    "the controllers component")

    elector = None
    if args.leader_elect:
        if not remote:
            parser.error("--leader-elect requires --cluster-url")
        if not components:
            parser.error("--leader-elect needs scheduler/controllers "
                         "(agent processes are per-node, not elected)")
        from volcano_tpu_torch.leaderelection import LeaderElector
        holder = args.holder or f"pid-{os.getpid()}"
        # one lease per component set: scheduler replicas contend on
        # "scheduler", controller-manager replicas on "controllers" —
        # never across roles.  Sharded schedulers contend per shard
        # ("scheduler-shard0", ...): shards own disjoint subtrees, so
        # each shard's replicas elect among themselves, never across
        # shards
        lease_name = "+".join(sorted(components))
        if args.shard_index is not None and "scheduler" in components:
            lease_name += f"-shard{args.shard_index}"
        elector = LeaderElector(cluster, lease_name, holder,
                                ttl=args.lease_ttl).start()
    agent_sched = None
    if args.agent_scheduler:
        from volcano_tpu_torch.agentscheduler import AgentScheduler
        agent_sched = AgentScheduler(cluster)

    usage_source = None
    node_agents = {}
    shared_enforcer = None
    if args.node_agents:
        from volcano_tpu_torch.agent import FakeUsageProvider, NodeAgent

        if args.usage_source:
            kind, _, url = args.usage_source.partition(":")
            from volcano_tpu_torch import metrics_source
            if kind == "prometheus" and url:
                usage_source = metrics_source.PrometheusUsageSource(url)
            elif kind == "es" and url:
                usage_source = metrics_source.ElasticsearchUsageSource(url)
            elif kind == "collectors" and url:
                # pluggable metric collection (agent/collect.py):
                # e.g. collectors:local,gpu
                from volcano_tpu_torch.agent.collect import build_provider
                try:
                    usage_source = build_provider(url)
                except ValueError as e:
                    parser.error(str(e))
            else:
                parser.error(f"unknown --usage-source {args.usage_source!r}"
                             " (want prometheus:URL, es:URL, or "
                             "collectors:NAME[,NAME...])")
        if usage_source is not None:
            provider = usage_source
            agent_kwargs = {}
        else:
            # no backend: agents still report/cordon on injected data,
            # but must not fabricate oversubscription slack from the
            # provider's static zero usage (60% of every node would
            # become phantom schedulable capacity)
            log.warning("--node-agents without --usage-source: "
                        "oversubscription reporting disabled")
            provider = FakeUsageProvider()
            agent_kwargs = {"oversub_factor": 0.0}
        wanted = args.node_agents
        # ONE enforcer shared by every agent in this process: per-agent
        # TcEnforcers would hand out colliding class ids on the same
        # interface (real deployments run one agent per host anyway).
        # A tc enforcer shaping one interface CANNOT serve multiple
        # simulated nodes — each agent would program a different
        # per-node pod set and the programs would ping-pong every sync
        # — so refuse that combination outright.
        from volcano_tpu_torch.agent.enforcer import build_enforcer
        multi_agent = (wanted == "all"
                       or len([n for n in wanted.split(",")
                               if n.strip()]) > 1)
        kernel_kinds = {item.partition(":")[0] for item
                        in (args.enforcer or "").split(",")} & \
            {"tc", "cgroup"}
        if multi_agent and kernel_kinds:
            # tc shapes ONE interface (per-node programs would
            # ping-pong); a shared cgroup root would make each agent's
            # restart-reconcile sweep away the OTHER agents' live pod
            # state.  Real deployments run one agent per host.
            parser.error(f"--enforcer {','.join(sorted(kernel_kinds))} "
                         "mutates one host's kernel and cannot serve "
                         "multiple --node-agents; run one agent per "
                         "host or use --enforcer record/none")
        shared_enforcer = build_enforcer(args.enforcer)

        def sync_node_agents():
            # refreshes happen on the background thread below: a slow
            # or dead backend must never stall the scheduling loop
            # (the source's stale TTL degrades reads to zeros)
            names = (cluster.nodes.keys() if wanted == "all"
                     else [n.strip() for n in wanted.split(",")
                           if n.strip()])
            for name in names:
                if name not in node_agents and name in cluster.nodes:
                    node_agents[name] = NodeAgent(
                        cluster, name, provider,
                        enforcer=shared_enforcer, **agent_kwargs)
            for agent in node_agents.values():
                agent.sync()
    else:
        if args.usage_source:
            log.warning("--usage-source has no effect without "
                        "--node-agents")

        def sync_node_agents():
            pass

    if sched is not None:
        Dumper(sched).listen_for_signal()
    server = None
    if args.metrics_port:
        server = metrics.serve(args.metrics_port)
        log.info("metrics on http://127.0.0.1:%d/metrics",
                 server.server_address[1])

    import threading

    stop = threading.Event()

    def on_signal(*_):
        stop.set()
        if remote:
            # a call retrying against a dead server stops at its next
            # back-off instead of spending its whole retry budget
            cluster.close()
    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    if usage_source is not None:
        # one synchronous refresh so the first cycle sees real data
        # (bounded by the source's own timeout), then move off-loop
        usage_source.refresh()

        # cadence must outpace the source's stale TTL or reads degrade
        # to zeros between refreshes at long scheduling periods
        ttl = getattr(usage_source, "stale_after", 60.0)
        interval = max(2.0, min(args.period, ttl / 2.0))

        def refresh_loop():
            while not stop.is_set():
                stop.wait(interval)
                if not stop.is_set():
                    usage_source.refresh()
        threading.Thread(target=refresh_loop, name="usage-refresh",
                         daemon=True).start()

    log.info("control plane up: %d nodes, %d controllers%s%s%s",
             len(cluster.nodes),
             len(mgr.controllers) if mgr else 0,
             ", agent scheduler" if agent_sched else "",
             f", node agents ({args.node_agents})"
             if args.node_agents else "",
             " [leader-elected]" if elector else "")
    cycles = 0
    clean_exit = False
    try:
        while not stop.is_set():
            is_leader = elector.is_leader if elector is not None else True
            if is_leader:
                try:
                    sync_node_agents()
                    if mgr is not None:
                        mgr.sync_all()
                    if sched is not None:
                        sched.run_once()
                    if agent_sched is not None:
                        # over the wire, commit binds in batches (one
                        # /bind_batch per ~64 pods); in-process the
                        # per-pod lane is already a function call
                        agent_sched.run_until_drained(
                            bind_batch=64 if remote else 0)
                    if not remote:
                        cluster.tick()
                except Exception:  # noqa: BLE001
                    # REMOTE mode only: a wire blip (server restart,
                    # partition healing mid-request) must not kill the
                    # process — the reference scheduler rides out
                    # apiserver disconnects the same way.  The elector
                    # steps us down if the server stays unreachable;
                    # the next cycle resyncs.  (Found by
                    # tools/chaos_partition.py: a severed in-flight
                    # POST crashed the whole scheduler.)  In LOCAL
                    # mode the crash must propagate: the state is the
                    # in-process cluster, possibly half-mutated, and
                    # the snapshot guard below relies on clean_exit
                    # staying False to not overwrite the last good
                    # pickle.
                    if not remote:
                        raise
                    log.exception("scheduling cycle failed; retrying "
                                  "next period")
                # a failed cycle still counts toward --cycles: a
                # bounded run against a dead server must terminate,
                # not spin forever
                cycles += 1
            if args.cycles and cycles >= args.cycles:
                break
            # Event.wait wakes immediately on signal — no PEP 475
            # sleep-resume delaying shutdown by up to a full period
            stop.wait(args.period if is_leader
                      else min(args.period, 0.5))
        clean_exit = True
    finally:
        if elector is not None:
            elector.stop()
        if mgr is not None:
            mgr.stop()
        if server is not None:
            server.shutdown()
        if remote:
            cluster.close()
        if args.state and not remote and clean_exit:
            # atomic save, and only on clean exit — a crash mid-cycle
            # must never clobber the last consistent snapshot
            tmp = f"{args.state}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(cluster, f)
            os.replace(tmp, args.state)
            log.info("state saved to %s", args.state)
        elif args.state and not remote:
            log.warning("exiting on error: NOT overwriting %s",
                        args.state)
    from volcano_tpu_torch.agent.enforcer import RecordingEnforcer
    if isinstance(shared_enforcer, RecordingEnforcer):
        # --enforcer record keeps its ledger in this process: the one
        # place an operator can read it is the daemon's log
        import json
        log.info("record enforcer ledger: %s",
                 json.dumps(shared_enforcer.log, default=str))
    if remote:
        # bind/evict history lives on the server, not in the mirror
        log.info("ran %d cycles", cycles)
    else:
        log.info("ran %d cycles; %d binds, %d evictions",
                 cycles, len(cluster.binds), len(cluster.evictions))
    return 0


if __name__ == "__main__":
    sys.exit(main())
