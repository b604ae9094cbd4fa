"""The port's federation tier (`volcano_tpu_torch.federation`) against the
reference's, on mirrored regions.

The reference's regions are TPU v5e hosts (4 chips, google.com/tpu);
the port's are their GPU mirrors (4 GPUs of nvidia.com/gpu, GPU Feature
Discovery's H100 product label), with the same names, prices, jobs and
clock.  Each scenario is a function of a side namespace and runs
through both packages: it asserts the reference test's contract on
each side and returns a record of what the router decided (admitted
regions, attempts, admission keys, episodes, migrations, requeues,
refusals, region states), and the two records must be equal.  The
contract: mirror bootstrap and tail, corrupt or gapped batches refused
wholesale, the staleness bound, deterministic admission keys across a
router restart, a lost region's gangs requeued with the folded resume
step, migration refused through a stale mirror, the retry and breaker
policy, router HA with the fence, the episode chain and the stitched
tree across a router failover.  The learned goodput is keyed by the
port's GPU generations.  Tolerance: exact.
"""

import importlib
import itertools
import os
import tempfile
import time
import types

import pytest

H100 = "NVIDIA-H100-80GB-HBM3"
H200 = "NVIDIA-H200-141GB-HBM3e"


def _side(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    port = pkg == "volcano_tpu_torch"
    res = m("api.resource")
    return types.SimpleNamespace(
        pkg=pkg, metrics=m("metrics"), trace=m("trace"),
        pod=m("api.pod"), fedapi=m("api.federation"), eapi=m("api.elastic"),
        sapi=m("api.serving"), slicehealth=m("api.slicehealth"),
        types=m("api.types"), Node=m("api.node_info").Node,
        Container=m("api.pod").Container, Pod=m("api.pod").Pod,
        make_pod=m("api.pod").make_pod, PodGroup=m("api.podgroup").PodGroup,
        VCJob=m("api.vcjob").VCJob, TaskSpec=m("api.vcjob").TaskSpec,
        FakeCluster=m("cache.fake_cluster").FakeCluster,
        RemoteCluster=m("cache.remote_cluster").RemoteCluster,
        mirror=m("federation.mirror"), router=m("federation.router"),
        retry=m("federation.retry"), faults=m("faults"),
        DurableStore=m("server.durability").DurableStore,
        replication=m("server.replication"),
        serve=m("server.state_server").serve,
        JobController=m("controllers.job.controller").JobController,
        device=res.GPU if port else res.TPU,
        labels=(lambda product=H100: {"nvidia.com/gpu.product": product})
        if port else (lambda product=None: {
            "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"}))


REF, PORT = _side("volcano_tpu"), _side("volcano_tpu_torch")
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def _reset():
    for s in SIDES:
        s.metrics.reset()
        s.trace.reset()
        s.pod._uid_counter = itertools.count(1)
    yield
    for s in SIDES:
        s.metrics.reset()
        s.trace.reset()


def both(scenario):
    """Run `scenario` on each side (uids counted from 1); the port's
    record must equal the reference's."""
    records = []
    for s in SIDES:
        s.pod._uid_counter = itertools.count(1)
        records.append(scenario(s))
    assert records[1] == records[0]
    return records[1]


# -- harness (the reference test's, on a side) ----------------------------

class FakeMirror:
    """Zero-wire mirror: reads straight from the regional cluster;
    staleness is a knob."""

    def __init__(self, s, name, cluster, age=0.0):
        self.s, self.name, self.cluster, self.age = s, name, cluster, age

    def age_s(self):
        return self.age

    def read_checked(self, max_age_s=None):
        bound = self.s.fedapi.MIRROR_MAX_AGE_S if max_age_s is None \
            else max_age_s
        if self.age > bound:
            raise self.s.mirror.MirrorStaleError(self.name, self.age, bound)
        return self.cluster

    def status(self):
        return {"region": self.name, "age_s": self.age}

    def stop(self):
        pass


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def region(s, name, nodes=4, per_node=4, product=H100):
    c = s.FakeCluster()
    for i in range(nodes):
        c.add_node(s.Node(name=f"{name}-n{i}", labels=s.labels(product),
                          allocatable={s.device: per_node, "cpu": 64}))
    return c


def global_job(s, name="train", replicas=2, per_pod=4, annotations=None):
    tpl = s.Pod(name="w", containers=[s.Container(
        requests={s.device: per_pod, "cpu": 8})])
    return s.VCJob(name=name, min_available=replicas,
                   annotations=dict(annotations or {}),
                   tasks=[s.TaskSpec(name="w", replicas=replicas,
                                     template=tpl)])


def fleet(s, regions, clock):
    g = s.FakeCluster()
    router = s.router.FederationRouter(g, now=clock, start_mirrors=False)
    handles = {}
    for name, kwargs in regions.items():
        kwargs = dict(kwargs)
        rc = region(s, name, **kwargs.pop("region_kw", {}))
        m = FakeMirror(s, name, rc)
        router.attach_region(
            s.fedapi.region_record(name, f"fake://{name}", **kwargs),
            client=rc, mirror=m)
        handles[name] = (rc, m)
    return g, router, handles


def job_record(s, g):
    """What the global store says of every job, uids aside."""
    f = s.fedapi
    out = {}
    for key, job in sorted(g.vcjobs.items()):
        ann = job.annotations
        out[key] = dict(
            region=f.admitted_region(job),
            attempt=ann.get(f.FED_ATTEMPT_ANNOTATION),
            key=ann.get(f.FED_ADMISSION_KEY_ANNOTATION),
            migrated_from=ann.get(f.FED_MIGRATED_FROM_ANNOTATION),
            migrations=f.migration_count(job),
            episode=f.episode_of(job), hop=f.episode_hop(job),
            resume=ann.get(s.slicehealth.RESUME_STEP_ANNOTATION),
            last=ann.get(s.slicehealth.LAST_STEP_ANNOTATION))
    return out


def counters(s, name, regions):
    return {r: s.metrics.get_counter(name, region=r) for r in regions}


# -- API and mirror -------------------------------------------------------

def test_federation_api_contract():
    def sc(s):
        f = s.fedapi
        from_kinds = importlib.import_module(f"{s.pkg}.cache.kinds").KINDS
        assert "region" in from_kinds and s.FakeCluster().regions == {}
        k1 = f.admission_key("default/train", 0)
        assert k1 == f.admission_key("default/train", 0)
        assert k1 != f.admission_key("default/train", 1)
        rec = f.region_record("ra", "http://x", price=0.5)
        assert f.region_ready(rec) and f.region_alive(rec)
        rec["state"] = f.REGION_STATE_DRAINING
        assert f.region_alive(rec) and not f.region_ready(rec)
        return dict(key=k1, ep=f.episode_id("default/j", 0),
                    ttl=f.REGION_TTL_S, max_age=f.MIRROR_MAX_AGE_S,
                    states=list(f.REGION_STATES))
    rec = both(sc)
    assert rec["ep"].startswith("ep-") and len(rec["ep"]) == 19


def test_mirror_staleness_bound_enforced():
    def sc(s):
        t = Clock(100.0)
        m = s.mirror.RegionMirror("ra", "http://unused", max_age_s=30.0,
                                  now=t)
        assert m.age_s() == float("inf")
        with pytest.raises(s.mirror.MirrorStaleError):
            m.read_checked()
        m._bootstrapped = True
        m._fresh_ts = t()
        t.t = 120.0
        assert m.read_checked() is m.cluster
        t.t = 140.0
        with pytest.raises(s.mirror.MirrorStaleError) as ei:
            m.read_checked()
        t.t = 101.0
        with pytest.raises(s.mirror.MirrorStaleError):
            m.read_checked(max_age_s=0.5)
        return (ei.value.age_s, ei.value.bound_s)
    assert both(sc) == (40.0, 30.0)


def _wire(s, **kw):
    httpd, st = s.serve(port=0, durable=s.DurableStore(tempfile.mkdtemp()),
                        **kw)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    return httpd, st, url


def test_mirror_bootstraps_and_tails_a_live_server():
    def sc(s):
        httpd, st, url = _wire(s)
        rc = s.RemoteCluster(url)
        try:
            rc.add_node(s.Node(name="n0", labels=s.labels(),
                               allocatable={s.device: 4}))
            rc.add_vcjob(global_job(s, "j1"))
            m = s.mirror.RegionMirror("ra", url)
            m.poll()
            first = (sorted(m.cluster.nodes), sorted(m.cluster.vcjobs))
            rc.add_node(s.Node(name="n1", labels=s.labels(),
                               allocatable={s.device: 4}))
            rc.delete_vcjob("default/j1")
            applied = m.poll(timeout=3.0)
            assert applied >= 2 and m.age_s() < 5.0
            st_ = m.status()
            return dict(first=first, nodes=sorted(m.cluster.nodes),
                        jobs=sorted(m.cluster.vcjobs),
                        alloc=float(m.cluster.nodes["n1"].allocatable[
                            s.device]),
                        resyncs=st_["resyncs"],
                        refused=st_["refused_batches"])
        finally:
            rc.close()
            httpd.shutdown()
            httpd.server_close()
    rec = both(sc)
    assert rec["first"] == (["n0"], ["default/j1"])
    assert rec["nodes"] == ["n0", "n1"] and rec["jobs"] == []
    assert (rec["resyncs"], rec["refused"]) == (1, 0)


def test_mirror_refuses_corrupt_batch_wholesale():
    def sc(s):
        plan = s.faults.FaultPlan(7, [s.faults.FaultRule(
            "server", "corrupt_ship", route="/wal", max_injections=1)])
        httpd, st, url = _wire(s, faults=plan)
        rc = s.RemoteCluster(url)
        try:
            m = s.mirror.RegionMirror("ra", url)
            m.poll()
            for i in range(6):
                rc.add_node(s.Node(name=f"n{i}", labels=s.labels(),
                                   allocatable={s.device: 4}))
            with pytest.raises(s.replication.ShippedCorruptionError):
                m.poll(timeout=3.0)
            refused, seq = m.refused_batches, m.applied_seq
            nodes_after_refusal = len(m.cluster.nodes)
            m.poll(timeout=3.0)
            return dict(refused=refused, nodes_after_refusal=(
                nodes_after_refusal), seq_after_refusal=seq,
                nodes=len(m.cluster.nodes))
        finally:
            rc.close()
            httpd.shutdown()
            httpd.server_close()
    rec = both(sc)
    assert rec["refused"] == 1 and rec["nodes_after_refusal"] == 0
    assert rec["nodes"] == 6


def test_mirror_refuses_gapped_batch_wholesale():
    """A batch with a record missing in the middle: nothing of it is
    applied and the cursor stays put, so the re-request gets the
    whole run."""
    def sc(s):
        httpd, st, url = _wire(s)
        rc = s.RemoteCluster(url)
        try:
            m = s.mirror.RegionMirror("ra", url)
            m.poll()
            for i in range(4):
                rc.add_node(s.Node(name=f"n{i}", labels=s.labels(),
                                   allocatable={s.device: 4}))
            lines = m._get(f"/wal?mirror=1&since_seq={m.applied_seq}"
                           "&timeout=3", timeout=13.0)["records"]
            seq0 = m.applied_seq
            with pytest.raises(s.replication.ShippedCorruptionError,
                               match="sequence gap"):
                m._apply(lines[:1] + lines[2:])
            assert m.applied_seq == seq0 and not m.cluster.nodes
            m._apply(lines)
            return dict(records=len(lines), refused=m.refused_batches,
                        nodes=sorted(m.cluster.nodes))
        finally:
            rc.close()
            httpd.shutdown()
            httpd.server_close()
    rec = both(sc)
    assert rec["refused"] == 1 and rec["nodes"] == [f"n{i}"
                                                    for i in range(4)]


def test_mirror_delta_resync_across_restart():
    def sc(s):
        d = tempfile.mkdtemp()
        httpd, st = s.serve(port=0, durable=s.DurableStore(d))
        port = httpd.server_address[1]
        url = f"http://127.0.0.1:{port}"
        rc = s.RemoteCluster(url)
        m = s.mirror.RegionMirror("ra", url)
        node = lambda n: s.Node(name=n, labels=s.labels(),  # noqa: E731
                                allocatable={s.device: 4})
        try:
            rc.add_node(node("n0"))
            m.poll()
            base = m.epoch.split(".")[0]
            rc.add_node(node("n1"))
            rc.add_vcjob(global_job(s, "j1"))
        finally:
            rc.close()
            httpd.shutdown()
            httpd.server_close()
            st.durable.close()
        httpd, st = s.serve(port=port, durable=s.DurableStore(d))
        rc = s.RemoteCluster(url)
        try:
            rc.add_node(node("n2"))
            m.poll(timeout=3.0)
            after = dict(m.status())
            same_base = m.epoch.split(".")[0] == base
            nodes = sorted(m.cluster.nodes)
        finally:
            rc.close()
            httpd.shutdown()
            httpd.server_close()
            st.durable.close()
        return dict(delta=after["delta_resyncs"], resyncs=after["resyncs"],
                    same_base=same_base, nodes=nodes,
                    jobs=sorted(m.cluster.vcjobs))
    rec = both(sc)
    assert rec == dict(delta=1, resyncs=2, same_base=True,
                       nodes=["n0", "n1", "n2"], jobs=["default/j1"])


# -- router: admission, restart, loss, cutover ----------------------------

def test_admission_scores_locality_over_price():
    def sc(s):
        f = s.fedapi
        clock = Clock()
        g, router, handles = fleet(
            s, {"ra": {"price": 1.0}, "rb": {"price": 0.5}}, clock)
        router.sync()
        g.add_vcjob(global_job(s, "cheap"))
        g.add_vcjob(global_job(s, "near", annotations={
            f.FED_DATA_LOCALITY_ANNOTATION: "ra"}))
        router.sync()
        for name, region_ in (("cheap", "rb"), ("near", "ra")):
            job = g.vcjobs[f"default/{name}"]
            assert f.admitted_region(job) == region_
            copy = handles[region_][0].vcjobs[job.key]
            assert f.home_key(copy) == job.key
            assert copy.annotations[f.FED_ADMISSION_KEY_ANNOTATION] == \
                f.admission_key(job.key, 0)
        g.add_vcjob(global_job(s, "huge", replicas=64))
        router.sync()
        assert f.admitted_region(g.vcjobs["default/huge"]) is None
        return dict(jobs=job_record(s, g), regions={
            n: (r["capacity_chips"], r["idle_chips"], r["state"])
            for n, r in sorted(g.regions.items())})
    rec = both(sc)
    # no regional controllers run: the copies hold no pods yet
    assert rec["regions"]["ra"][:2] == (16.0, 16.0)


def test_router_restart_mid_admission_readmits_idempotently():
    def sc(s):
        f = s.fedapi
        clock = Clock()
        g, router, handles = fleet(
            s, {"ra": {"price": 0.5}, "rb": {"price": 1.0}}, clock)
        router.sync()
        g.add_vcjob(global_job(s, "train"))
        router.sync()
        job = g.vcjobs["default/train"]
        assert f.admitted_region(job) == "ra"
        for k in (f.FED_ADMITTED_REGION_ANNOTATION,
                  f.FED_ADMITTED_TS_ANNOTATION,
                  f.FED_ADMISSION_KEY_ANNOTATION,
                  f.FED_REGIONAL_PHASE_ANNOTATION):
            job.annotations.pop(k, None)
        g.update_vcjob(job)
        ra_rec = dict(g.regions["ra"])
        ra_rec["price"] = 10.0
        g.put_object("region", ra_rec, key="ra")
        router2 = s.router.FederationRouter(g, now=clock,
                                            start_mirrors=False)
        for name, (rc, m) in handles.items():
            router2.handles[name] = type(router.handles[name])(
                name, dict(g.regions[name]), rc, m)
        router2.sync()
        assert f.admitted_region(g.vcjobs["default/train"]) == "ra"
        assert "default/train" not in handles["rb"][0].vcjobs
        return dict(jobs=job_record(s, g),
                    copies={n: sorted(h[0].vcjobs)
                            for n, h in handles.items()})
    both(sc)


def test_region_loss_requeues_globally_with_folded_resume():
    def sc(s):
        f, sh = s.fedapi, s.slicehealth
        clock = Clock()
        g, router, handles = fleet(
            s, {"ra": {"price": 0.5}, "rb": {"price": 1.0}}, clock)
        router.sync()
        g.add_vcjob(global_job(s, "train"))
        router.sync()
        ra, ra_mirror = handles["ra"]
        copy = ra.vcjobs["default/train"]
        copy.phase = s.types.JobPhase.RUNNING
        copy.annotations[sh.LAST_STEP_ANNOTATION] = "1200"
        copy.annotations[sh.RESUME_STEP_ANNOTATION] = "1200"
        router.sync()
        folded = job_record(s, g)
        ra_mirror.age = 10_000.0
        clock.t += f.REGION_TTL_S + 10
        router.sync()
        job = g.vcjobs["default/train"]
        assert g.regions["ra"]["state"] == f.REGION_STATE_LOST
        assert f.admitted_region(job) == "rb"
        assert job.annotations[f.FED_ATTEMPT_ANNOTATION] == "1"
        new_copy = handles["rb"][0].vcjobs["default/train"]
        assert new_copy.annotations[sh.RESUME_STEP_ANNOTATION] == "1200"
        assert new_copy.annotations[f.FED_ADMISSION_KEY_ANNOTATION] == \
            f.admission_key(job.key, 1)
        return dict(folded=folded, jobs=job_record(s, g),
                    requeues=counters(s, "federation_requeues_total",
                                      ("ra", "rb")),
                    admissions=counters(s, "federation_admissions_total",
                                        ("ra", "rb")))
    rec = both(sc)
    assert rec["folded"]["default/train"]["last"] == "1200"
    assert rec["jobs"]["default/train"]["migrated_from"] == "ra"


def _evacuated_fleet(s, clock):
    f, e = s.fedapi, s.eapi
    g, router, handles = fleet(
        s, {"ra": {"price": 0.5}, "rb": {"price": 1.0}}, clock)
    router.sync()
    g.add_vcjob(global_job(s, "train"))
    router.sync()
    job = g.vcjobs["default/train"]
    ra = handles["ra"][0]
    copy = ra.vcjobs["default/train"]
    copy.phase = s.types.JobPhase.RUNNING
    copy.annotations[s.slicehealth.RESUME_STEP_ANNOTATION] = "900"
    pg = s.PodGroup(name="train", namespace="default", min_member=2)
    pg.annotations[e.ELASTIC_EVACUATE_ANNOTATION] = "rb"
    pg.annotations[e.ELASTIC_EVACUATED_ANNOTATION] = "true"
    ra.add_podgroup(pg)
    job.annotations[f.FED_EVACUATING_TO_ANNOTATION] = "rb"
    g.update_vcjob(job)
    return g, router, handles


def test_cutover_refused_on_stale_destination_mirror():
    def sc(s):
        f = s.fedapi
        clock = Clock()
        g, router, handles = _evacuated_fleet(s, clock)
        rb, rb_mirror = handles["rb"]
        rb_mirror.age = f.MIRROR_MAX_AGE_S + 5.0
        router.sync()
        refused = dict(jobs=job_record(s, g),
                       copies={n: sorted(h[0].vcjobs)
                               for n, h in handles.items()},
                       refusals=counters(
                           s, "federation_cutover_refusals_total",
                           ("rb",)))
        assert "default/train" not in rb.vcjobs
        rb_mirror.age = 0.0
        router.sync()
        job = g.vcjobs["default/train"]
        assert f.admitted_region(job) == "rb"
        assert f.migration_count(job) == 1
        new_copy = rb.vcjobs["default/train"]
        assert new_copy.annotations[
            s.slicehealth.RESUME_STEP_ANNOTATION] == "900"
        assert s.eapi.ELASTIC_EVACUATE_ANNOTATION not in \
            new_copy.annotations
        assert f.episode_of(new_copy) == f.episode_of(job)
        assert f.episode_hop(new_copy) == 1
        return dict(refused=refused, jobs=job_record(s, g),
                    copies={n: sorted(h[0].vcjobs)
                            for n, h in handles.items()})
    rec = both(sc)
    assert rec["refused"]["refusals"] == {"rb": 1.0}
    assert rec["refused"]["jobs"]["default/train"]["region"] == "ra"


def test_job_chips_counts_gang_demand():
    def sc(s):
        return (s.router.job_chips(global_job(s, "j", replicas=8,
                                              per_pod=4)),
                s.router.job_chips(s.VCJob(name="cpu", tasks=[s.TaskSpec(
                    name="d", replicas=2, template=s.make_pod(
                        "t", requests={"cpu": 4}))])))
    assert both(sc) == (32.0, 0.0)
    # the port counts nvidia.com/gpu, not the reference's resource
    tpu_only = PORT.VCJob(name="t", tasks=[PORT.TaskSpec(
        name="d", replicas=2, template=PORT.make_pod(
            "t", requests={"google.com/tpu": 4}))])
    assert PORT.router.job_chips(tpu_only) == 0.0


def test_retry_policy_contract():
    def sc(s):
        fr = s.retry
        delays = [fr.backoff_delay(a, "ra") for a in range(1, 12)]
        for attempt, d in zip(range(1, 12), delays):
            env = min(fr.BREAKER_COOLDOWN_CAP_S,
                      fr.BREAKER_COOLDOWN_BASE_S * 2 ** (attempt - 1))
            assert env / 2 <= d < env
        t = Clock(0.0)
        rpc = fr.FedRPC(now=t)

        def boom():
            raise OSError("connection refused")
        for _ in range(fr.BREAKER_THRESHOLD):
            with pytest.raises(fr.FedRPCError):
                rpc.call("ra", "add_vcjob", boom)
        opened = rpc.state("ra")
        with pytest.raises(fr.RegionTrippedError):
            rpc.call("ra", "add_vcjob", lambda: "never runs")
        t.t = 100.0
        assert rpc.call("ra", "add_vcjob", lambda: "ok") == "ok"

        def fenced():
            raise ValueError("fenced: router term 1 below floor 2")
        with pytest.raises(fr.RouterFencedError):
            rpc.call("rb", "update_vcjob", fenced)
        return dict(delays=delays, opened=opened, closed=rpc.state("ra"),
                    rb=rpc.state("rb"))
    rec = both(sc)
    assert rec["opened"] == REF.retry.STATE_OPEN


def test_serving_qps_headroom_routing():
    def sc(s):
        a = s.sapi
        clock = Clock()
        g, router, handles = fleet(
            s, {"ra": {"price": 0.5}, "rb": {"price": 1.0}}, clock)
        pg = s.PodGroup(name="chat", namespace="default", min_member=2)
        pg.annotations[a.SLO_P99_MS_ANNOTATION] = "200"
        pg.annotations[a.TARGET_QPS_ANNOTATION] = "100"
        pg.annotations[a.PG_REPLICAS_ANNOTATION] = "2"
        pg.annotations[a.PG_QPS_ANNOTATION] = "200"
        handles["ra"][0].add_podgroup(pg)
        router.sync()
        g.add_vcjob(global_job(s, "train"))
        g.add_vcjob(global_job(s, "serve", annotations={
            a.SLO_P99_MS_ANNOTATION: "200"}))
        router.sync()
        return dict(headroom=dict(router._serving_headroom),
                    jobs=job_record(s, g))
    rec = both(sc)
    assert rec["jobs"]["default/train"]["region"] == "ra"
    assert rec["jobs"]["default/serve"]["region"] == "rb"


# -- the mixed stream: admissions, requeues and migrations ----------------

def test_admissions_requeues_and_migrations_match_the_reference():
    """Three regions of different sizes and prices, a stream of gangs
    of every size (some held to a region by locality), a region lost
    mid-stream, an evacuation, and the queue drained as capacity frees:
    every pass's decisions are the reference's."""
    def sc(s):
        f, sh = s.fedapi, s.slicehealth
        clock = Clock()
        g, router, handles = fleet(s, {
            "ra": {"price": 1.0, "region_kw": {"nodes": 8}},
            "rb": {"price": 0.7, "region_kw": {"nodes": 4}},
            "rc": {"price": 0.9, "region_kw": {"nodes": 6}}}, clock)
        passes = []
        router.sync()
        sizes = [(1, 4), (2, 4), (4, 4), (8, 4), (2, 2), (3, 4), (6, 4),
                 (1, 1), (4, 2), (5, 4)]
        for i, (replicas, per_pod) in enumerate(sizes):
            ann = {f.FED_DATA_LOCALITY_ANNOTATION: "rc"} if i % 4 == 3 \
                else None
            g.add_vcjob(global_job(s, f"j{i:02d}", replicas=replicas,
                                   per_pod=per_pod, annotations=ann))
            if i % 3 == 2:
                router.sync()
                clock.t += 1.0
                passes.append(job_record(s, g))
        router.sync()
        passes.append(job_record(s, g))
        # the regions run what they were given, stamping steps
        for name, (rc, _m) in handles.items():
            for job in rc.vcjobs.values():
                job.phase = s.types.JobPhase.RUNNING
                job.annotations[sh.LAST_STEP_ANNOTATION] = "50"
                job.annotations[sh.RESUME_STEP_ANNOTATION] = "40"
        router.sync()
        passes.append(job_record(s, g))
        # rb goes dark
        handles["rb"][1].age = 10_000.0
        clock.t += f.REGION_TTL_S + 10
        router.sync()
        passes.append(job_record(s, g))
        # rc finishes its first job, ra's biggest gang is evacuated
        done = sorted(handles["rc"][0].vcjobs)[:1]
        for key in done:
            handles["rc"][0].delete_vcjob(key)
            g.delete_vcjob(key)
        ra = handles["ra"][0]
        if ra.vcjobs:
            key = max(ra.vcjobs,
                      key=lambda k: s.router.job_chips(ra.vcjobs[k]))
            ns, _, name = key.partition("/")
            pg = s.PodGroup(name=name, namespace=ns, min_member=1)
            pg.annotations[s.eapi.ELASTIC_EVACUATE_ANNOTATION] = "rc"
            pg.annotations[s.eapi.ELASTIC_EVACUATED_ANNOTATION] = "true"
            ra.add_podgroup(pg)
            job = g.vcjobs[key]
            job.annotations[f.FED_EVACUATING_TO_ANNOTATION] = "rc"
            g.update_vcjob(job)
        for _ in range(3):
            clock.t += 1.0
            router.sync()
            passes.append(job_record(s, g))
        return dict(passes=passes,
                    copies={n: sorted(h[0].vcjobs)
                            for n, h in handles.items()},
                    states={n: r["state"] for n, r in g.regions.items()},
                    admissions=counters(s, "federation_admissions_total",
                                        ("ra", "rb", "rc")),
                    requeues=counters(s, "federation_requeues_total",
                                      ("ra", "rb", "rc")))
    rec = both(sc)
    final = rec["passes"][-1]
    assert rec["states"]["rb"] == REF.fedapi.REGION_STATE_LOST
    assert sum(rec["requeues"].values()) >= 1
    assert any(j["migrations"] for j in final.values())
    assert {j["region"] for j in final.values()} - {None} <= {"ra", "rc"}


# -- learned goodput by GPU generation ------------------------------------

def test_learned_goodput_keys_gpu_generations():
    """Two regions at equal price, h100 and h200 hosts: the router
    learns steps/s/GPU per (region, generation) from the mirrors' step
    deltas, and the next gang goes where the measured goodput is
    higher."""
    s = PORT
    f, sh = s.fedapi, s.slicehealth
    clock = Clock()
    g, router, handles = fleet(s, {
        "ra": {"price": 1.0, "region_kw": {"product": H100}},
        "rb": {"price": 1.0, "region_kw": {"product": H200}}}, clock)
    router.sync()
    assert router._region_generation(router.handles["ra"]) == "h100"
    assert router._region_generation(router.handles["rb"]) == "h200"
    jobs = {}
    for name, region_ in (("a", "ra"), ("b", "rb")):
        g.add_vcjob(global_job(s, name, annotations={
            f.FED_DATA_LOCALITY_ANNOTATION: region_}))
    router.sync()
    for name, region_ in (("a", "ra"), ("b", "rb")):
        jobs[name] = handles[region_][0].vcjobs[f"default/{name}"]
        jobs[name].phase = s.types.JobPhase.RUNNING
    for step in range(1, 4):
        clock.t += 10.0
        jobs["a"].annotations[sh.LAST_STEP_ANNOTATION] = str(step * 100)
        jobs["b"].annotations[sh.LAST_STEP_ANNOTATION] = str(step * 200)
        router.sync()
    learned = dict(router._goodput)
    assert set(learned) == {("ra", "h100"), ("rb", "h200")}, learned
    # 100 steps / 10 s over 8 GPUs, and twice that
    assert learned[("ra", "h100")] == pytest.approx(1.25)
    assert learned[("rb", "h200")] == pytest.approx(2.5)
    dumped = s.metrics.dump()
    assert 'federation_region_goodput_steps_per_chip{region="rb"} 2.5' \
        in dumped
    g.add_vcjob(global_job(s, "next", replicas=1))
    router.sync()
    assert f.admitted_region(g.vcjobs["default/next"]) == "rb"


# -- router HA and the episode chain --------------------------------------

def test_router_failover_two_routers():
    """Two routers on one global store over two live regional servers:
    the leaseholder dies mid-cutover, the standby adopts and lands the
    gang exactly once, the fence refuses the dead router's late
    write."""
    def sc(s):
        f = s.fedapi
        t = [1000.0]
        g = s.FakeCluster()
        g.lease_now = lambda: t[0]
        servers, stages, routers = {}, {}, []
        try:
            for name, price in (("ra", 1.0), ("rb", 0.7)):
                httpd, st, url = _wire(s)
                servers[name] = (httpd, st, url, price)
                stage = stages[name] = s.RemoteCluster(url)
                for i in range(4):
                    stage.add_node(s.Node(
                        name=f"{name}-n{i}", labels=s.labels(),
                        allocatable={s.device: 4, "cpu": 64}))

            def make_router(holder):
                r = s.router.FederationRouter(g, elect=True, holder=holder,
                                              start_mirrors=False)
                for name, (_h, _st, url, price) in servers.items():
                    r.attach_region(
                        f.region_record(name, url, price=price),
                        client=s.RemoteCluster(url, retry_deadline=5.0),
                        mirror=s.mirror.RegionMirror(name, url))
                routers.append(r)
                return r

            def pump(r):
                for h in r.handles.values():
                    h.mirror.poll(timeout=0.0)
                r.sync()

            r1, r2 = make_router("r1"), make_router("r2")
            pump(r1)
            pump(r2)
            assert r1.elector.is_leader and not r2.elector.is_leader
            g.add_vcjob(global_job(s, "train"))
            pump(r1)
            admitted = f.admitted_region(g.vcjobs["default/train"])
            deadline = time.monotonic() + 20
            while "default/train" not in stages["rb"].vcjobs:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            copy = stages["rb"].vcjobs["default/train"]
            copy.phase = s.types.JobPhase.RUNNING
            copy.annotations[s.slicehealth.RESUME_STEP_ANNOTATION] = "900"
            stages["rb"].update_vcjob(copy)
            pg = s.PodGroup(name="train", namespace="default", min_member=2)
            pg.annotations[s.eapi.ELASTIC_EVACUATE_ANNOTATION] = "ra"
            pg.annotations[s.eapi.ELASTIC_EVACUATED_ANNOTATION] = "true"
            stages["rb"].add_podgroup(pg)
            job = g.vcjobs["default/train"]
            job.annotations[f.FED_EVACUATING_TO_ANNOTATION] = "ra"
            g.update_vcjob(job)
            t[0] += f.ROUTER_LEASE_TTL_S + 1
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                pump(r2)
                if f.admitted_region(g.vcjobs["default/train"]) == "ra":
                    break
                time.sleep(0.05)
            pump(r2)
            job = g.vcjobs["default/train"]
            new_copy = r2.handles["ra"].mirror.cluster.vcjobs[
                "default/train"]
            with pytest.raises(ValueError, match="^fenced"):
                r1.handles["rb"].client.add_vcjob(global_job(s, "late"))
            fen = stages["rb"].fences()[f.ROUTER_LEASE_NAME]
            r1.sync()
            return dict(admitted=admitted, region=f.admitted_region(job),
                        migrations=f.migration_count(job),
                        term=r2.elector.term,
                        resume=new_copy.annotations[
                            s.slicehealth.RESUME_STEP_ANNOTATION],
                        fence_term=fen["term"] >= 2,
                        refused=fen["refused"] >= 1,
                        late="default/late" in stages["rb"].vcjobs,
                        r1_leader=r1.elector.is_leader,
                        r2_leader=r2.elector.is_leader)
        finally:
            for r in routers:
                for h in r.handles.values():
                    h.client.close()
                r.close()
            for stage in stages.values():
                stage.close()
            for httpd, st, _url, _price in servers.values():
                httpd.shutdown()
                httpd.server_close()
                st.durable.close()
    rec = both(sc)
    assert rec == dict(admitted="rb", region="ra", migrations=1, term=2,
                       resume="900", fence_term=True, refused=True,
                       late=False, r1_leader=False, r2_leader=True)


def test_episode_propagation_end_to_end():
    def sc(s):
        f, sh = s.fedapi, s.slicehealth
        clock = Clock()
        g, router, handles = fleet(
            s, {"ra": {"price": 0.5}, "rb": {"price": 1.0}}, clock)
        router.sync()
        g.add_vcjob(global_job(s, "train"))
        router.sync()
        job = g.vcjobs["default/train"]
        episode = f.episode_of(job)
        assert episode == f.episode_id("default/train", 0)
        assert f.episode_ts(job) == clock.t
        rc = handles["ra"][0]
        jc = s.JobController()
        jc.initialize(rc)
        jc.sync()
        pods = [p for p in rc.pods.values()
                if p.annotations.get(f.FED_EPISODE_ANNOTATION)]
        assert pods and all(f.episode_of(p) == episode for p in pods)
        copy = rc.vcjobs["default/train"]
        copy.phase = s.types.JobPhase.RUNNING
        copy.annotations[sh.LAST_STEP_ANNOTATION] = "1200"
        copy.annotations[sh.RESUME_STEP_ANNOTATION] = "1200"
        router.sync()
        handles["ra"][1].age = 10_000.0
        clock.t += f.REGION_TTL_S + 10
        router.sync()
        job = g.vcjobs["default/train"]
        assert f.episode_of(job) == episode and f.episode_hop(job) == 1
        return dict(jobs=job_record(s, g), pods=len(pods))
    both(sc)


def _episodic_podgroup(s, rc, key, episode, hop, start, step=0.2):
    ns, _, name = key.partition("/")
    pg = s.PodGroup(name=name, namespace=ns, min_member=2)
    pg.annotations[s.fedapi.FED_EPISODE_ANNOTATION] = episode
    pg.annotations[s.fedapi.FED_EPISODE_HOP_ANNOTATION] = str(hop)
    ts = start
    for phase in s.trace.PHASES:
        s.trace.stamp_phase(pg.annotations, phase, ts)
        ts += step
    rc.add_podgroup(pg)
    return pg


def test_stitch_survives_router_failover_mid_episode():
    def sc(s):
        f = s.fedapi
        t = [1000.0]
        g = s.FakeCluster()
        g.lease_now = lambda: t[0]
        regions = {}

        def make_router(holder):
            r = s.router.FederationRouter(g, elect=True, holder=holder,
                                          now=lambda: t[0],
                                          start_mirrors=False)
            for name in ("ra", "rb"):
                rc = regions.setdefault(name, region(s, name))
                r.attach_region(f.region_record(name, f"fake://{name}"),
                                client=rc, mirror=FakeMirror(s, name, rc))
            return r

        r1, r2 = make_router("r1"), make_router("r2")
        try:
            r1.sync()
            r2.sync()
            g.add_vcjob(global_job(s, "train", annotations={
                f.FED_DATA_LOCALITY_ANNOTATION: "ra"}))
            r1.sync()
            episode = f.episode_of(g.vcjobs["default/train"])
            _episodic_podgroup(s, regions["ra"], "default/train", episode,
                               hop=0, start=t[0])
            t[0] += 2.0
            r1.sync()
            doc1 = g.fleet_traces[episode]
            keys1 = {(c.get("labels") or {}).get("fkey")
                     for c in doc1["root"]["children"]}
            admit = {k for k in keys1
                     if k and k.startswith("router|router-admit")}
            t[0] += f.ROUTER_LEASE_TTL_S + 1
            r2.sync()
            _episodic_podgroup(s, regions["rb"], "default/train", episode,
                               hop=1, start=t[0])
            t[0] += 2.0
            r2.sync()
            doc2 = g.fleet_traces[episode]
            keys2 = {(c.get("labels") or {}).get("fkey")
                     for c in doc2["root"]["children"]}
            assert admit and admit <= keys2
            assert s.trace.is_complete_span(doc2["root"])
            return dict(hops1=doc1["hops"], hops2=doc2["hops"],
                        planes=sorted(doc2["planes"]),
                        grew=doc2["wall_s"] > doc1["wall_s"],
                        leader=r2.elector.is_leader,
                        telescopes=abs(sum(doc2["segments"].values())
                                       - doc2["wall_s"]) < 1e-3)
        finally:
            r1.close()
            r2.close()
    rec = both(sc)
    assert rec["hops2"] == [0, 1] and rec["grew"] and rec["telescopes"]
    assert {"region-ra", "region-rb"} <= set(rec["planes"])


def test_router_module_entry_point_help():
    """`python -m volcano_tpu_torch.federation.router --help` parses."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.federation.router",
         "--help"], cwd=repo, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--store" in proc.stdout
