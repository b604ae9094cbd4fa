"""The scheduling parity streams of `test_torch_schedule_parity.py`,
run over HTTP.

Each side's cluster (mirrored as there: TPU slices and DCN pods on the
reference's side, NVLink domains and IB fabrics on the port's, node
names equal) is held by its own state server.  Its `ControllerManager`
and `Scheduler` each run on a `RemoteCluster` of their own, and the
test submits the jobs as kubectl through a third.  A cycle is: the
controllers' mirror resyncs (the delta lane of the watch endpoint) and
the controllers sync; the scheduler's mirror resyncs and the scheduler
runs a cycle; kubectl posts a kubelet tick.  The mirrors resync by
hand, not by their watch threads, so every cycle sees everything the
cycle before it wrote, as the in-process planes do.

After every cycle the server-side placements, job and podgroup phases
and injected env must be equal on both sides, and equal to the
in-process result.  Uids: the server, the controllers and kubectl all
mint on each side's counter in this process, as the in-process planes
do, with one difference: the codec mints a uid the first time it
encodes a class (it samples each field's default factory once to build
the class's encode plan), which shifts every later uid and so the
uid-ordered ties.  The planes build every plan before they count from
1, so over the wire the same uids are minted as in process.  Tolerance:
exact.
"""

import itertools
import types

import pytest

from test_torch_schedule_parity import PORT, REF, Plane, _backlog, _bound
from test_torch_schedule_parity import run_both as run_in_process
from test_torch_wire import PORT as PORT_WIRE
from test_torch_wire import REF as REF_WIRE


class WirePlane:
    """One side's state server, and its controllers, scheduler and
    kubectl each on a RemoteCluster."""

    def __init__(self, side, wire, domains, queues=()):
        wire.codec._build_registry()
        for cls in list(wire.codec._CLASSES.values()):
            wire.codec._enc_plan(cls)
        side.pod._uid_counter = itertools.count(1)
        self.side = side
        cluster = side.FakeCluster()
        for name, shape, group in domains:
            for node in side.nodes(name, shape, group):
                cluster.add_node(node)
        hnc = side.HNC()
        hnc.initialize(cluster)
        hnc.sync()
        for name, weight in queues:
            cluster.add_queue(side.Queue(name=name, weight=weight))
        cluster.admission = side.admission()
        self.httpd, self.server = wire.serve(port=0, cluster=cluster)
        url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.kubectl = wire.RemoteCluster(url, start_watch=False)
        self.mgr_view = wire.RemoteCluster(url, start_watch=False)
        self.sched_view = wire.RemoteCluster(url, start_watch=False)
        self.mgr = side.Manager(self.mgr_view, enabled=["job", "queue"])
        self.sched = side.Scheduler(self.sched_view, schedule_period=0)
        # Plane.submit writes through `self.cluster`: here, kubectl
        self.cluster = self.kubectl

    submit = Plane.submit

    def cycle(self):
        self.mgr_view.resync()
        self.mgr.sync_all()
        self.sched_view.resync()
        self.sched.run_once()
        self.kubectl.tick()

    def state(self):
        return Plane.state(types.SimpleNamespace(
            side=self.side, cluster=self.server.cluster))

    def close(self):
        self.mgr.stop()
        for c in (self.kubectl, self.mgr_view, self.sched_view):
            c.close()
        self.httpd.shutdown()
        self.httpd.server_close()


def run_wire(domains, stream, cycles, queues=()):
    """Both sides over the wire, held to each other after every cycle
    and, at the end, to the in-process planes' states."""
    ref = WirePlane(REF, REF_WIRE, domains, queues)
    try:
        port = WirePlane(PORT, PORT_WIRE, domains, queues)
        try:
            states = []
            for cycle in range(cycles):
                for spec in stream.get(cycle, ()):
                    ref.submit(spec)
                    port.submit(spec)
                ref.cycle()
                port.cycle()
                want, got = ref.state(), port.state()
                assert got == want, f"cycle {cycle} differs over the wire"
                states.append(want)
        finally:
            port.close()
    finally:
        ref.close()
    in_process = run_in_process(domains, stream, cycles, queues)
    for cycle, (wire, local) in enumerate(zip(states, in_process)):
        assert wire == local, f"cycle {cycle}: the wire differs from " \
                              "the in-process planes"
    return states


def test_flat_gang_over_the_wire():
    states = run_wire([("sa", (4, 4), "p0")],
                      {0: [("flat", [("worker", 4, 4, "")], 4, "default",
                            0, None)]}, 3)
    assert states[-1]["jobs"] == {"default/flat": "Running"}
    assert sorted(_bound(states[-1], "flat").values()) == \
        [f"sa-w{i}" for i in range(4)]


def test_two_subgroups_in_two_domains_of_two_fabrics_over_the_wire():
    states = run_wire(
        [("sa", (4, 4), "p0"), ("sb", (4, 4), "p1")],
        {0: [("multi", [("a", 4, 4, "a"), ("b", 4, 4, "b")], 8,
              "default", 0, None)]}, 3)
    bound = _bound(states[-1], "multi")
    assert len(bound) == 8 and all(bound.values())
    domains = {task: {n.split("-w")[0] for k, n in bound.items()
                      if f"-{task}-" in k} for task in ("a", "b")}
    assert domains["a"] != domains["b"]
    env = states[-1]["pods"]["default/multi-b-0"][2]
    assert (env["TPU_SLICE_ID"], env["TPU_NUM_SLICES"]) == ("1", "2")


def test_gang_that_does_not_fit_over_the_wire():
    states = run_wire([("sa", (4, 4), "p0")],
                      {0: [("big", [("worker", 5, 4, "")], 5, "default",
                            0, None)]}, 3)
    assert states[-1]["jobs"] == {"default/big": "Pending"}
    assert not any(_bound(states[-1], "big").values())


@pytest.mark.parametrize("devices", [1, 2, 4])
def test_sub_host_packing_over_the_wire(devices):
    jobs = [(f"p{i}", [("worker", 1, devices, "")], 1, "default", 0, None)
            for i in range(12 // devices)]
    states = run_wire([("sc", (1, 4), "p0"), ("sd", (1, 4), "p0")],
                      {0: jobs}, 3)
    bound = [v[0] for v in states[-1]["pods"].values() if v[0]]
    assert len(bound) == min(len(jobs), 8 // devices)


def test_two_queue_backlog_on_64_hosts_over_the_wire():
    domains, stream = _backlog()
    states = run_wire(domains, stream, 14, queues=[("q-a", 1), ("q-b", 3)])
    assert len(states[-1]["jobs"]) == 50
    phases = states[-1]["jobs"].values()
    assert "Running" in phases or "Completed" in phases
    assert max(sum(1 for v in s["pods"].values() if v[1] == "Running")
               for s in states) > 16
