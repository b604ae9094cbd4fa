"""Process helpers shared by the port's tests: a free TCP port for a
server that a test starts, and the rendezvous store of a group of rank
processes.

Imports neither jax nor the reference, so the GPU tests can use it on a
machine without them.
"""

import contextlib
import socket

# a rank started with this in its env joins the group's store as a
# client (torch's `rendezvous._create_c10d_store`): no rank binds the
# coordinator's port, the process that holds `rendezvous()` does
AGENT_STORE_ENV = {"TORCHELASTIC_USE_AGENT_STORE": "True"}


def free_port() -> int:
    """A port that was free a moment ago, for a server that binds it
    itself.  Not for a process group: another process may take the port
    before the group's rank 0 binds it; use `rendezvous`."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def rendezvous():
    """Hold the store a group of rank processes meets at
    (`bootstrap.local_store`, bound to its port from the start) and
    yield its port; ranks started with `AGENT_STORE_ENV` and
    `COORDINATOR_ADDRESS=127.0.0.1:<port>` join it as clients.  Keep the
    block open until every rank has exited."""
    from volcano_tpu_torch.workloads import bootstrap
    store = bootstrap.local_store()
    try:
        yield store.port
    finally:
        del store
