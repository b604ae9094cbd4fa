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


def run_bench(mode: str, timeout: float):
    """`python -m volcano_tpu_torch.bench <mode>` from the repo root, as
    the reference's smoke tests run `bench.py <mode>`: (the finished
    process, its last JSON line parsed, or None)."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.bench", mode],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=repo)
    line = next((ln for ln in reversed(proc.stdout.strip().splitlines())
                 if ln.startswith("{")), None)
    return proc, (json.loads(line) if line else None)


def bench_ok(proc, out) -> dict:
    """The smoke's JSON line, once the process exited 0 and printed it."""
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert out is not None, proc.stdout[-2000:] + proc.stderr[-2000:]
    return out
