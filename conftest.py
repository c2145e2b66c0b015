"""Run limits for the tests under ``tests/``.

Each phase of a test there (setup, call, teardown) runs under a time limit,
so a hang fails its own test with every thread's stack and the xdist worker
goes on. The default is about four times the slowest module setup (a fixture
that builds JAX reference engines, ~70 s); ``@pytest.mark.timeout(s)``
tightens it. Past the limit the alarm repeats every GRACE_S, in case the
test's own cleanup hangs too.

Some test files of the JAX side bind the same fixed port numbers. The files
of one group hold one exclusive file lock while they run, so no two of them
run at once, on any xdist worker or in any pytest process that shares the
temporary directory.
"""

import asyncio
import contextlib
import faulthandler
import fcntl
import signal
import tempfile
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent / "tests"
TIMEOUT_S = 300
GRACE_S = 30

# The snapshot-socket tests of the JAX router, each under 1 s when sound,
# get 30 s: on Python 3.12 asyncio.Server.wait_closed() waits for every
# accepted connection, and SnapshotPublisher.stop() awaits it before closing
# its followers' writers (the corrupt-frame test's own server holds its
# writer the same way), so these can hang in teardown.
SNAPSHOT_SOCKET_TESTS = {
    "test_fleet.py::test_snapshot_ipc_round_trip",
    "test_fleet.py::test_kv_replication_round_trip",
    "test_fleet.py::test_subscriber_retarget_mid_backoff",
    "test_snapwire.py::test_binary_ipc_end_to_end",
    "test_snapwire.py::test_subscriber_survives_corrupt_frame_mid_stream",
}

PORT_GROUPS = (
    ("test_autoscale.py", "test_parser_connector_parity.py", "test_tracing.py"),
    ("test_controlplane.py", "test_kv_device_transfer.py", "test_kvobs.py",
     "test_resilience.py"),
    ("test_decisions.py", "test_e2e_disagg.py", "test_kube_binding.py",
     "test_pd_classifier.py"),
    ("test_e2e_epd.py", "test_embeddings.py", "test_responses_api.py"),
    ("test_e2e_gateway.py", "test_engine_robustness.py", "test_predicted_latency.py"),
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "timeout(seconds): a tighter limit than TIMEOUT_S on each phase of the test")


def pytest_collection_modifyitems(items):
    for item in items:
        if (item.path.parent == TESTS
                and f"{item.path.name}::{item.name}" in SNAPSHOT_SOCKET_TESTS):
            item.add_marker(pytest.mark.timeout(30))


@pytest.fixture(scope="module", autouse=True)
def _port_group(request):
    group = next((i for i, files in enumerate(PORT_GROUPS)
                  if request.path.name in files), None)
    if group is None or request.path.parent != TESTS:
        yield
        return
    with open(Path(tempfile.gettempdir()) / f"tests-port-group-{group}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def _alarm(limit):
    def fail(signum, frame):
        with tempfile.TemporaryFile("w+") as f:
            faulthandler.dump_traceback(f)
            with contextlib.suppress(RuntimeError):  # no event loop running
                for task in asyncio.all_tasks(asyncio.get_running_loop()):
                    f.write(f"\n{task.get_name()} awaits (outermost first):\n")
                    coro = task.get_coro()
                    while getattr(coro, "cr_frame", None) is not None:
                        code = coro.cr_frame.f_code
                        f.write(f'  File "{code.co_filename}", line '
                                f"{coro.cr_frame.f_lineno} in {code.co_name}\n")
                        coro = coro.cr_await
            f.seek(0)
            stacks = f.read()
        pytest.fail(f"exceeded the time limit of {limit} s\n{stacks}", pytrace=False)

    return fail


@pytest.hookimpl(hookwrapper=True)
def _limited(item):
    if item.path.parent != TESTS:
        yield
        return
    marker = item.get_closest_marker("timeout")
    limit = marker.args[0] if marker else TIMEOUT_S
    previous = signal.signal(signal.SIGALRM, _alarm(limit))
    signal.setitimer(signal.ITIMER_REAL, limit, GRACE_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


pytest_runtest_setup = pytest_runtest_call = pytest_runtest_teardown = _limited
