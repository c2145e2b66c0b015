"""PyTorch port, a two-process engine group over NCCL (marker ``cuda``;
skipped without two GPUs). Both processes come from the server CLI, each
on a card of its own, so the group picks NCCL (``multihost.pick_backend``).
No JAX here: run it on a machine with two or more cards with
``python -m pytest --noconftest -q tests/test_torch_multihost_nccl.py``.

The drills of ``tests/test_torch_multihost.py`` over NCCL, whose
collectives do not fail when a peer's sockets close as gloo's do:

- a killed follower ends the in-flight request within seconds, turns the
  leader's ``/health`` 503 ``degraded`` and new work ends at once;
- a killed leader makes the follower exit nonzero.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from _net import free_port

pytestmark = [pytest.mark.cuda, pytest.mark.skipif(
    not torch.cuda.is_available() or torch.cuda.device_count() < 2,
    reason="needs two CUDA devices (an NCCL group of one rank per card)")]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START_TIMEOUT_S = 240.0


def _cli(pid: int, coord: int, instr: int, port: int) -> list[str]:
    return [sys.executable, "-m", "llm_d_inference_scheduler_tpu_torch.engine.server",
            "--model", "tiny", "--tp-size", "2", "--devices", f"cuda:{pid}",
            "--max-batch", "2", "--max-model-len", "2048", "--port", str(port),
            "--kv-events-port", "0", "--dist-coordinator", f"127.0.0.1:{coord}",
            "--dist-num-processes", "2", "--dist-process-id", str(pid),
            "--dist-instr-port", str(instr)]


def _spawn(argv, log_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(log_path, "wb") as out:  # the child keeps its own descriptor
        return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=out,
                                stderr=subprocess.STDOUT, start_new_session=True)


def _reap(*procs):
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
        p.wait(10)


def _health(port: int) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_health(port: int, want: str, timeout: float, procs=()) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        try:
            status, doc = _health(port)
            if doc.get("status") == want:
                return doc
        except OSError:
            pass
        assert all(p.poll() is None for p in procs), "a group process exited"
        assert time.monotonic() < deadline, f"/health never reported {want}"
        time.sleep(0.2)


def _post(port: int, body: dict, timeout: float):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


@pytest.fixture
def group(tmp_path):
    coord, instr, port = free_port(), free_port(), free_port()
    leader = _spawn(_cli(0, coord, instr, port), tmp_path / "leader.log")
    follower = _spawn(_cli(1, coord, instr, 0), tmp_path / "follower.log")
    try:
        _wait_health(port, "ok", START_TIMEOUT_S, (leader, follower))
        assert "backend nccl" in (tmp_path / "leader.log").read_text()
        yield leader, follower, port, tmp_path
    finally:
        _reap(leader, follower)


def test_nccl_leader_degrades_when_follower_dies(group):
    leader, follower, port, logs = group
    status, doc = _post(port, {"prompt": "hello", "max_tokens": 8, "temperature": 0}, 60)
    assert status == 200 and doc["usage"]["completion_tokens"] == 8
    done = {}

    def long_request():
        t0 = time.monotonic()
        try:
            done["status"], done["doc"] = _post(port, {
                "prompt": "hello", "max_tokens": 1900, "ignore_eos": True,
                "temperature": 0}, 300)
        except urllib.error.HTTPError as e:
            done["status"] = e.code
        except OSError as e:
            done["error"] = repr(e)
        done["s"] = time.monotonic() - t0

    t = threading.Thread(target=long_request)
    t.start()
    time.sleep(1.0)
    os.killpg(follower.pid, signal.SIGKILL)
    t_kill = time.monotonic()
    t.join(150)
    log = (logs / "leader.log").read_text()[-3000:]
    assert not t.is_alive(), "the in-flight request hung:\n" + log
    assert time.monotonic() - t_kill < 15, log
    assert leader.poll() is None, "the leader died:\n" + log
    doc = _wait_health(port, "degraded", 10)
    assert _health(port)[0] == 503 and doc["status"] == "degraded"
    assert (done.get("status") != 200
            or done["doc"]["usage"]["completion_tokens"] < 1900), done
    t0 = time.monotonic()
    try:
        _, doc = _post(port, {"prompt": "hello", "max_tokens": 8}, 30)
        assert doc["usage"]["completion_tokens"] == 0
    except urllib.error.HTTPError:
        pass
    assert time.monotonic() - t0 < 10


def test_nccl_follower_exits_when_leader_crashes(group):
    leader, follower, port, logs = group
    os.killpg(leader.pid, signal.SIGKILL)
    rc = follower.wait(60)
    assert rc != 0, (logs / "follower.log").read_text()[-2000:]
