"""Multi-process serving: one engine group over an explicit torch.distributed
process group, with the leader's instruction fan-out.

Port of ``llm_d_inference_scheduler_tpu/engine/multihost.py``. The JAX
package runs one SPMD program over a global mesh; here each process of the
group holds its share of the ranks (``parallel/serve.py``: process-major, a
process holding whole stages under pp, whole tp ranks without it) and the
model's cross-process legs are collectives on the group:

- Process 0 (leader) runs the whole engine: HTTP server, continuous-batching
  loop, allocator, prefix cache. Followers (``process_id > 0``) build the
  same ``TorchEngine`` (their ranks' weights drawn from the same seed, or
  read from the same checkpoint) and then sit in :func:`run_follower`,
  replaying device ops.
- Every device call the engine makes is an *op*: a named method plus a dict
  of host numpy arrays and ints (``core.py`` ``_exec_op``). The leader
  broadcasts (op, args) over a TCP instruction channel before it runs the op
  itself; followers decode and run the same op. Sampling keys are never
  shipped: every process that samples holds the same replicated logits and
  the same seeded generator, advanced identically by the replayed ops.

Failure semantics (as in the JAX module): a group is one unit. Losing any
member makes the next collective hang, so recovery is a restart of the whole
group, never a rejoin.

- The leader watches each follower's socket (after the one-time hello,
  followers never send, so a readable socket means EOF or death) and pings
  the group every ``PING_INTERVAL_S`` so followers can tell an idle leader
  from a dead one. Losing a follower fires ``on_peer_lost``: the engine
  aborts everything in flight, refuses new work and answers 503 on
  ``/health``.
- A follower whose ``recv`` hits EOF or the ping deadline raises
  :class:`LeaderLost`; ``run_follower`` re-raises, so the process exits
  nonzero.

The channel carries pickled tuples with the JAX module's length-prefixed
framing (a JAX leader's pings decode here), on a cluster-internal port: the
same trust domain as the engines' KV side channels.
"""

from __future__ import annotations

import datetime
import logging
import pickle
import socket
import struct
import threading
import time
from typing import Any, Callable

import torch

log = logging.getLogger("engine.multihost")

_LEN = struct.Struct(">I")

PING_INTERVAL_S = 2.0
# Generous: a follower is only in recv between ops, and the ping thread keeps
# sending while the leader's engine thread is busy.
RECV_TIMEOUT_S = 30.0
# Bound of the group's rendezvous and of every collective on it: a process
# that never joins, or a peer that died inside a collective, ends in an
# error instead of a hang.
GROUP_TIMEOUT_S = 120.0


class ChannelBroken(Exception):
    """Leader-side: one or more followers are gone; lockstep is over."""


class LeaderLost(Exception):
    """Follower-side: the leader is gone (EOF) or silent past the ping
    deadline."""


def device_identity(devices: list[torch.device]) -> list[str]:
    """Names that are equal exactly when two processes' devices are the same
    card: host and CUDA uuid (a CPU device is never a card of its own)."""
    host = socket.gethostname()
    out = []
    for d in devices:
        if d.type == "cuda":
            out.append(f"{host}:{torch.cuda.get_device_properties(d).uuid}")
        else:
            out.append(f"{host}:cpu")
    return out


def pick_backend(identities: list[list[str]]) -> str:
    """The group's backend, by rule: ``nccl`` when every rank of every
    process has a CUDA device of its own, ``gloo`` otherwise (NCCL refuses
    two ranks on one card; the CPU has only gloo)."""
    flat = [i for ids in identities for i in ids]
    if all(not i.endswith(":cpu") for i in flat) and len(set(flat)) == len(flat):
        return "nccl"
    return "gloo"


def maybe_init_distributed(cfg, devices: list[torch.device]):
    """The engine group's ``parallel.serve.Comm`` (its process group), from
    ``EngineConfig``'s ``dist_*`` fields, or None when multi-process serving
    is off. ``devices``: this process's ranks' devices.

    Process 0 hosts the rendezvous store at ``dist_coordinator``
    (``host:port``); every process publishes its devices there, and the
    backend follows :func:`pick_backend`, logged once. The group is built as
    an explicit object (a ``TCPStore`` and the backend's process group),
    not as torch.distributed's default group: one process may hold two
    engine groups (a P/D pair's leaders), and every collective names its
    group. Rendezvous and collectives time out after ``GROUP_TIMEOUT_S``."""
    if not cfg.dist_coordinator:
        return None
    import torch.distributed as dist

    n, pid = cfg.dist_num_processes, cfg.dist_process_id
    if n < 2:
        raise ValueError("dist_coordinator set but dist_num_processes < 2")
    if not 0 <= pid < n:
        raise ValueError(f"dist_process_id={pid} outside [0, {n})")
    host, _, port = cfg.dist_coordinator.rpartition(":")
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    store = dist.TCPStore(host, int(port), n, pid == 0, timeout=timeout)
    store.set(f"devices/{pid}", "|".join(device_identity(devices)))
    ids = [store.get(f"devices/{p}").decode().split("|") for p in range(n)]
    backend = pick_backend(ids)
    if pid == 0:
        log.info("engine group of %d processes on %s: backend %s", n,
                 ids, backend)
    return make_comm(store, pid, n, backend,
                     device=devices[0] if len(set(devices)) == 1 else None)


def make_comm(store, rank: int, size: int, backend: str = "gloo",
              device: torch.device | None = None):
    """A ``Comm`` over a new process group of ``backend`` on ``store`` (a
    ``TCPStore`` from :func:`maybe_init_distributed`, or a ``HashStore``
    shared by threads in a test). Both backends time a collective out after
    ``GROUP_TIMEOUT_S`` (NCCL's own default is minutes longer: a dead peer
    would hold the leader in an all-reduce instead of degrading it). An
    NCCL group binds to ``device``, this process's one card, where given."""
    import torch.distributed as dist

    from ..parallel.serve import Comm

    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    prefix = dist.PrefixStore(f"engine/{backend}", store)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        pg = dist.ProcessGroupNCCL(prefix, rank, size, opts)
        if device is not None:
            pg.eager_connect_single_device(device)
    else:
        pg = dist.ProcessGroupGloo(prefix, rank, size, timeout)
    return Comm(pg, rank, size, backend, store)


class InstructionChannel:
    """Length-prefixed pickle fan-out: leader -> all followers, with
    liveness both ways (peer monitors and pings, see the module docstring)."""

    def __init__(self, *, leader: bool, host: str, port: int,
                 n_followers: int = 0, connect_timeout: float = 60.0,
                 ping_interval: float = PING_INTERVAL_S,
                 recv_timeout: float = RECV_TIMEOUT_S,
                 hello: dict[str, Any] | None = None):
        self.leader = leader
        self._lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._closed = False
        self._lost: set[int] = set()
        self.on_peer_lost: Callable[[int, str], None] | None = None
        # One-time follower -> leader handshake, the only bytes a follower
        # sends: its process id and its KV wire addresses, keyed by process
        # id so a sharded export names every process's server.
        self.hellos: dict[int, dict[str, Any]] = {}
        if leader:
            self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._srv.bind((host, port))
            self._srv.listen(n_followers)
            self._peers: list[socket.socket] = []
            deadline = time.monotonic() + connect_timeout
            self._srv.settimeout(connect_timeout)
            while len(self._peers) < n_followers:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"only {len(self._peers)}/{n_followers} followers "
                        "connected to the instruction channel")
                conn, addr = self._srv.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                log.info("follower connected from %s", addr)
                conn.settimeout(connect_timeout)
                try:
                    info = self._recv_one(conn)
                except (OSError, ConnectionError) as e:
                    conn.close()
                    raise ConnectionError(
                        f"follower at {addr} sent no hello: {e}") from e
                conn.settimeout(None)
                pid = int(info.get("process_id", len(self._peers) + 1))
                self.hellos[pid] = info
                self._peers.append(conn)
            self._threads = [
                threading.Thread(target=self._watch_peer, args=(i,),
                                 name=f"mh-watch-{i}", daemon=True)
                for i in range(n_followers)]
            if ping_interval > 0:
                self._threads.append(threading.Thread(
                    target=self._ping_loop, args=(ping_interval,),
                    name="mh-ping", daemon=True))
            for t in self._threads:
                t.start()
        else:
            deadline = time.monotonic() + connect_timeout
            while True:
                try:
                    self._sock = socket.create_connection((host, port),
                                                          timeout=5.0)
                    break
                except OSError as e:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"could not reach instruction channel: {e}") from e
                    time.sleep(0.2)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock.settimeout(recv_timeout)
            payload = pickle.dumps(dict(hello or {}),
                                   protocol=pickle.HIGHEST_PROTOCOL)
            self._sock.sendall(_LEN.pack(len(payload)) + payload)

    @staticmethod
    def _recv_one(sock: socket.socket) -> dict[str, Any]:
        """Read one length-prefixed pickled message from ``sock``."""
        buf = b""
        while len(buf) < _LEN.size:
            chunk = sock.recv(_LEN.size - len(buf))
            if not chunk:
                raise ConnectionError("closed during hello")
            buf += chunk
        (ln,) = _LEN.unpack(buf)
        data = b""
        while len(data) < ln:
            chunk = sock.recv(ln - len(data))
            if not chunk:
                raise ConnectionError("closed during hello")
            data += chunk
        return pickle.loads(data)

    # ---- leader side ----------------------------------------------------

    def _peer_lost(self, idx: int, why: str) -> None:
        with self._state_lock:
            if self._closed or idx in self._lost:
                return
            self._lost.add(idx)
        log.error("follower %d lost (%s): lockstep broken", idx, why)
        cb = self.on_peer_lost
        if cb is not None:
            try:
                cb(idx, why)
            except Exception:
                log.exception("on_peer_lost callback failed")

    def _watch_peer(self, idx: int) -> None:
        """Followers never send: a readable socket means EOF (death)."""
        sock = self._peers[idx]
        try:
            data = sock.recv(1)
        except OSError as e:
            if not self._closed:
                self._peer_lost(idx, f"socket error: {e}")
            return
        if not self._closed:
            self._peer_lost(idx, "EOF" if not data else "unexpected data")

    def _ping_loop(self, interval: float) -> None:
        while not self._closed:
            time.sleep(interval)
            if self._closed:
                return
            try:
                self.broadcast(("ping",), {})
            except ChannelBroken:
                pass  # on_peer_lost already fired; keep pinging survivors

    def broadcast(self, op: tuple, args: dict[str, Any]) -> None:
        if op[0] == "stop":
            # Closed BEFORE the bytes leave: a follower may exit (EOF on its
            # socket) the instant it decodes stop, which _watch_peer must not
            # report as a lost peer.
            with self._state_lock:
                self._closed = True
        payload = pickle.dumps((op, args), protocol=pickle.HIGHEST_PROTOCOL)
        msg = _LEN.pack(len(payload)) + payload
        broken: list[int] = []
        with self._lock:
            for i, peer in enumerate(self._peers):
                if i in self._lost:
                    continue
                try:
                    peer.sendall(msg)
                except OSError:
                    broken.append(i)
        for i in broken:
            self._peer_lost(i, "send failed")
        if self._lost and not self._closed:
            raise ChannelBroken(f"followers lost: {sorted(self._lost)}")

    # ---- follower side --------------------------------------------------

    def recv(self) -> tuple[tuple, dict[str, Any]]:
        try:
            hdr = self._recv_exact(_LEN.size)
            (ln,) = _LEN.unpack(hdr)
            return pickle.loads(self._recv_exact(ln))
        except socket.timeout as e:
            raise LeaderLost(
                f"no instruction or ping within {self._sock.gettimeout()}s: "
                "leader presumed dead or hung") from e
        except ConnectionError as e:
            raise LeaderLost(f"instruction channel closed: {e}") from e

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("instruction channel closed")
            buf += chunk
        return buf

    def close(self) -> None:
        self._closed = True
        if self.leader:
            for peer in self._peers:
                peer.close()
            self._srv.close()
        else:
            self._sock.close()


def run_follower(engine) -> None:
    """Replay loop of a process with ``dist_process_id > 0``: runs the
    leader's device ops in order until the ("stop",) instruction. Raises
    LeaderLost when the leader dies or goes silent, and re-raises an op's
    failure: a follower out of lockstep cannot recover (the next collective
    would hang), so the process exits nonzero and the group restarts."""
    chan = engine._instr_channel
    log.info("follower %d ready (%s)", engine.cfg.dist_process_id,
             engine.layout_summary())
    while True:
        try:
            op, args = chan.recv()
        except LeaderLost:
            log.exception("leader lost; follower exiting for restart")
            raise
        if op[0] == "ping":
            continue
        if op[0] == "stop":
            log.info("follower stopping")
            return
        try:
            engine._exec_op(op, args)
        except Exception:
            log.exception("follower op %s failed; aborting", op)
            raise
