"""The tests' one source of TCP port numbers.

Ports come from 20000-31999, below the kernel's ephemeral range (32768 up),
so no client connection or ``bind(0)`` can take a port between its pick here
and the server's own bind. Only the even thousands are handed out, so the
port + 1000 that a server binds for its KV events by default is never
anyone's pick. Each xdist worker counts once through its own share of them,
so one run never hands a number out twice. Pick ports in the test or
fixture that binds them.
"""

import os
import socket

_PICKABLE = [p for p in range(20000, 32000) if p // 1000 % 2 == 0]
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
_WORKER = int(os.environ.get("PYTEST_XDIST_WORKER", "gw0")[2:])
_MINE = _PICKABLE[_WORKER * len(_PICKABLE) // _WORKERS:
                  (_WORKER + 1) * len(_PICKABLE) // _WORKERS]
_next = 0


def free_port(span: int = 1) -> int:
    """A port on 127.0.0.1 that nothing holds; with ``span``, the first of
    that many consecutive ones (a sidecar's DP ranks listen on port + i)."""
    global _next
    while _next + span <= len(_MINE):
        ports = _MINE[_next:_next + span]
        _next += span
        if ports[-1] - ports[0] != span - 1:
            continue  # across a thousand
        try:
            for p in ports:
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
        except OSError:
            continue
        return ports[0]
    raise RuntimeError(f"this worker's test ports ({_MINE[0]}-{_MINE[-1]}) are used up")
