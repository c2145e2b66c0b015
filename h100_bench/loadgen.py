"""The load generator, run as a child process of ``run.py`` so that the
client does not share the engine process's interpreter lock.

It reads one JSON document on standard input::

    {"host": ..., "port": ..., "loop": "open" | "closed", "clients": n,
     "start": <time.monotonic() of the window's opening>, "seconds": s,
     "requests": [{"rid", "due", "prompt", "max_tokens"}, ...]}

and posts each request to ``/v1/completions`` with ``stream: true``,
``temperature: 0`` and ``ignore_eos``: an open loop at ``start + due``, a
closed loop as ``clients`` clients that each send their next request when
the last one has finished, until the window closes. It writes one JSON
document to standard output: per request the times (``time.monotonic``,
which all processes of the machine share) at which it was due and sent,
the arrival time and character count of every streamed piece, the usage it
ended with, its text, and its error if it failed. Standard library only.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time

TIMEOUT_S = 300.0


async def _read_chunk(reader: asyncio.StreamReader) -> bytes:
    size = int((await reader.readline()).split(b";")[0].strip(), 16)
    data = await reader.readexactly(size) if size else b""
    await reader.readexactly(2)
    return data


async def one(host: str, port: int, req: dict, due: float) -> dict:
    rec = {"rid": req["rid"], "due": due, "prompt_tokens": len(req["prompt"]),
           "max_tokens": req["max_tokens"], "pieces": [], "text": "",
           "completion_tokens": None, "finish": None, "error": None}
    body = json.dumps({"model": "bench", "prompt": req["prompt"],
                       "max_tokens": req["max_tokens"], "temperature": 0,
                       "stream": True, "ignore_eos": True,
                       "request_id": req["rid"]}).encode()
    head = (f"POST /v1/completions HTTP/1.1\r\nHost: {host}:{port}\r\n"
            f"Content-Type: application/json\r\nContent-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n").encode()
    writer = None
    try:
        reader, writer = await asyncio.open_connection(host, port)
        rec["sent"] = time.monotonic()
        writer.write(head + body)
        await writer.drain()
        status = (await reader.readline()).decode("latin-1").split(" ")
        headers = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1").lower()
        if len(status) < 2 or status[1] != "200":
            rest = await reader.read(2000)
            raise RuntimeError(f"HTTP {' '.join(status[1:]).strip()}: {rest[:200]!r}")
        if "chunked" not in headers:
            raise RuntimeError("the response is not a chunked stream")
        buf = b""
        while True:
            chunk = await _read_chunk(reader)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                data = event.decode("utf-8").removeprefix("data: ")
                if data == "[DONE]":
                    continue
                doc = json.loads(data)
                choice = doc["choices"][0]
                now = time.monotonic()
                if choice.get("text"):
                    rec["pieces"].append([now, len(choice["text"])])
                    rec["text"] += choice["text"]
                if choice.get("finish_reason") is not None:
                    rec["finish"] = choice["finish_reason"]
                    rec["done"] = now
                    rec["completion_tokens"] = doc.get("usage", {}).get(
                        "completion_tokens")
        if rec["finish"] is None:
            raise RuntimeError("the stream ended without a finish reason")
    except Exception as e:  # the boundary: every failure is recorded
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        if writer is not None:
            writer.close()
    return rec


async def bounded(host: str, port: int, req: dict, due: float) -> dict:
    """``one`` with a deadline; a request past it is a failure."""
    try:
        return await asyncio.wait_for(one(host, port, req, due), TIMEOUT_S)
    except asyncio.TimeoutError:
        return {"rid": req["rid"], "due": due, "prompt_tokens": len(req["prompt"]),
                "max_tokens": req["max_tokens"], "pieces": [], "text": "",
                "error": f"no finish within {TIMEOUT_S:.0f} s"}


async def drive(spec: dict) -> list[dict]:
    host, port, start = spec["host"], spec["port"], spec["start"]
    reqs = spec["requests"]
    end = start + spec["seconds"]
    if spec["loop"] == "open":
        async def at(req):
            due = start + req["due"]
            await asyncio.sleep(max(0.0, due - time.monotonic()))
            return await bounded(host, port, req, due)

        return list(await asyncio.gather(*(at(r) for r in reqs)))
    out: list[dict] = []
    pool = iter(reqs)

    async def client():
        await asyncio.sleep(max(0.0, start - time.monotonic()))
        while time.monotonic() < end:
            req = next(pool, None)
            if req is None:
                out.append({"rid": "pool", "error": "the request pool ran out",
                            "due": time.monotonic()})
                return
            out.append(await bounded(host, port, req, time.monotonic()))

    await asyncio.gather(*(client() for _ in range(int(spec["clients"]))))
    return out


def main() -> None:
    spec = json.loads(sys.stdin.read())
    json.dump(asyncio.run(drive(spec)), sys.stdout)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
