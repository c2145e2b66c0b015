"""PyTorch port, the device wire on the card (marker ``cuda``; skipped
without a GPU). No JAX here: the card's machine has none, so run it there
with ``python -m pytest --noconftest -q tests/test_torch_kv_device_cuda.py``.

- The CUDA IPC pull across two processes: an exporter process stages two
  shards (``kv_transfer.stage``) and serves their handles; this process
  opens them and copies them bitwise.
- A P/D pair of engines on the card in one process: the importer copies
  from the exporter's staged tensors (CUDA IPC refuses a process's own
  handle), the pull route is ``device`` and the greedy tokens equal a
  monolithic engine's.
"""

import asyncio
import os
import subprocess
import sys

import pytest
import torch

from llm_d_inference_scheduler_tpu_torch.engine import kv_transfer
from llm_d_inference_scheduler_tpu_torch.engine.config import EngineConfig
from llm_d_inference_scheduler_tpu_torch.engine.core import TorchEngine
from llm_d_inference_scheduler_tpu_torch.engine.request import EngineRequest

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = [1] + [(i * 11) % 400 + 3 for i in range(40)]
N_GEN = 6

_EXPORTER = r"""
import sys, torch
from llm_d_inference_scheduler_tpu_torch.engine import kv_transfer
srv = kv_transfer.DeviceWireServer("127.0.0.1", torch.device("cuda"))
g = torch.Generator(device="cuda").manual_seed(3)
ts = [torch.randn(2, 4, 16, 2, 8, generator=g, device="cuda").to(torch.bfloat16)
      for _ in range(2)]
srv.register(11, kv_transfer.stage(ts, torch.tensor([2, 0, 1])))
print(srv.address(), flush=True)
sys.stdin.readline()
"""


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA IPC has no CPU counterpart")


def test_ipc_pull_across_two_processes(gpu):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen([sys.executable, "-c", _EXPORTER], cwd=ROOT, env=env,
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        addr = p.stdout.readline().strip()
        shards, done = kv_transfer.pull(addr, 11)
        got = [s.clone() for s in shards]
        torch.cuda.synchronize()
        done()
        g = torch.Generator(device="cuda").manual_seed(3)
        ts = [torch.randn(2, 4, 16, 2, 8, generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(2)]
        idx = torch.tensor([2, 0, 1], device="cuda")
        for a, t in zip(got, ts):
            assert torch.equal(a, t[:, idx])
    finally:
        p.stdin.write("\n")
        p.stdin.flush()
        p.wait(30)


async def _generate(engine, rid, max_tokens, ktp=None):
    out = engine.submit(EngineRequest(request_id=rid, prompt_token_ids=list(PROMPT),
                                      max_tokens=max_tokens, temperature=0.0,
                                      ignore_eos=True, kv_transfer_params=ktp))
    toks = []
    while True:
        ev = await asyncio.wait_for(out.get(), timeout=120)
        if ev.token_id is not None:
            toks.append(ev.token_id)
        if ev.finish_reason is not None:
            return toks, ev.kv_transfer_params


def test_same_process_device_copy_on_card(gpu):
    common = dict(model="tiny", max_batch=4, max_model_len=256, kv_events_port=0)

    async def body():
        engines = [TorchEngine(EngineConfig(**common, kv_transfer=t))
                   for t in ("device", "device", "host")]
        pre, dec, mono = engines
        for e in engines:
            await e.start()
        try:
            want, _ = await _generate(mono, "m", N_GEN)
            _, ktp = await _generate(pre, "p", 1, {"do_remote_decode": True})
            got, _ = await _generate(dec, "d", N_GEN, ktp)
            return want, got, ktp, dec.kv_import_stats["d"]["route"]
        finally:
            for e in engines:
                await e.stop()

    want, got, ktp, route = asyncio.run(body())
    assert ktp["kv_wire_device"] and route == "device"
    assert got == want
