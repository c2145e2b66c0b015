"""Tensor-, expert- and pipeline-parallel serving: shards on devices, and
the two collectives of the sharded model.

Port of ``llm_d_inference_scheduler_tpu/parallel/serve.py`` (and of the
layout half of ``parallel/pp_serve.py``). The JAX engine runs one program
over a ``(dp, tp, ep)`` or ``(pp, tp, ep)`` mesh and lets XLA insert the
sums. Here one process drives every shard, as the JAX single controller
does:

- ``ServeLayout`` names the device of each rank ``r = (s * tp + t) * ep +
  e`` (the meshes' ``(pp, tp, ep)`` order; ``pp = 1`` without stages). An
  explicit device list may name one device more than once: the CPU tests
  lay every shard on ``"cpu"``, and one card can hold two shards, so the
  code that many cards would run is checked on one.
- Stage ``s`` holds layers ``[s * L/pp, (s + 1) * L/pp)`` of every stacked
  tensor, split within the stage over ``tp``/``ep`` as without stages; the
  embedding, the final norm and the head live on stage 0 only (the JAX
  mesh replicates them over ``pp``; the ring enters and wraps back there).
- Attention runs once per (stage, ``tp`` rank), on the device of its first
  ``ep`` rank, over that rank's KV pages ``[L/pp, N, block, Hkv/tp, D]``
  (the JAX ``KV_PAGE_SPEC`` and ``PAGE_SPEC``). The ``ep`` ranks of a ``tp`` rank share those pages:
  the JAX mesh keeps an identical copy on each, which one controller has
  no reason to compute twice.
- ``reduce_sum`` adds the row-parallel partials of every rank in rank
  order on one device (the first rank's, where the residual stream
  lives); consumers copy the sum back out to their own devices. Where the
  shards share a device, those copies do nothing.
- ``gather_last`` joins vocab-sharded logits, so sampling and its
  generator run once, as on one device.

Multi-process (``engine/multihost.py``): the ranks span the group's
processes in process-major order, as the JAX global device list orders
them (``engine/core.py:289-305``), and each process holds only its own
ranks' shards and pages (``devices`` names the others ``None``). Under pp a
process holds whole stages; without pp, whole tp ranks with all their ep
ranks (``validate_dist``). The sums and the gather then take a second leg
over the group's ``Comm``: the local partial sum, then ``all_reduce``; the
local vocab slices, then ``all_gather``. Every process of a stage ends with
the same residual stream, and every process of stage 0 with the same
logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import torch

from ..utils.device import resolve_device
from .shardings import param_splits, split_tensor

Params = dict[str, Any]


class Comm:
    """An engine group's process group (an explicit object: no collective
    relies on torch.distributed's default group) and the collectives of the
    sharded model over it. Ops go to the group object's own methods, so a
    group built from a store in a test thread works as one built from the
    coordinator.

    gloo takes CUDA tensors for ``allreduce`` and ``allgather`` (it stages
    them through host memory itself) but not for ``send``/``recv``: those
    stage through pinned host memory here. NCCL takes CUDA tensors for all
    four."""

    def __init__(self, pg, rank: int, size: int, backend: str, store=None):
        self.pg, self.rank, self.size, self.backend = pg, rank, size, backend
        self._store = store  # a TCPStore must outlive its group

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group's processes of ``t`` (contiguous)."""
        t = t.contiguous()
        self.pg.allreduce([t]).wait()
        return t

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's ``t`` joined along the last axis in process
        order (equal shapes)."""
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.size)]
        self.pg.allgather([outs], [t]).wait()
        return torch.cat(outs, dim=-1)

    def abort(self) -> None:
        """After a peer's death: under NCCL, abort the group's communicators,
        so that a collective waiting on the dead peer raises now instead of
        at the group's timeout (gloo's raises by itself once the peer's
        sockets close)."""
        if self.backend == "nccl":
            self.pg.abort()

    def barrier(self, device: torch.device) -> None:
        """Return once every process of the group has called it (a one-element
        sum on ``device``: NCCL reduces only device tensors)."""
        self.all_reduce(torch.zeros(1, device=device))

    def _staged(self, t: torch.Tensor) -> bool:
        return t.device.type == "cuda" and self.backend == "gloo"

    def send(self, t: torch.Tensor, dst: int):
        """Post ``t`` to process ``dst``; returns a handle whose ``wait``
        ends the send (the staging buffer lives as long as the handle)."""
        buf = t.contiguous()
        if self._staged(buf):
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf)
            buf = host
        work = self.pg.send([buf], dst, 0)
        return _Sent(work, buf)

    def recv(self, shape, dtype: torch.dtype, device: torch.device,
             src: int) -> torch.Tensor:
        """The next tensor process ``src`` sent here."""
        if device.type == "cuda" and self.backend == "gloo":
            host = torch.empty(shape, dtype=dtype, pin_memory=True)
            self.pg.recv([host], src, 0).wait()
            return host.to(device)
        out = torch.empty(shape, dtype=dtype, device=device)
        self.pg.recv([out], src, 0).wait()
        return out


class _Sent:
    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    # rank r = (s * tp + t) * ep + e; None: a rank another process holds
    devices: tuple[torch.device | None, ...]
    tp: int = 1
    ep: int = 1
    pp: int = 1
    comm: Comm | None = dataclasses.field(default=None, compare=False, repr=False)

    def ranks(self) -> Iterable[tuple[int, int, int]]:
        """(rank, tp rank, ep rank) of this process's ranks, in rank order
        (``stage_of`` gives the stage)."""
        return ((r, (r // self.ep) % self.tp, r % self.ep)
                for r in range(len(self.devices)) if self.devices[r] is not None)

    @property
    def first_device(self) -> torch.device:
        """This process's first rank's device (stage 0's first rank's on
        one process)."""
        return next(d for d in self.devices if d is not None)

    @property
    def procs(self) -> int:
        return self.comm.size if self.comm is not None else 1

    def proc_of(self, r: int) -> int:
        """The process that holds rank ``r`` (process-major order)."""
        return r // (len(self.devices) // self.procs)

    def stage_of(self, r: int) -> int:
        return r // (self.tp * self.ep)

    def stage_proc(self, s: int) -> int:
        """The process that holds stage ``s`` (under pp every stage lies
        within one process)."""
        return self.proc_of(s * self.tp * self.ep)

    def tp_device(self, t: int, s: int = 0) -> torch.device | None:
        """The device that runs stage ``s``'s ``tp`` rank ``t``'s attention
        and holds its KV pages (None: another process's)."""
        return self.devices[(s * self.tp + t) * self.ep]

    def stage(self, s: int) -> "ServeLayout":
        """Stage ``s``'s ranks as a layout of their own (``pp = 1``); it
        keeps the group where the stage spans processes (no pp)."""
        n = self.tp * self.ep
        return ServeLayout(self.devices[s * n:(s + 1) * n], self.tp, self.ep,
                           comm=self.comm if self.pp == 1 else None)


@dataclasses.dataclass
class ShardedParams:
    """The model's parameters as one dict per rank (``param_shapes``' keys,
    each tensor that rank's shard; a rank of a later stage holds only its
    layers)."""
    layout: ServeLayout
    shards: list[Params]


def validate_tp(cfg, tp: int, ep: int = 1) -> None:
    """TP must divide every sharded dim (kv heads bound the paged-KV shard);
    EP must divide the expert count."""
    for dim, name in ((cfg.n_kv_heads, "n_kv_heads"), (cfg.n_heads, "n_heads"),
                      (cfg.d_ff, "d_ff"), (cfg.vocab_size, "vocab_size")):
        if dim % tp:
            raise ValueError(f"tp={tp} does not divide {name}={dim}")
    if ep > 1:
        if not cfg.n_experts:
            raise ValueError("ep>1 requires an MoE config (n_experts > 0)")
        if cfg.n_experts % ep:
            raise ValueError(f"ep={ep} does not divide n_experts={cfg.n_experts}")


def validate_dist(tp: int, ep: int, pp: int, procs: int) -> None:
    """The process layouts a multi-process engine serves: the ranks split
    evenly over the processes, a process holding whole stages under pp
    (the JAX ring hops between hosts once per turn) and whole tp ranks with
    all their ep ranks without it. The JAX engine also serves a remainder of
    global devices as ``dp`` replicas; the port does not."""
    n = pp * tp * ep
    if pp > 1 and pp % procs:
        raise ValueError(f"multi-host pp needs whole stages per process: "
                         f"pp={pp} does not divide over {procs} processes")
    if pp == 1 and tp % procs:
        raise ValueError(f"multi-host serving without pp needs whole tp ranks "
                         f"per process: tp={tp} does not divide over {procs} "
                         f"processes (dp replicas are not served)")
    if n % procs:
        raise ValueError(f"pp*tp*ep={n} ranks do not divide over {procs} processes")


def make_serve_layout(devices=None, tp: int = 1, ep: int = 1,
                      pp: int = 1, comm: Comm | None = None) -> ServeLayout:
    """The layout of ``pp * tp * ep`` ranks on ``devices`` (rank order). By
    default the first ``pp * tp * ep`` CUDA devices; an explicit list must
    have one entry per rank and may repeat a device. With ``comm`` (a
    process group of ``P`` processes) ``devices`` names this process's
    ``pp * tp * ep / P`` ranks only (the default: the first that many CUDA
    devices), and the JAX check of multi-host pp applies: ``pp * tp * ep``
    equals the group's devices."""
    if tp < 1 or ep < 1 or pp < 1:
        raise ValueError(f"tp={tp}, ep={ep} and pp={pp} must be >= 1")
    procs = comm.size if comm is not None else 1
    if procs > 1:
        validate_dist(tp, ep, pp, procs)
    n = pp * tp * ep // procs
    what = f"tp*ep={tp}*{ep}" if pp == 1 else f"pp*tp*ep={pp}*{tp}*{ep}"
    if devices is None:
        devices = cuda_devices(n, f"{what} needs {n} CUDA devices in each of "
                                  f"{procs} process(es)")
    devices = list(devices)
    if len(devices) != n:
        if procs > 1:
            raise ValueError(
                f"multi-host {'pp' if pp > 1 else 'tp'} needs pp*tp*ep == global "
                f"devices ({pp * tp * ep} != {len(devices) * procs}): name "
                f"{n} devices in each of {procs} processes")
        raise ValueError(f"{len(devices)} devices given for {what}: "
                         "name one device per rank (a device may repeat)")
    local = [_indexed(resolve_device(d)) for d in devices]
    me = comm.rank if comm is not None else 0
    full = [None] * (n * me) + local + [None] * (n * (procs - me - 1))
    return ServeLayout(tuple(full), tp, ep, pp, comm)


def cuda_devices(n: int | None = None, need: str = "no CUDA device") -> list[str]:
    """The names of the first ``n`` CUDA devices (by default every one);
    raises ``need`` where there are fewer, or none."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < (n or 1):
        raise ValueError(f"{need}, found {have}; pass an explicit device list")
    return [f"cuda:{i}" for i in range(have if n is None else n)]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device's index, the name a tensor's
    ``device`` carries."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def single_layout(params: Params) -> ServeLayout:
    return ServeLayout((params["embed"].device,))


def stage_layers(n_layers: int, s: int, pp: int) -> tuple[int, int]:
    """(first layer, layer count) of stage ``s``."""
    n = n_layers // pp
    return s * n, n


def rank_views(name: str, t: torch.Tensor, cfg, layout: ServeLayout
               ) -> list[torch.Tensor | None]:
    """Parameter ``name``'s shard of ``t`` for every rank: views, no copy;
    None for a rank that does not hold it (the embedding, the final norm
    and the head on a later stage) and for another process's rank."""
    split = param_splits(cfg)[name]
    views: list[torch.Tensor | None] = [None] * len(layout.devices)
    for r, tr, er in layout.ranks():
        s = layout.stage_of(r)
        if name.startswith("layers."):
            views[r] = split_tensor(t.narrow(0, *stage_layers(t.shape[0], s, layout.pp)),
                                    split, tr, layout.tp, er, layout.ep)
        elif s == 0:
            views[r] = split_tensor(t, split, tr, layout.tp, er, layout.ep)
    return views


def split_to_ranks(name: str, t: torch.Tensor, cfg, layout: ServeLayout,
                   views: bool = False) -> list[torch.Tensor | None]:
    """Parameter ``name``'s shard for every rank, each on its rank's device.
    Where every rank shares one device and this process holds them all (or
    with ``views``), a shard on ``t``'s device is a view of ``t``; otherwise
    each shard owns its memory, so ``t`` can go (a group's process keeps
    only its own share of what it draws or reads)."""
    share = views or (len({d for d in layout.devices if d is not None}) == 1
                      and None not in layout.devices)
    return [s if s is None or share and s.device == dev
            else s.clone() if s.device == dev else s.to(dev)
            for s, dev in zip(rank_views(name, t, cfg, layout), layout.devices)]


def from_rank_lists(flat: dict[str, list[torch.Tensor | None]], layout: ServeLayout
                    ) -> ShardedParams:
    """``ShardedParams`` from flat name -> per-rank tensors (None where a
    rank holds no such tensor)."""
    shards: list[Params] = []
    for r in range(len(layout.devices)):
        p: Params = {"layers": {}}
        for name, parts in flat.items():
            if parts[r] is None:
                continue
            if name.startswith("layers."):
                p["layers"][name[len("layers."):]] = parts[r]
            else:
                p[name] = parts[r]
        shards.append(p)
    return ShardedParams(layout, shards)


def validate_degrees(cfg, tp: int = 1, ep: int = 1, pp: int = 1) -> None:
    """``validate_pp``'s verdicts with stages, else ``validate_tp``'s (the
    JAX engine's choice)."""
    if pp > 1:
        from .pp_serve import validate_pp

        validate_pp(cfg, pp, tp, ep)
    else:
        validate_tp(cfg, tp, ep)


def shard_params(params: Params, cfg, layout: ServeLayout) -> ShardedParams:
    """Split full parameters into ``layout``'s shards, one tensor at a
    time. On a device that already holds the full tensor a shard is a view
    of it: a sharded engine and a single-device one can share weights."""
    validate_degrees(cfg, layout.tp, layout.ep, layout.pp)
    flat = {k: v for k, v in params.items() if k != "layers"}
    flat |= {f"layers.{k}": v for k, v in params["layers"].items()}
    return from_rank_lists({name: split_to_ranks(name, t, cfg, layout, views=True)
                            for name, t in flat.items()}, layout)


def alloc_sharded_pages(cfg, layout: ServeLayout, n_blocks: int,
                        dtype: torch.dtype) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Zeroed K and V pages per (stage, ``tp`` rank), ``[L/pp, N, block,
    Hkv/tp, D]`` on the rank's attention device; index ``s * tp + t``
    (None where another process holds the rank)."""
    shape = (cfg.n_layers // layout.pp, n_blocks, cfg.kv_block_size,
             cfg.n_kv_heads // layout.tp, cfg.head_dim)
    devs = [layout.tp_device(t, s) for s in range(layout.pp) for t in range(layout.tp)]
    k = [None if d is None else torch.zeros(shape, dtype=dtype, device=d) for d in devs]
    v = [None if d is None else torch.zeros(shape, dtype=dtype, device=d) for d in devs]
    return k, v


def reduce_sum(parts: list[torch.Tensor], device: torch.device,
               comm: Comm | None = None) -> torch.Tensor:
    """The sum over ranks of row-parallel partials, added in rank order on
    ``device``; with ``comm``, this process's sum then summed over the group.
    One part is returned as it is."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out if comm is None else comm.all_reduce(out)


def gather_last(parts: list[torch.Tensor], device: torch.device,
                comm: Comm | None = None) -> torch.Tensor:
    """Vocab-sharded values joined along the last axis on ``device``; with
    ``comm``, this process's slices then every process's, in process order."""
    out = (parts[0].to(device) if len(parts) == 1
           else torch.cat([p.to(device) for p in parts], dim=-1))
    return out if comm is None else comm.all_gather_last(out)


def join_kv_heads(parts: list[torch.Tensor]) -> torch.Tensor:
    """Per-``tp``-rank pages ``[..., Hkv/tp, D]`` (host tensors) as the
    single-device layout ``[..., Hkv, D]``: the ``/kv`` wire's."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def split_kv_heads(t: torch.Tensor, tp: int) -> list[torch.Tensor]:
    """The inverse of ``join_kv_heads``."""
    return list(t.chunk(tp, dim=-2)) if tp > 1 else [t]


def join_pages(parts: list[torch.Tensor], tp: int) -> torch.Tensor:
    """Per-(stage, ``tp`` rank) pages (host tensors, index ``s * tp + t``)
    as the single-device layout ``[L, ..., Hkv, D]``: each stage's kv-head
    shards joined in tp order, the stages joined along the layer axis."""
    stages = [join_kv_heads(parts[i:i + tp]) for i in range(0, len(parts), tp)]
    return stages[0] if len(stages) == 1 else torch.cat(stages, dim=0)


def split_pages(t: torch.Tensor, tp: int, pp: int) -> list[torch.Tensor]:
    """The inverse of ``join_pages``."""
    stages = list(t.chunk(pp, dim=0)) if pp > 1 else [t]
    return [part for st in stages for part in split_kv_heads(st, tp)]
