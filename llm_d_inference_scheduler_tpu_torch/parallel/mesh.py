"""The training layout: ``dp x sp x tp x ep`` ranks on devices.

Port of ``llm_d_inference_scheduler_tpu/parallel/mesh.py``. The axes are
the JAX mesh's:

- ``dp``: data parallel, the batch; each replica takes ``B/dp`` rows and
  the gradients are averaged over the replicas.
- ``sp``: sequence parallel; ring attention (``ring_attention.py``) cuts
  the sequence into ``sp`` chunks, one per sp rank, and passes the K/V
  chunks round the ring.
- ``tp``: tensor parallel, the head and hidden axes of the weights
  (``shardings.py``).
- ``ep``: expert parallel, the experts axis of the MoE FFN weights.

One process drives every rank, as the JAX single controller does. Rank
``r = ((d * sp + s) * tp + t) * ep + e`` (the order the JAX mesh reshapes
its device list in), and a device list may name one device more than once:
the CPU tests lay every rank on ``"cpu"``, and one card holds four ranks.

A replica's parameters live on its tp x ep ranks at sp rank 0, as a
``ServeLayout`` and ``ShardedParams`` (``replica``); its token-wise compute
(projections, norms, FFN, head) runs there on the whole sequence, and only
attention spreads over the sp ranks: each tp rank's ring runs on the
devices of that tp rank's sp ranks (``ring_devices``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import resolve_device
from .serve import ServeLayout, _indexed, cuda_devices

AXES = ("dp", "sp", "tp", "ep")


def mesh_shape(n_devices: int, tp: int | None = None, sp: int | None = None,
               ep: int | None = None) -> tuple[int, int, int, int]:
    """Factor n_devices into (dp, sp, tp, ep); powers of two get the model
    axes first, the remainder lands on dp (the JAX ``mesh_shape``)."""
    if ep is None:
        ep = 1
    if n_devices % ep:
        raise ValueError(f"{n_devices} devices not divisible by ep={ep}")
    rem = n_devices // ep
    if tp is None:
        tp = 2 if rem % 2 == 0 else 1
    rem //= tp
    if sp is None:
        sp = 2 if rem % 2 == 0 else 1
    dp = rem // sp
    if dp * sp * tp * ep != n_devices:
        raise ValueError(f"cannot factor {n_devices} into "
                         f"(dp,sp,tp,ep)=({dp},{sp},{tp},{ep})")
    return dp, sp, tp, ep


@dataclasses.dataclass(frozen=True)
class TrainLayout:
    # rank r = ((d * sp + s) * tp + t) * ep + e
    devices: tuple[torch.device, ...]
    dp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as the JAX ``mesh.shape``."""
        return dict(zip(AXES, (self.dp, self.sp, self.tp, self.ep)))

    def device(self, d: int, s: int, t: int, e: int = 0) -> torch.device:
        return self.devices[((d * self.sp + s) * self.tp + t) * self.ep + e]

    def replica(self, d: int) -> ServeLayout:
        """Replica ``d``'s tp x ep ranks at sp rank 0: where its parameter
        shards live and its token-wise compute runs."""
        return ServeLayout(tuple(self.device(d, 0, t, e) for t in range(self.tp)
                                 for e in range(self.ep)), self.tp, self.ep)

    def ring_devices(self, d: int) -> dict[torch.device, list[torch.device]]:
        """Replica ``d``'s attention device of each tp rank -> the devices of
        that tp rank's sp ranks, in ring order. The attention hook sees a tp
        rank's heads on its device and finds its ring by it, so two tp ranks
        that share a device must share their sp ranks' devices too."""
        rings: dict[torch.device, list[torch.device]] = {}
        for t in range(self.tp):
            ring = [self.device(d, s, t) for s in range(self.sp)]
            if rings.setdefault(ring[0], ring) != ring:
                raise ValueError(f"tp ranks on {ring[0]} have different sp "
                                 f"devices ({rings[ring[0]]} and {ring})")
        return rings


def make_train_layout(devices=None, tp: int | None = None, sp: int | None = None,
                      ep: int | None = None) -> TrainLayout:
    """The counterpart of the JAX ``make_mesh``: ``devices`` (by default
    every CUDA device) factored by ``mesh_shape`` into ``dp x sp x tp x
    ep`` ranks in rank order. A device may repeat."""
    if devices is None:
        devices = cuda_devices(need="a train layout needs a CUDA device")
    devs = tuple(_indexed(resolve_device(d)) for d in devices)
    dp, sp_, tp_, ep_ = mesh_shape(len(devs), tp=tp, sp=sp, ep=ep)
    return TrainLayout(devs, dp, sp_, tp_, ep_)
