"""Engine configuration (the subset of
``llm_d_inference_scheduler_tpu/engine/config.py`` that the port serves,
plus the torch devices and dtype)."""

from __future__ import annotations

import dataclasses

from ..models.configs import ModelConfig, get_config


@dataclasses.dataclass
class EngineConfig:
    model: str = "tiny"           # registry name or a dir with model_config.json
    served_model_name: str | None = None
    # The id /health, /debug/kv, /debug/traces, every KV-event document and
    # the P/D exporter's remote_engine_id report; empty = a random
    # "torch-<8 hex>" ("sim-<8 hex>" for the sim) minted at start. A
    # --dist-* group's processes build from one config, so they share it.
    engine_id: str = ""
    # "torch" (TorchEngine) | "sim" (engine/sim.py: the CPU simulator with
    # scripted latencies, which runs no model). The JAX package's "tpu"
    # engine has no counterpart here.
    backend: str = "torch"
    # Sim backend knobs (the JAX config's, same defaults): prefill and
    # decode cost per token, and the priced P/D KV import per block pulled
    # from the prefill peer's staged export, flat or per peer
    # ("host:port" of the prefill engine -> ms per block).
    sim_prefill_ms_per_token: float = 0.02
    sim_decode_ms_per_token: float = 2.0
    sim_kv_pull_ms_per_block: float = 0.2
    sim_kv_pull_ms_per_peer: dict[str, float] = dataclasses.field(
        default_factory=dict)
    # A converted directory (models/convert_hf.py) whose model.safetensors
    # the engine loads; empty = the model directory's own weights when
    # ``model`` is one, else random weights drawn from ``seed``.
    checkpoint_path: str = ""
    # "byte", or an HF fast tokenizer: "hf:<dir>", a directory or a
    # tokenizer.json path (needs the ``tokenizers`` package).
    tokenizer: str = "byte"
    max_batch: int = 8            # decode batch slots
    max_model_len: int = 2048
    hbm_kv_blocks: int = 0        # 0 = derive from max_batch * max_model_len
    seed: int = 0
    # P/D role the engine reports on /health ("both" | "prefill" | "decode"
    # | "encode"); any role serves every route, as the JAX engine does.
    role: str = "both"
    port: int = 8200
    host: str = "127.0.0.1"
    enable_prefix_caching: bool = True
    # Decode steps fused per engine dispatch: K decode+sample steps run back
    # to back on the device with ONE host readback of the [K, B] tokens.
    decode_chunk: int = 8
    # Grouped MoE FFN (kernel K2, ops/grouped_moe.py) for n_experts > 0
    # models: the counterpart of the JAX engine's ``pallas_moe``. Off by
    # default, as there: the dense-over-experts FFN serves.
    grouped_moe: bool = False
    # Batched prefill: up to this many same-bucket plain prompts admitted
    # together prefill in one [N, S] forward (S = the group's longest
    # prompt; no padding rows). Prompts with a prefix-cache hit, multimodal
    # embeddings, a cache probe, a remote-decode export or a prompt longer
    # than the prefill_chunk window take the single path. 1 = off.
    prefill_batch: int = 1
    # Incremental prefill: when > 0, a prompt whose un-cached suffix exceeds
    # this many tokens prefills in windows of this size (rounded up to a KV
    # block multiple), one window per engine step between decode chunks.
    # 0 = whole-prompt prefill.
    prefill_chunk: int = 0
    # KV-cache event stream (engine/kv_events.py) feeding the router's
    # precise prefix scorer: SSE on /kv_events, and ZMQ PUB on this port
    # where pyzmq is installed. 0 disables events; -1 = serving port + 1000.
    kv_events_port: int = -1
    # Before admitting anything, build the CUDA kernels of the model's paths
    # and run a trial prefill and decode at every batch bucket (and, with
    # role "encode", the vision tower); /health answers 503 "warming" until
    # then. A warm-up failure stops the engine.
    warmup: bool = False
    # Tensor parallelism: shard params (Megatron TP) and KV pages (kv-head
    # axis) over tp_size ranks (parallel/serve.py). 1 = one device.
    tp_size: int = 1
    # Expert parallelism (MoE models): the experts axis over ep_size ranks;
    # composes with tp_size (tp_size * ep_size ranks in all).
    ep_size: int = 1
    # Pipeline parallelism (parallel/pp_serve.py): the layer stack and its
    # KV pages over pp_size stages, each split over tp_size * ep_size ranks
    # as above; every path runs the stages in turn. Composes with tp_size
    # and ep_size (pp_size * tp_size * ep_size ranks in all).
    pp_size: int = 1
    # Multi-process serving (engine/multihost.py): when dist_coordinator is
    # set ("host:port" of the group's rendezvous store, hosted by process 0),
    # dist_num_processes engine processes serve as ONE engine, the
    # pp_size * tp_size * ep_size ranks split over them in process-major
    # order (devices names each process's own). Process 0 serves HTTP; the
    # others replay its device ops from the instruction channel on
    # dist_instr_port.
    dist_coordinator: str = ""
    dist_num_processes: int = 1
    dist_process_id: int = 0
    dist_instr_port: int = 8790
    dist_instr_host: str = ""     # leader bind / follower dial; default host
    # Follower liveness deadline: no instruction or ping within this window
    # -> LeaderLost (the follower exits for a group restart).
    dist_recv_timeout_s: float = 30.0
    # Wire for a multi-process group's sharded P/D KV handoff: "device" = the
    # CUDA IPC device wire (engine/kv_transfer.py), "host" = per-process TCP
    # shard servers (engine/shard_wire.py), "auto" = device on the card,
    # host on the CPU.
    kv_wire: str = "auto"
    # P/D KV handoff data path: "device" = the device wire (a device-to-device
    # copy from the exporter's staged pages; raises if it cannot start),
    # "host" = host-staged bytes over HTTP /kv only, "auto" = the device wire
    # on the card, host on the CPU. The HTTP path stays as the fallback of a
    # single-process engine.
    kv_transfer: str = "auto"
    device: str = "cuda"          # "cpu" only when asked (tests)
    # The device of each of the pp_size * tp_size * ep_size ranks,
    # comma-separated in rank order (a device may repeat: two ranks can
    # share one card). Empty = the first pp_size * tp_size * ep_size CUDA
    # devices, or the CPU for every rank when ``device`` is "cpu".
    devices: str = ""
    dtype: str | None = None      # None = the passed params' or the model config's
    # TLS for the engine's HTTP surface: cert dir with tls.crt/tls.key, or a
    # self-signed certificate (needs the ``cryptography`` package) when
    # secure_serving is on without a path (utils/tls.py); with reload, a
    # rotated pair is served to new connections.
    secure_serving: bool = False
    cert_path: str = ""
    enable_cert_reload: bool = False
    # TLS verification on the engine's own client legs (the /ec pulls, the
    # /kv pull and its release): skip-verify by default (pod-local certs),
    # or against a CA bundle, which takes precedence.
    client_insecure_skip_verify: bool = True
    client_ca_cert_path: str = ""
    # Deterministic fault injection on the generate routes (utils/faults.py):
    # comma-separated "kind:pct[:arg]", decided by a stable hash of
    # (chaos_seed, kind, request id); empty = the ENGINE_CHAOS environment
    # variable (same grammar).
    chaos: str = ""
    chaos_seed: int = 0

    @property
    def dist(self) -> bool:
        return bool(self.dist_coordinator) and self.dist_num_processes > 1

    def rank_devices(self) -> list[str] | None:
        """The device of each of this process's pp * tp * ep ranks (all of
        them, or its share in a multi-process group): ``devices`` when
        given, the CPU for every rank when ``device`` is "cpu", else None
        (the first CUDA devices, ``parallel.serve.make_serve_layout``'s
        default)."""
        if self.devices:
            return [d.strip() for d in self.devices.split(",")]
        if self.device.split(":")[0] == "cpu":
            n = self.pp_size * self.tp_size * self.ep_size
            return [self.device] * (n // self.dist_num_processes if self.dist else n)
        return None

    def resolved_kv_events_port(self) -> int:
        return self.port + 1000 if self.kv_events_port == -1 else self.kv_events_port

    @property
    def model_config(self) -> ModelConfig:
        return get_config(self.model)

    @property
    def model_name(self) -> str:
        return self.served_model_name or self.model

    def num_kv_blocks(self) -> int:
        if self.hbm_kv_blocks:
            return self.hbm_kv_blocks
        block = self.model_config.kv_block_size
        per_seq = -(-self.max_model_len // block)
        return 1 + self.max_batch * per_seq  # +1 for the trash block
