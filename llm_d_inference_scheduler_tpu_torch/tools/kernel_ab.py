"""A/B of the port's CUDA kernels against another checkout's, on one card.

    git archive <rev> | tar -x -C build/parent
    python3 -m llm_d_inference_scheduler_tpu_torch.tools.kernel_ab --parent build/parent

Loads the other checkout's port package under an alias (its kernels build in
its own ``build/torch_kernels``) and times both versions' wrappers on the
same inputs, in the order parent, change, change, parent, by profiler device
time (the sum of the kernels one call launches):

- K1 (paged decode attention) at ``chip_smoke.py``'s serve shape, bf16,
  with the split of its time between kernels;
- K2 (grouped-expert FFN) at Mixtral width, T = 4, 8 and 1100, bf16, each
  version on the rows its own routing glue lays out (its own row tile);
- a Mixtral prefill (16 of 32 layers, random bf16 weights, 1100 tokens,
  grouped MoE) through each version's ``llama.forward``: the prefill's
  device time and K2's share of it.

Prints one line per measurement, the card's name and power limit first.
Needs a GPU; exits 2 without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

from .timing import kernel_times

# chip_smoke.py's serve-phase decode batch: the four prompts' lengths
# midway through their 32 generated tokens.
SERVE_SEQ_LENS = (1046, 1085, 82, 80)
MOE_LAYERS = 16


def load_alias(root: Path, alias: str = "parent_port"):
    """The port package of checkout ``root``, imported as ``alias``."""
    pkg = root / "llm_d_inference_scheduler_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def ab(label: str, fns: dict, iters: int = 20, match: str = "") -> None:
    """Times fns["parent"] and fns["change"] in the order parent, change,
    change, parent; prints each call's device ms (kernels whose name holds
    ``match``, or all) and the per-kernel split of the first timing."""
    out = {k: [] for k in fns}
    split = {}
    for who in ("parent", "change", "change", "parent"):
        kt = kernel_times(fns[who], iters)
        out[who].append(sum(ms for n, ms in kt.items() if match in n))
        split.setdefault(who, kt)
    print(f"[ab] {label}: parent {out['parent'][0]:.4f}/{out['parent'][1]:.4f} ms, "
          f"change {out['change'][0]:.4f}/{out['change'][1]:.4f} ms "
          f"(order parent, change, change, parent; device time)", flush=True)
    for who, kt in split.items():
        for n, ms in sorted(kt.items(), key=lambda kv: -kv[1])[:6]:
            print(f"[ab]   {who} {ms * 1e3:10.2f} us  {n[:90]}", flush=True)


def attention_case(gen, seq_lens, layers: int = 8, B_max_blocks: int = 128):
    B, H, Hkv, D, block = len(seq_lens), 32, 8, 128, 16
    N = 1 + B * B_max_blocks
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    tables = (torch.randperm(N - 1, generator=gen, device="cuda")[: B * B_max_blocks] + 1)
    tables = tables.to(torch.int32).reshape(B, B_max_blocks).contiguous()
    return (r(B, H, D), r(layers, N, block, Hkv, D), r(layers, N, block, Hkv, D), tables,
            torch.tensor(seq_lens, dtype=torch.int32, device="cuda"), r(B, Hkv, D),
            r(B, Hkv, D))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the other checkout (holds llm_d_inference_scheduler_tpu_torch/)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from llm_d_inference_scheduler_tpu_torch.models import configs, llama
    from llm_d_inference_scheduler_tpu_torch.ops import grouped_moe, moe, paged_attention

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    parent = load_alias(args.parent.resolve())
    p_pa = importlib.import_module(parent.__name__ + ".ops.paged_attention")
    p_gm = importlib.import_module(parent.__name__ + ".ops.grouped_moe")
    p_moe = importlib.import_module(parent.__name__ + ".ops.moe")
    p_llama = importlib.import_module(parent.__name__ + ".models.llama")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(99)

    with torch.no_grad():
        # K1 at the serve shape, pages of 8 layers rotating (cold in L2).
        c = attention_case(gen, SERVE_SEQ_LENS)
        it = {"i": 0}

        def k1_args():
            it["i"] = (it["i"] + 1) % c[1].shape[0]
            i = it["i"]
            return (c[0], c[1][i], c[2][i], c[3], c[4], c[5], c[6])

        a1 = k1_args()
        diff = (p_pa.paged_decode_attention_cuda(*a1).float()
                - paged_attention.paged_decode_attention_cuda(*a1).float())
        print(f"[ab] K1 max |parent - change| {float(diff.abs().max()):.3e}", flush=True)
        ab(f"K1 paged_decode_attention bf16 seq_lens={list(SERVE_SEQ_LENS)}",
           {"parent": lambda: p_pa.paged_decode_attention_cuda(*k1_args()),
            "change": lambda: paged_attention.paged_decode_attention_cuda(*k1_args())})
        del c

        # K2 at Mixtral width.
        cfg = dataclasses.replace(configs.get_config("mixtral-8x7b"), n_layers=MOE_LAYERS)
        D, F, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.experts_per_token
        w = lambda *s, fan: (torch.randn(*s, generator=gen, device="cuda",
                                         dtype=torch.bfloat16) * fan ** -0.5)
        lp = {"router": w(D, E, fan=D), "w1": w(E, D, F, fan=D), "w3": w(E, D, F, fan=D),
              "w2": w(E, F, D, fan=F)}
        for T in (4, 8, 1100):
            x = torch.randn(T, D, generator=gen, device="cuda").to(torch.bfloat16)
            # Each version's glue lays the rows out with its own row tile.
            call = {}
            for who, m, gm in (("parent", p_moe, p_gm), ("change", moe, grouped_moe)):
                g = m.group_rows(lp, x, E, k)
                a = (g.x_pad, g.tile_expert, lp["w1"], lp["w3"], lp["w2"], g.tm, g.rows_used)
                call[who] = (g.tm, lambda gm=gm, a=a: gm.grouped_ffn_cuda(*a))
            diff = (p_moe.moe_ffn_grouped(lp, x, E, k).float()
                    - moe.moe_ffn_grouped(lp, x, E, k).float())
            print(f"[ab] K2 T={T} ({T * k} routed rows; tm parent {call['parent'][0]}, "
                  f"change {call['change'][0]}): max |parent - change| of the MoE "
                  f"output {float(diff.abs().max()):.3e}", flush=True)
            ab(f"K2 grouped_moe_ffn bf16 T={T}", {who: fn for who, (_, fn) in call.items()},
               iters=10)
        del lp, x, call

        # The Mixtral prefill through each version's own model code.
        params = llama.init_params(cfg, "cuda", "bfloat16",
                                   torch.Generator(device="cuda").manual_seed(0))
        gcfg = dataclasses.replace(cfg, moe_impl="grouped")
        tokens = torch.randint(0, cfg.vocab_size, (1, 1100), generator=gen, device="cuda")
        forward = {"parent": p_llama.forward, "change": llama.forward}
        for who in ("parent", "change", "change", "parent"):
            kt = kernel_times(lambda: forward[who](params, gcfg, tokens), iters=3, warmup=1)
            total = sum(kt.values())
            k2 = sum(ms for n, ms in kt.items() if "grouped_" in n)
            print(f"[ab] Mixtral ({MOE_LAYERS} layers) prefill of 1100 tokens, {who}'s "
                  f"model code: device {total:.2f} ms, of it K2 {k2:.2f} ms "
                  f"({MOE_LAYERS} calls)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
