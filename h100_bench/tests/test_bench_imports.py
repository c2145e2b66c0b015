"""No run loads JAX or the JAX package, and the reference loads nothing of
the program under test; the command refuses to run without a card."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

REHEARSAL = """
import json, sys
sys.path.insert(0, {root!r})
from pathlib import Path
from h100_bench import run
from h100_bench.spec import Spec
d = Path({data!r})
res = run.run_cell(Spec(d, d), "tiny-qwen.tinylong", 2**32 + 3, 1.0, False, device="cpu")
print(json.dumps({{"correct": res["correct"], "modules": sorted(sys.modules)}}))
"""


def _top(mods):
    return {m.split(".")[0] for m in mods}


def test_a_rehearsal_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", REHEARSAL.format(root=str(ROOT),
                                                data=str(ROOT / "h100_bench/tests/data"))],
        capture_output=True, text=True, timeout=300, check=True)
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["correct"]
    top = _top(doc["modules"])
    assert "llm_d_inference_scheduler_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "llm_d_inference_scheduler_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import h100_bench.reference.model, json; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    top = _top(json.loads(out.stdout))
    assert not top & {"llm_d_inference_scheduler_tpu_torch", "llm_d_inference_scheduler_tpu",
                      "jax", "jaxlib", "flax"}


def test_the_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "h100_bench/run.py"), "--workload",
                          "mixtral-8x7b-16l.longprompt", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
