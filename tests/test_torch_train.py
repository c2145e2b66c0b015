"""PyTorch port, the training slice: the mesh factoring, the attention hook
and the train step, held against the JAX package on the CPU.

Every rank lies on ``"cpu"``; ``tiny`` and ``tiny-moe`` run in f32 with the
JAX weights carried over (``params_from_numpy``) and numpy-seeded tokens:

- ``mesh_shape`` gives the JAX factors and errors over n = 1..16 and every
  tp/sp/ep choice;
- ``forward`` with the default hook is bit-equal to ``forward`` through
  any hook that calls ``causal_attention``, on one rank and on tp=2 shards;
- one step's loss and gradients against ``jax.value_and_grad`` of the same
  loss through the JAX ``llama.forward`` (rtol 1e-4, atol 1e-6), dense and
  MoE; three steps' losses against the JAX ``make_train_step`` on a
  one-device mesh (rtol 1e-4) and the parameters after step 1 (atol
  1e-5);
- tp=2, dp=2, sp=2 (ring attention), tp=2 x sp=2 and, for the MoE model,
  ep=2 and tp=2 x ep=2 steps in one process against the tp=1 step;
- the refusals: the grouped MoE FFN, a multi-process (``Comm``) layout, a
  pipeline layout, a batch that dp does not divide and a sequence that sp
  does not divide.

AdamW's first update is ``lr * g / (|g| + eps)``, so where a gradient lies
within the gradients' own tolerance of zero its sign (and so the update,
anywhere in ``[-lr, lr]``) follows the summation order. The parameters
after a step are held at 1e-5 everywhere else, and within ``2 * lr`` at
those few elements.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_inference_scheduler_tpu.models import configs as jax_configs
from llm_d_inference_scheduler_tpu.models import llama as jax_llama
from llm_d_inference_scheduler_tpu.parallel import mesh as jax_mesh
from llm_d_inference_scheduler_tpu.parallel import train as jax_train
from llm_d_inference_scheduler_tpu_torch.models import configs, llama
from llm_d_inference_scheduler_tpu_torch.models.convert_jax import params_from_numpy
from llm_d_inference_scheduler_tpu_torch.ops.attention import causal_attention
from llm_d_inference_scheduler_tpu_torch.parallel import mesh, train
from llm_d_inference_scheduler_tpu_torch.parallel import serve as par
from llm_d_inference_scheduler_tpu_torch.parallel.shardings import param_splits

LR = 1e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and the
    suite's workers share the machine's cores with timing-bound tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(name):
    """(JAX config, port config) of ``name`` in f32."""
    return (dataclasses.replace(jax_configs.get_config(name), dtype="float32"),
            dataclasses.replace(configs.get_config(name), dtype="float32"))


def flat(tree) -> dict[str, np.ndarray]:
    """A JAX parameter pytree under the port's flat names, as numpy."""
    out = {k: np.asarray(v) for k, v in tree.items() if k != "layers"}
    return out | {f"layers.{k}": np.asarray(v) for k, v in tree["layers"].items()}


def tokens(cfg, seed=0, shape=(B, S)) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, shape).astype(np.int32)


def assert_params_after_step(got: dict, want: dict, grad: dict):
    """``got`` within 1e-5 of ``want`` wherever |grad| exceeds the gradient
    tolerance's floor, and within 2 * lr where it does not."""
    for name, w in want.items():
        g = np.asarray(grad[name])
        diff = np.abs(np.asarray(got[name]) - w)
        sure = np.abs(g) > GRAD_TOL["atol"]
        assert (diff[sure] <= 1e-5).all(), (name, diff[sure].max())
        assert (diff <= 2 * LR).all(), (name, diff.max())


def port_state(tcfg, jparams, devices=("cpu",), **axes):
    layout = mesh.make_train_layout(list(devices), **axes)
    state = train.make_train_state(tcfg, layout, lr=LR,
                                   params=params_from_numpy(jparams, "cpu"))
    return layout, state, train.make_train_step(tcfg, layout)


@pytest.fixture(scope="module")
def reference():
    """``reference(name)``: one JAX value_and_grad of the train loss on
    fresh weights of ``name`` (computed once per module), and the port's
    tp=1 step on the same weights: its loss, gradients and the parameters
    after it."""
    cache: dict[str, dict] = {}

    def get(name: str) -> dict:
        if name not in cache:
            cache[name] = _reference(name)
        return cache[name]

    return get


def _reference(name: str) -> dict:
    jcfg, tcfg = f32(name)
    toks = tokens(jcfg)
    one = jax_mesh.make_mesh(jax.devices()[:1], tp=1, sp=1)
    params, opt_state, tx, _ = jax_train.make_train_state(jcfg, one, seed=0, lr=LR)

    def loss_fn(p, t):
        logits, _ = jax_llama.forward(p, jcfg, t)
        lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        return jnp.mean(-jnp.take_along_axis(lp, t[:, 1:, None], axis=-1)[..., 0])

    loss, grads = jax.value_and_grad(loss_fn)(params, jnp.asarray(toks))
    p0 = jax.tree.map(np.asarray, params)
    _, state, step = port_state(tcfg, p0)
    port_loss = float(step(state, torch.from_numpy(toks)))
    return dict(
        jcfg=jcfg, tcfg=tcfg, toks=toks, p0=p0, opt_state=opt_state, tx=tx, mesh=one,
        loss=float(loss), grads=flat(grads), port_loss=port_loss,
        port_grads={k: v.numpy() for k, v in train.full_grads(tcfg, state).items()},
        port_params={k: v.numpy() for k, v in train.full_params(tcfg, state).items()})


# ---- the mesh ----------------------------------------------------------------


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shape_matches_jax(n):
    choices = (None, 1, 2, 3, 4)
    for tp in choices:
        for sp in choices:
            for ep in choices:
                assert (_outcome(mesh.mesh_shape, n, tp=tp, sp=sp, ep=ep)
                        == _outcome(jax_mesh.mesh_shape, n, tp=tp, sp=sp, ep=ep)), (n, tp, sp, ep)


def test_train_layout_orders_ranks_as_the_jax_mesh():
    layout = mesh.make_train_layout(["cpu"] * 8)
    assert layout.shape == dict(zip(mesh.AXES, jax_mesh.mesh_shape(8)))
    assert mesh.AXES == jax_mesh.AXES
    assert layout.replica(1).devices == (torch.device("cpu"),) * 2
    assert len(layout.ring_devices(0)[torch.device("cpu")]) == layout.sp
    with pytest.raises(ValueError, match="cannot factor"):
        mesh.make_train_layout(["cpu"] * 6, tp=4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs a CUDA device, found 0"):
            mesh.make_train_layout()


# ---- the attention hook ------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2])
def test_default_hook_is_bit_equal(tp):
    tcfg = f32("tiny")[1]
    params = llama.init_params(tcfg, "cpu", generator=torch.Generator().manual_seed(1))
    if tp > 1:
        params = par.shard_params(params, tcfg, par.make_serve_layout(["cpu"] * tp, tp=tp))
    toks = torch.from_numpy(tokens(tcfg, seed=1))
    calls = []

    def hook(q, k, v, **kw):
        calls.append(q.shape[2])
        return causal_attention(q, k, v, **kw)

    plain, _ = llama.forward(params, tcfg, toks)
    hooked, _ = llama.forward(params, tcfg, toks, attention_fn=hook)
    assert torch.equal(plain, hooked)
    # Once per layer and tp rank, on that rank's heads.
    assert calls == [tcfg.n_heads // tp] * (tcfg.n_layers * tp)


# ---- the step against JAX ----------------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_one_step_loss_and_grads_match_jax_value_and_grad(reference, name):
    ref = reference(name)
    np.testing.assert_allclose(ref["port_loss"], ref["loss"], rtol=1e-4)
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(ref["port_grads"][k], want, err_msg=k, **GRAD_TOL)


def test_three_steps_match_jax_make_train_step(reference):
    ref = reference("tiny")
    params = jax.tree.map(jnp.asarray, ref["p0"])
    opt_state, toks = ref["opt_state"], jnp.asarray(ref["toks"])
    jax_step = jax_train.make_train_step(ref["jcfg"], ref["mesh"], ref["tx"])
    want, p1 = [], None
    for i in range(3):
        params, opt_state, loss = jax_step(params, opt_state, toks)
        want.append(float(loss))
        if i == 0:
            p1 = flat(params)
    tcfg = ref["tcfg"]
    _, state, step = port_state(tcfg, ref["p0"])
    got = []
    for i in range(3):
        got.append(float(step(state, torch.from_numpy(ref["toks"]))))
        if i == 0:
            assert_params_after_step(
                {k: v.numpy() for k, v in train.full_params(tcfg, state).items()},
                p1, ref["grads"])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]


# (model, devices, axes) of each parallel step held against tp=1.
LAYOUTS = {
    "tp2": ("tiny", 2, dict(tp=2, sp=1)), "dp2": ("tiny", 2, dict(tp=1, sp=1)),
    "sp2": ("tiny", 2, dict(tp=1, sp=2)), "tp2-sp2": ("tiny", 4, dict(tp=2, sp=2)),
    "dp2-sp2": ("tiny", 4, dict(tp=1, sp=2)),
    "moe-tp2": ("tiny-moe", 2, dict(tp=2, sp=1)),
    "moe-ep2": ("tiny-moe", 2, dict(tp=1, sp=1, ep=2)),
    "moe-tp2-ep2": ("tiny-moe", 4, dict(tp=2, sp=1, ep=2)),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_parallel_step_matches_tp1(reference, case):
    name, n, axes = LAYOUTS[case]
    ref = reference(name)
    tcfg = ref["tcfg"]
    layout, state, step = port_state(tcfg, ref["p0"], ["cpu"] * n, **axes)
    assert layout.shape == {"dp": n // (axes["tp"] * axes["sp"] * axes.get("ep", 1)),
                            "sp": axes["sp"], "tp": axes["tp"], "ep": axes.get("ep", 1)}
    loss = float(step(state, torch.from_numpy(ref["toks"])))
    np.testing.assert_allclose(loss, ref["port_loss"], rtol=1e-5)
    grads = train.full_grads(tcfg, state)
    for k, want in ref["port_grads"].items():
        np.testing.assert_allclose(grads[k].numpy(), want, err_msg=k, **GRAD_TOL)
    assert_params_after_step({k: v.numpy() for k, v in train.full_params(tcfg, state).items()},
                             ref["port_params"], ref["port_grads"])
    # One leaf, and one AdamW state, per shard whatever dp: a replicated
    # weight is one tensor, a tp/ep-split one has one per shard.
    want = {name: (layout.tp if split.tp is not None else 1)
            * (layout.ep if split.ep is not None else 1)
            for name, split in param_splits(tcfg).items()}
    assert {name: len(mine) for name, mine in state.leaves.items()} == want
    assert len(state.optimizer.param_groups[0]["params"]) == sum(want.values())


def test_moe_trains_with_the_dense_ffn():
    _, tcfg = f32("tiny-moe")
    layout = mesh.make_train_layout(["cpu"])
    state = train.make_train_state(tcfg, layout, seed=3)
    step = train.make_train_step(tcfg, layout)
    toks = torch.from_numpy(tokens(tcfg, seed=3))
    losses = [float(step(state, toks)) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0], losses
    assert train.full_grads(tcfg, state)["layers.router"].abs().sum() > 0


# ---- refusals ----------------------------------------------------------------


def test_refusals():
    _, tcfg = f32("tiny")
    one = mesh.make_train_layout(["cpu"])
    grouped = dataclasses.replace(f32("tiny-moe")[1], moe_impl="grouped")
    with pytest.raises(ValueError, match="no backward"):
        train.make_train_state(grouped, one)
    with pytest.raises(ValueError, match="no backward"):
        train.make_train_step(grouped, one)
    group = par.ServeLayout((torch.device("cpu"), None),
                            tp=2, comm=par.Comm(None, rank=0, size=2, backend="gloo"))
    with pytest.raises(ValueError, match="carry no autograd"):
        train.make_train_step(tcfg, group)
    with pytest.raises(ValueError, match="pipeline"):
        train.make_train_state(tcfg, par.make_serve_layout(["cpu"] * 2, pp=2))
    # A one-process serving layout trains as one replica.
    assert train.train_layout(par.make_serve_layout(["cpu"] * 2, tp=2)).shape == {
        "dp": 1, "sp": 1, "tp": 2, "ep": 1}
    dp2 = mesh.make_train_layout(["cpu"] * 2, tp=1, sp=1)
    state = train.make_train_state(tcfg, dp2)
    with pytest.raises(ValueError, match="does not divide over dp=2"):
        train.make_train_step(tcfg, dp2)(state, torch.ones((3, S), dtype=torch.int32))
    sp2 = mesh.make_train_layout(["cpu"] * 2, tp=1, sp=2)
    with pytest.raises(ValueError, match="does not divide over sp=2"):
        train.make_train_step(tcfg, sp2)(train.make_train_state(tcfg, sp2),
                                         torch.ones((2, 15), dtype=torch.int32))
