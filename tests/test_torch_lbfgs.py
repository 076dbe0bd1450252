"""Port parity: ``optimizer.LBFGS`` against the JAX package's on the CPU.

The reference's own cases (tests/test_optimizer.py::TestLBFGS: a convex
quadratic with a closure and the strong-Wolfe line search, and steps
without a closure), the same quadratic without a line search, a
least-squares problem over two parameters with a short history (two
iterations a step: near the optimum the secant pairs are differences of
f32 rounding, and the two frameworks, summing the products in another
order, then part by 1e-4), and three steps of a ``llama_tiny`` f32
closure with the line search.
Held: every iterate within 1e-6 relative (both run the same f32
operations on the flattened parameters; only the order of a few sums
differs), the (s, y) history lengths and the evaluation counts (closure
calls) equal, and the returned losses within 1e-6 relative. The model
case: the first step's loss within 1e-6, the later ones within 2e-4 and
every parameter within 1e-4 absolute after three steps of lr 1: each
quasi-Newton direction scales the two frameworks' gradient noise (a
forward and backward summed in another order, 1e-6 relative) by the
inverse curvature, which for weights of size 1e-2 is large.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JaxCrit
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu_torch.models.convert import (
    export_paddle_tpu_state, load_paddle_tpu_state,
)
from paddle_tpu_torch.models.llama import (
    LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
)
from paddle_tpu_torch.optimizer import LBFGS


def _counted(fn):
    def run():
        run.calls += 1
        return fn()
    run.calls = 0
    return run


def _pair(arrays, **kw):
    """The reference's and the port's LBFGS over the same f32 arrays."""
    jx = [paddle.to_tensor(a.copy(), stop_gradient=False) for a in arrays]
    tx = [torch.tensor(a.copy(), requires_grad=True) for a in arrays]
    return (jx, jopt.LBFGS(parameters=jx, **kw), tx,
            LBFGS(parameters=tx, **kw))


def _same_state(jo, to, jx, tx, rel=1e-6):
    assert len(to._s_hist) == len(jo._s_hist)
    for j, t in zip(jx, tx):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j.numpy()),
                                   rtol=rel, atol=rel)


@pytest.mark.parametrize("line_search", ["strong_wolfe", None])
def test_quadratic_with_closure_matches_reference(line_search):
    target = np.array([1.5, -2.0, 0.7], np.float32)
    jx, jo, tx, to = _pair([np.zeros(3, np.float32)], learning_rate=0.5,
                           max_iter=10, line_search_fn=line_search)

    def jclosure():
        d = jx[0] - paddle.to_tensor(target)
        loss = (d * d).sum()
        loss.backward()
        return loss

    def tclosure():
        d = tx[0] - torch.from_numpy(target)
        loss = (d * d).sum()
        loss.backward()
        return loss

    jc, tc = _counted(jclosure), _counted(tclosure)
    for _ in range(5):
        jl = float(np.asarray(jo.step(jc).numpy()))
        tl = float(to.step(tc).detach())
        np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-12)
        _same_state(jo, to, jx, tx)
        assert tc.calls == jc.calls
    if line_search:
        np.testing.assert_allclose(tx[0].detach().numpy(), target,
                                   atol=1e-3)


def test_step_without_closure_matches_reference():
    jx, jo, tx, to = _pair([np.array([4.0], np.float32)], learning_rate=0.1)
    for _ in range(30):
        (jx[0] * jx[0]).sum().backward()
        jo.step()
        jo.clear_grad()
        (tx[0] * tx[0]).sum().backward()
        to.step()
        to.clear_grad()
        _same_state(jo, to, jx, tx)
    assert abs(float(tx[0].detach()[0])) < 1.0


def test_least_squares_two_parameters_short_history():
    rng = np.random.RandomState(3)
    a = rng.randn(20, 6).astype(np.float32)
    b = rng.randn(20).astype(np.float32)
    jx, jo, tx, to = _pair([np.zeros(4, np.float32), np.zeros(2, np.float32)],
                           learning_rate=1.0, max_iter=2, history_size=3,
                           line_search_fn="strong_wolfe")

    def jclosure():
        x = paddle.concat([jx[0], jx[1]])
        r = paddle.matmul(paddle.to_tensor(a), x) - paddle.to_tensor(b)
        loss = (r * r).mean()
        loss.backward()
        return loss

    def tclosure():
        r = torch.from_numpy(a) @ torch.cat(tx) - torch.from_numpy(b)
        loss = (r * r).mean()
        loss.backward()
        return loss

    jc, tc = _counted(jclosure), _counted(tclosure)
    for _ in range(3):
        jl = float(np.asarray(jo.step(jc).numpy()))
        tl = float(to.step(tc).detach())
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
        _same_state(jo, to, jx, tx)
        assert tc.calls == jc.calls
    assert len(to._s_hist) == 3


def test_llama_tiny_closure_three_steps():
    paddle.seed(5)
    kw = dict(num_hidden_layers=1)
    jm = JaxLlama(jax_tiny(**kw))
    tm = load_paddle_tpu_state(
        LlamaForCausalLM(llama_tiny(**kw), device="cpu"),
        {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    ids = np.random.RandomState(0).randint(0, 128, (2, 9))
    x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int64)
    opt_kw = dict(learning_rate=1.0, max_iter=1, history_size=5,
                  line_search_fn="strong_wolfe")
    jo = jopt.LBFGS(parameters=jm.parameters(), **opt_kw)
    to = LBFGS(parameters=list(tm.parameters()), **opt_kw)

    def jclosure():
        loss = JaxCrit()(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        return loss

    def tclosure():
        loss = LlamaPretrainingCriterion()(tm(torch.from_numpy(x)),
                                           torch.from_numpy(y))
        loss.backward()
        return loss

    jc, tc = _counted(jclosure), _counted(tclosure)
    for i in range(3):
        jl = float(np.asarray(jo.step(jc).numpy()))
        tl = float(to.step(tc).detach())
        np.testing.assert_allclose(tl, jl, rtol=1e-6 if i == 0 else 2e-4)
        assert tc.calls == jc.calls
        assert len(to._s_hist) == len(jo._s_hist)
    got = export_paddle_tpu_state(tm)
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(got[name], np.asarray(p._data), rtol=0,
                                   atol=1e-4, err_msg=name)
