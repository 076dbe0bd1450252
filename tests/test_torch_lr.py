"""Port parity: the learning-rate schedulers of ``paddle_tpu_torch.optimizer
.lr`` against ``paddle_tpu.optimizer.lr``.

Tolerance: none. The schedulers are pure Python in both packages, so the
lr sequences over 30 steps are equal float for float, the state dicts
round-trip to the same sequence, and an optimizer reads the scheduler's
value at every update and refuses ``set_lr`` under one, as the
reference's does.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.optimizer import lr as tlr


def _cases(m):
    return {
        "NoamDecay": lambda: m.NoamDecay(d_model=64, warmup_steps=5),
        "PiecewiseDecay": lambda: m.PiecewiseDecay([3, 10, 20],
                                                   [0.1, 0.05, 0.01, 0.001]),
        "NaturalExpDecay": lambda: m.NaturalExpDecay(0.5, gamma=0.1),
        "InverseTimeDecay": lambda: m.InverseTimeDecay(0.5, gamma=0.1),
        "PolynomialDecay": lambda: m.PolynomialDecay(0.5, decay_steps=12,
                                                     power=2.0),
        "PolynomialDecay-cycle": lambda: m.PolynomialDecay(
            0.5, decay_steps=7, end_lr=0.01, cycle=True),
        "LinearWarmup": lambda: m.LinearWarmup(0.3, warmup_steps=6,
                                               start_lr=0.0, end_lr=0.3),
        "LinearWarmup-cosine": lambda: m.LinearWarmup(
            m.CosineAnnealingDecay(3e-4, T_max=20, eta_min=3e-5),
            warmup_steps=4, start_lr=0.0, end_lr=3e-4),
        "ExponentialDecay": lambda: m.ExponentialDecay(0.5, gamma=0.9),
        "MultiStepDecay": lambda: m.MultiStepDecay(0.5, milestones=[4, 9, 17],
                                                   gamma=0.3),
        "StepDecay": lambda: m.StepDecay(0.5, step_size=4, gamma=0.7),
        "LambdaDecay": lambda: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "MultiplicativeDecay": lambda: m.MultiplicativeDecay(
            0.5, lambda e: 0.9),
        "ReduceOnPlateau": lambda: m.ReduceOnPlateau(0.5, patience=2,
                                                     factor=0.5, cooldown=1),
        "CosineAnnealingDecay": lambda: m.CosineAnnealingDecay(
            0.5, T_max=11, eta_min=0.01),
        "CosineAnnealingWarmRestarts": lambda: m.CosineAnnealingWarmRestarts(
            0.5, T_0=4, T_mult=2, eta_min=0.01),
        "OneCycleLR": lambda: m.OneCycleLR(0.5, total_steps=25),
        "OneCycleLR-linear": lambda: m.OneCycleLR(
            0.5, total_steps=25, anneal_strategy="linear"),
        "CyclicLR": lambda: m.CyclicLR(0.01, 0.5, step_size_up=5),
        "CyclicLR-triangular2": lambda: m.CyclicLR(
            0.01, 0.5, step_size_up=3, step_size_down=5, mode="triangular2"),
        "CyclicLR-exp_range": lambda: m.CyclicLR(
            0.01, 0.5, step_size_up=4, mode="exp_range", exp_gamma=0.97),
        "LinearLR": lambda: m.LinearLR(0.5, total_steps=12),
    }


CASES = sorted(_cases(tlr))
# a plateau, then improvement, then another plateau
METRICS = [1.0, 0.9, 0.9, 0.9, 0.9, 0.9, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8] * 3


def _sequence(sched, n=30):
    out = [sched()]
    for i in range(n):
        if isinstance(sched, (tlr.ReduceOnPlateau, jlr.ReduceOnPlateau)):
            sched.step(METRICS[i])
        else:
            sched.step()
        out.append(sched())
    return out


def test_every_scheduler_is_covered():
    names = {c.split("-")[0] for c in CASES}
    ported = {n for n, v in vars(tlr).items()
              if isinstance(v, type) and issubclass(v, tlr.LRScheduler)
              and v is not tlr.LRScheduler}
    assert len(ported) == 17
    assert names == ported


@pytest.mark.parametrize("case", CASES)
def test_lr_sequence_equals_reference(case):
    assert _sequence(_cases(tlr)[case]()) == _sequence(_cases(jlr)[case]())


@pytest.mark.parametrize("case", CASES)
def test_state_dict_round_trip(case):
    a = _cases(tlr)[case]()
    _sequence(a, 7)
    sd = a.state_dict()
    assert sd == _sequence_ref(case, 7).state_dict()
    b = _cases(tlr)[case]()
    b.set_state_dict(dict(sd))
    assert _sequence(b, 12) == _sequence(a, 12)


def _sequence_ref(case, n):
    s = _cases(jlr)[case]()
    _sequence(s, n)
    return s


def test_optimizer_reads_the_scheduler_and_refuses_set_lr():
    p = torch.ones(3, requires_grad=True)
    sched = tlr.StepDecay(0.5, step_size=2, gamma=0.5)
    opt = SGD(learning_rate=sched, parameters=[p])
    seen = []
    for _ in range(4):
        p.grad = torch.ones(3)
        seen.append(opt.get_lr())
        opt.step()
        sched.step()
    assert seen == [0.5, 0.5, 0.25, 0.25]
    np.testing.assert_allclose(p.detach().numpy(), 1 - 1.5, rtol=1e-6)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    assert opt.state_dict()["LR_Scheduler"] == sched.state_dict()
    fresh = SGD(learning_rate=tlr.StepDecay(0.5, step_size=2, gamma=0.5),
                parameters=[p])
    fresh.set_state_dict(opt.state_dict())
    assert fresh.get_lr() == opt.get_lr() == 0.125
    plain = SGD(learning_rate=0.1, parameters=[p])
    plain.set_lr(0.2)
    plain.set_lr_scheduler(sched)
    assert plain.get_lr() == 0.125
