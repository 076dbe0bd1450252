"""Port parity: the port's ServingFrontend over port engines against the
reference's ServingFrontend over reference engines, on the CPU at
``llama_tiny`` sizes, weights carried across by ``models/convert.py``.

Eight requests (4 `batch` prompts of 40-150 tokens, 4 `interactive` of
6-20, interleaved) of 12 new tokens each, over two replicas:

- blended: each request's greedy tokens identical to the reference
  frontend's and to the reference's single-engine serve;
- roles prefill/decode over the spool transport and over the wire: the
  reference's single-engine tokens, every request handed off (published =
  adopted = 8), none corrupt or stale, the spool emptied;
- a replica killed mid-stream (``serving.replica_kill``): the reference's
  tokens, the dead replica's work rerouted;
- overload (a queue bound of 2, submitted before the dispatchers start):
  the same requests admitted, the same ``Overloaded`` fields for the rest
  (the shed order, ``step``, ``slo_class``), the admitted tokens
  identical;
- ``serving_report()``: the same key set, and the same deterministic
  counters as the reference's for the same run (submitted, completed,
  routed, shed).
Tokens are compared exactly (greedy f32 on the CPU). The reference engines
run their sync pipeline (``async_decode=False``; ROADMAP.md §3), the
port's their async default. Every result waits 60 s at most and every
frontend runs in a ``with`` block, so its threads join.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.observability.metrics import registry as ref_registry
from paddle_tpu.serving import HandoffManager as JaxHandoffManager
from paddle_tpu.serving import Overloaded as JaxOverloaded
from paddle_tpu.serving import SLOScheduler as JaxScheduler
from paddle_tpu.serving import ServingFrontend as JaxFrontend
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.observability.metrics import registry
from paddle_tpu_torch.serving import (
    HandoffManager, Overloaded, ServingFrontend, SLOScheduler,
    make_transport,
)
from paddle_tpu_torch.testing import chaos

ENGINE = dict(max_seqs=4, page_size=16, max_len=256, prefill_chunk=32,
              decode_block=4)
NEW = 12
WAIT = 60.0


@pytest.fixture(scope="module")
def models():
    paddle.seed(41)
    jm = JaxLlama(jax_tiny(num_hidden_layers=2, max_position_embeddings=256))
    jm.eval()
    tm = LlamaForCausalLM(
        llama_tiny(num_hidden_layers=2, max_position_embeddings=256),
        device="cpu")
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    rng = np.random.RandomState(13)
    load = []
    for i in range(4):
        load.append((rng.randint(1, 128, int(rng.randint(40, 151)))
                     .astype(np.int32), "batch"))
        load.append((rng.randint(1, 128, int(rng.randint(6, 21)))
                     .astype(np.int32), "interactive"))
    return jm, tm, load


@pytest.fixture(scope="module")
def oracle(models):
    """The reference's single-engine serve of the load (sync pipeline)."""
    jm, _, load = models
    return JaxEngine(jm, async_decode=False, **ENGINE).serve(
        [p for p, _ in load], max_new_tokens=NEW)


def _port_engines(tm, n=2):
    return [ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
            for _ in range(n)]


def _ref_engines(jm, n=2):
    return [JaxEngine(jm, async_decode=False, **ENGINE) for _ in range(n)]


def _run(fe_cls, engines, load, before_start=None, **kw):
    """Submit the load open loop, wait for every result; returns the
    outputs and the frontend's report."""
    with fe_cls(engines, heartbeat_deadline_s=120.0,
                start=before_start is None, **kw) as fe:
        hs = [fe.submit(p, NEW, slo_class=slo) for p, slo in load]
        if before_start is not None:
            before_start(fe)
            fe.start()
        outs = [h.result(timeout=WAIT) for h in hs]
        report = fe.serving_report()
    return outs, report


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _counts(reg, names):
    return {n: int(getattr(reg.get(n), "value", 0) or 0) for n in names}


COUNTERS = ("serving.submitted", "serving.completed", "serving.routed",
            "serving.shed", "serving.failed")


def test_blended_tokens_and_report_match_the_reference(models, oracle):
    jm, tm, load = models
    c_ref = _counts(ref_registry, COUNTERS)
    want, ref_report = _run(JaxFrontend, _ref_engines(jm), load)
    c_ref = {k: v - c_ref[k] for k, v in _counts(ref_registry,
                                                 COUNTERS).items()}
    c_port = _counts(registry, COUNTERS)
    got, report = _run(ServingFrontend, _port_engines(tm), load)
    c_port = {k: v - c_port[k] for k, v in _counts(registry,
                                                   COUNTERS).items()}
    _same(want, oracle)
    _same(got, want)
    # the report's shape is the reference's; so are its deterministic
    # counters for the same run
    assert sorted(report) == sorted(ref_report)
    for key in ("replicas", "slo", "brownout", "goodput", "fleet", "kv",
                "adapters", "tenants", "memory", "compile"):
        assert isinstance(report[key], dict)
    assert sorted(report["slo_classes"]) == sorted(ref_report["slo_classes"])
    assert (sorted(report["replicas"]["replica0"])
            == sorted(ref_report["replicas"]["replica0"]))
    assert c_port == c_ref == {"serving.submitted": 8,
                               "serving.completed": 8, "serving.routed": 8,
                               "serving.shed": 0, "serving.failed": 0}
    assert report["devprof"] == ref_report["devprof"] == {"enabled": False}


@pytest.mark.parametrize("kind", ["spool", "wire"])
def test_role_split_hands_off_every_request(models, oracle, tmp_path, kind):
    _, tm, load = models
    names = [f"serving.handoff.{k}" for k in
             ("published", "adopted", "corrupt", "stale", "initiated")]
    before = _counts(registry, names)
    transport = (HandoffManager(spool_dir=str(tmp_path)) if kind == "spool"
                 else make_transport("wire"))
    got, report = _run(ServingFrontend, _port_engines(tm), load,
                       roles=["prefill", "decode"], handoff=transport)
    _same(got, oracle)
    h = {k.rsplit(".", 1)[1]: v - before[k]
         for k, v in _counts(registry, names).items()}
    assert h == {"published": 8, "adopted": 8, "corrupt": 0, "stale": 0,
                 "initiated": 8}
    assert report["replicas"]["replica0"]["role"] == "prefill"
    assert not list(tmp_path.iterdir())


def test_reference_role_split_shape_matches(models, tmp_path):
    """The reference's own role split on the same load: its report keys
    and roles are the port's (its tokens are not held here: the
    reference's disaggregated run is on ROADMAP.md §3's flaky list)."""
    jm, tm, load = models
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    _, ref_report = _run(JaxFrontend, _ref_engines(jm), load[:2],
                         roles=["prefill", "decode"],
                         handoff=JaxHandoffManager(
                             spool_dir=str(tmp_path / "r")))
    _, report = _run(ServingFrontend, _port_engines(tm), load[:2],
                     roles=["prefill", "decode"],
                     handoff=HandoffManager(spool_dir=str(tmp_path / "p")))
    assert sorted(report) == sorted(ref_report)
    assert ({r["role"] for r in report["replicas"].values()}
            == {r["role"] for r in ref_report["replicas"].values()})
    assert sorted(report["fleet"]["roles"]) == sorted(
        ref_report["fleet"]["roles"])


def test_replica_kill_reroutes_with_the_reference_tokens(models, oracle):
    _, tm, load = models
    rerouted = _counts(registry, ("serving.rerouted",
                                  "serving.replica_dead"))
    plan = chaos.FaultPlan().fail("serving.replica_kill", after=3, times=1)
    try:
        got, report = _run(ServingFrontend, _port_engines(tm), load,
                           before_start=lambda fe: chaos.arm(plan))
    finally:
        chaos.disarm()
    _same(got, oracle)
    after = _counts(registry, ("serving.rerouted", "serving.replica_dead"))
    assert plan.rules[0].fired == 1
    assert after["serving.replica_dead"] - rerouted[
        "serving.replica_dead"] == 1
    assert after["serving.rerouted"] - rerouted["serving.rerouted"] >= 1
    assert sorted(r["state"] for r in report["replicas"].values()) == [
        "DEAD", "LIVE"]


def _overload(fe_cls, sched_cls, over_cls, engines, load):
    shed, admitted = [], []
    with fe_cls(engines, scheduler=sched_cls(max_queue_depth=2),
                heartbeat_deadline_s=120.0, start=False) as fe:
        for i, (p, slo) in enumerate(load):
            try:
                admitted.append((i, fe.submit(p, NEW, slo_class=slo)))
            except over_cls as e:
                shed.append((i, e.step, e.slo_class, e.level,
                             e.retry_after_s, str(e)))
        fe.start()
        outs = [h.result(timeout=WAIT) for _, h in admitted]
    return [i for i, _ in admitted], shed, outs


def test_overload_sheds_the_reference_requests(models):
    jm, tm, load = models
    want = _overload(JaxFrontend, JaxScheduler, JaxOverloaded,
                     _ref_engines(jm), load)
    got = _overload(ServingFrontend, SLOScheduler, Overloaded,
                    _port_engines(tm), load)
    assert got[0] == want[0] == [0, 1]
    assert got[1] == want[1]
    _same(got[2], want[2])
