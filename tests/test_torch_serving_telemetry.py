"""Port parity: the serving engine's telemetry and fault seams against the
reference engine's, on the CPU at ``llama_tiny`` sizes (weights carried by
``models/convert.py``; the reference engines in their sync pipeline,
ROADMAP.md §3), and the port's compile lock:

- a planted ``serve.prefill`` fault (the legacy plane's per-request
  prefill) fails its request alone, as the reference's does
  (``test_chaos.py::TestServingFaults``): the co-tenants serve their
  tokens, no page or slot leaks, and the engine serves again;
- ``serve.decode`` faults: two transient ones are retried with the
  reference's counters and change no token; a persistent one raises and
  leaves the engine clean;
- the goodput split, the compile ledger and the devprof plane carry the
  reference's names: the goodput categories a traced serve notes, the
  ledger keys of a fresh engine's program families (``warmup``-labeled
  under ``warmup``), the devprof program keys with the analytic cost row
  (so MFU and a verdict exist);
- OOM forensics: the ``obs.oom`` site writes ``oom_report.json`` with the
  reference's sections and the engine's context keys;
- request traces through the frontend: the same span names per request;
- ``_COMPILE_LOCK`` around a kernel library's first build: the builder is
  its participant, the build is ledgered as ``build.<name>``, and the
  frontend's monitor spares a replica stale in it (and kills it once the
  build is over);
- the kernels' launch counters lose no increment under threads.
"""
import ctypes.util
import json
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.observability import compilemem as ref_compilemem
from paddle_tpu.observability import devprof as ref_devprof
from paddle_tpu.observability import goodput as ref_goodput
from paddle_tpu.observability import request_trace as ref_rtrace
from paddle_tpu.observability import tracing as ref_tracing
from paddle_tpu.serving import ServingFrontend as JaxFrontend
from paddle_tpu.testing import chaos as ref_chaos
from paddle_tpu.utils.metrics_bus import counters as ref_counters
from paddle_tpu_torch.inference import continuous
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.observability import compilemem, devprof, goodput
from paddle_tpu_torch.observability import request_trace as rtrace
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.observability.metrics import registry
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.serving import ServingFrontend
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.utils.metrics_bus import counters

ENGINE = dict(max_seqs=2, page_size=16, max_len=64)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(num_hidden_layers=2))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(num_hidden_layers=2), device="cpu")
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 128, (n,)).astype(np.int32) for n in (5, 9, 7)]
    return jm, tm, prompts


def _port(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", **dict(ENGINE, **kw))


def _ref(jm, **kw):
    return JaxEngine(jm, async_decode=False, **dict(ENGINE, **kw))


def _failed_prefill(eng, plan_cls, prompts):
    ref = eng.serve(prompts, max_new_tokens=4)
    with plan_cls().fail("serve.prefill", times=1):
        outs = eng.serve(prompts, max_new_tokens=4)
    err = eng.request_errors[0]
    again = eng.serve(prompts, max_new_tokens=4)
    return ([None if o is None else o.tolist() for o in outs],
            type(err).__name__, str(err), eng.stats["failed_requests"],
            len(eng.free_pages) == eng.num_pages - 1,
            sorted(eng.free_slots),
            [o.tolist() for o in ref], [o.tolist() for o in again])


def test_failed_prefill_retires_its_slot_not_the_batch(models):
    jm, tm, prompts = models
    want = _failed_prefill(_ref(jm, ragged=False), ref_chaos.FaultPlan,
                           prompts)
    got = _failed_prefill(_port(tm, ragged=False), chaos.FaultPlan,
                          prompts)
    assert got == want
    outs, err_type, _, failed, clean, slots, ref, again = got
    assert outs[0] is None and outs[1:] == ref[1:]
    assert err_type == "FaultInjected" and failed == 1 and clean
    assert slots == [0, 1] and again == ref


@pytest.mark.parametrize("ragged", [True, False])
def test_decode_faults_retry_or_raise_as_the_reference(models, ragged):
    jm, tm, prompts = models
    outcomes = []
    for eng, plan_cls, ctr in ((_ref(jm, ragged=ragged), ref_chaos.FaultPlan,
                                ref_counters),
                               (_port(tm, ragged=ragged), chaos.FaultPlan,
                                counters)):
        ref = eng.serve(prompts, max_new_tokens=4)
        ctr.reset("fault.")
        with plan_cls().fail("serve.decode", times=2):
            outs = eng.serve(prompts, max_new_tokens=4)
        retried = ctr.get("fault.retry.serve.decode")
        with plan_cls().fail("serve.decode", times=None):
            with pytest.raises(ConnectionError):
                eng.serve(prompts, max_new_tokens=4)
        outcomes.append(([o.tolist() for o in outs] == [o.tolist()
                                                        for o in ref],
                         retried, ctr.get("fault.exhausted.serve.decode"),
                         len(eng.free_pages) == eng.num_pages - 1,
                         eng.serve(prompts[:1], 2)[0] is not None))
    assert outcomes[0] == outcomes[1] == (True, 2, 1, True, True)


def _goodput_categories(eng, trc, acct, prompts):
    trc.enable()
    try:
        acct.serving.reset()
        eng.serve(prompts, max_new_tokens=6)
        eng.serve(prompts, max_new_tokens=6)
        return sorted(acct.serving.totals())
    finally:
        trc.disable()


@pytest.mark.parametrize("ragged", [True, False])
def test_goodput_split_names_match(models, ragged):
    jm, tm, prompts = models
    want = _goodput_categories(_ref(jm, ragged=ragged, prefill_chunk=16),
                               ref_tracing, ref_goodput, prompts)
    got = _goodput_categories(_port(tm, ragged=ragged, prefill_chunk=16,
                                    async_decode=False),
                              tracing, goodput, prompts)
    assert got == want
    assert {"decode", "host_emit", "compile"} <= set(got)


def _ledger_keys(cm, make, prompts, warm):
    """{program key: its new events' triggers} of a fresh engine's
    (warmup and) serve."""
    before = {k: dict(v["triggers"]) for k, v in cm.ledger.report(recent=0)
              ["by_key"].items()}
    eng = make()
    if warm:
        eng.warmup(prompt_lens=[len(p) for p in prompts])
    eng.serve(prompts, max_new_tokens=4)
    out = {}
    for k, v in cm.ledger.report(recent=0)["by_key"].items():
        if not k.startswith("serve.") or k == "serve.keys_from_base":
            continue
        old = before.get(k, {})
        new = {t: n - old.get(t, 0) for t, n in v["triggers"].items()
               if n > old.get(t, 0)}
        if new:
            out[k] = new
    return out


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("warm", [False, True])
def test_compile_ledger_keys_match(models, ragged, warm):
    jm, tm, prompts = models
    want = _ledger_keys(ref_compilemem, lambda: _ref(jm, ragged=ragged),
                        prompts, warm)
    got = _ledger_keys(compilemem, lambda: _port(tm, ragged=ragged),
                       prompts, warm)
    assert sorted(got) == sorted(want)
    # a warmed engine serves its vocabulary without a first dispatch; an
    # unwarmed one's are "cold", or "recompile" where an earlier engine of
    # this process ran the family (in each package's own ledger)
    for t in got.values():
        assert set(t) == {"warmup"} if warm else set(t) <= {"cold",
                                                             "recompile"}


def test_devprof_programs_and_cost_rows(models):
    jm, tm, prompts = models
    keys = []
    for dp, make in ((ref_devprof, lambda: _ref(jm)),
                     (devprof, lambda: _port(tm, async_decode=False))):
        eng = make()
        eng.serve(prompts, max_new_tokens=20)     # first dispatches: cold
        dp.enable(sample_every=1)
        try:
            eng.serve(prompts, max_new_tokens=20)
            rep = dp.serving_block()
        finally:
            dp.disable()
        keys.append((sorted(k for k in rep["programs"]
                            if k.startswith("serve.")),
                     sorted(rep.get("serving", {}).get("per_program", {}))))
        rows = rep["programs"]
    assert keys[0] == keys[1] and keys[1][0] and keys[1][1]
    for key, row in rows.items():
        assert row["samples"] >= 1 and row["tokens"] > 0
        assert row["flops"] > 0 and row["bytes"] > 0 and row["mfu"] > 0
        assert row["verdict"] in ("compute-bound", "memory-bound",
                                  "host-bound")
    assert rep["serving"]["decode_tokens"] > 0
    assert devprof.serving_block() == {"enabled": False}


def _oom(cm, plan_cls, eng, prompts, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TELEMETRY_DIR", str(tmp_path))
    with plan_cls().fail("obs.oom", times=1):
        try:
            eng.serve(prompts, max_new_tokens=2)
        except Exception as e:  # noqa: BLE001 - an engine may raise it
            assert cm.is_oom(e)
    with open(tmp_path / cm.OOM_REPORT_NAME) as f:
        rep = json.load(f)
    return (sorted(rep), sorted(rep["contexts"]),
            sorted(rep["contexts"]["serving_engine"][-1]),
            cm.is_oom(RuntimeError("CUDA out of memory. Tried to allocate")))


def test_oom_report_sections_match(models, tmp_path, monkeypatch):
    jm, tm, prompts = models
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    want = _oom(ref_compilemem, ref_chaos.FaultPlan, _ref(jm), prompts,
                tmp_path / "r", monkeypatch)
    got = _oom(compilemem, chaos.FaultPlan, _port(tm), prompts,
               tmp_path / "p", monkeypatch)
    # the reference's XLA memory analysis (top_programs_by_temp) has no
    # eager counterpart
    assert got[0] == [k for k in want[0] if k != "top_programs_by_temp"]
    assert got[1:3] == want[1:3]
    assert got[3]


def _trace_names(fe_cls, trc, rt, eng, prompts):
    trc.enable()
    rt.clear()
    try:
        with fe_cls([eng], heartbeat_deadline_s=120.0) as fe:
            for p in prompts:
                assert fe.submit(p, 4).result(timeout=60) is not None
        return [sorted({r["name"] for r in t["records"]})
                for t in sorted(rt.recent(), key=lambda t: t["rid"])]
    finally:
        trc.disable()


@pytest.mark.parametrize("ragged", [True, False])
def test_request_trace_span_names_match(models, ragged):
    jm, tm, prompts = models
    kw = dict(ragged=ragged, prefill_chunk=16, decode_block=2)
    want = _trace_names(JaxFrontend, ref_tracing, ref_rtrace,
                        _ref(jm, **kw), prompts)
    got = _trace_names(ServingFrontend, tracing, rtrace,
                       _port(tm, async_decode=False, **kw), prompts)
    assert got == want
    assert {"request", "attempt", "place", "queue", "admit",
            "first_token", "decode_block", "emit"} <= set(got[0])


# ---- the compile lock ----------------------------------------------------------
@pytest.fixture
def slow_build(monkeypatch):
    """``_build.build`` stood in by a 0.4 s 'build' of libc, so that
    ``_build.library`` runs its first-build path on the CPU."""
    libc = ctypes.util.find_library("c")
    started = threading.Event()

    def build(names):
        started.set()
        time.sleep(0.4)
        return {n: {"path": libc, "seconds": 0.4, "log": ""} for n in names}

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.delitem(_build._LIBS, "parity_fake", raising=False)
    yield started
    _build._LIBS.pop("parity_fake", None)


def test_first_build_holds_the_compile_lock(models, slow_build):
    _, tm, _ = models
    lock = continuous._COMPILE_LOCK
    assert lock.name == "inference.compile_lock"
    before = compilemem.ledger.report(recent=0)["by_key"].get(
        "build.parity_fake", {}).get("count", 0)
    builder = threading.Thread(target=_build.library, args=("parity_fake",))
    with ServingFrontend([_port(tm)], heartbeat_deadline_s=1.0,
                         heartbeat_misses=1, start=False) as fe:
        rep = fe.replicas[0]
        spared = registry.counter("serving.replica_spared").value
        builder.start()
        assert slow_build.wait(10)
        rep.thread_ident = builder.ident
        rep.last_beat = time.monotonic() - 5.0      # a stale beat
        assert builder.ident in lock.participants()
        assert lock.held_since() is not None
        fe._check_replica_liveness(rep, time.monotonic())
        assert rep.state == "LIVE"                   # building: spared
        assert registry.counter("serving.replica_spared").value == (
            spared + 1)
        builder.join(10)
        assert not builder.is_alive()
        assert lock.participants() == set()
        fe._check_replica_liveness(rep, time.monotonic())
        assert rep.state == "DEAD"                   # stale outside it
    rep_led = compilemem.ledger.report(recent=0)["by_key"]["build.parity_fake"]
    assert rep_led["count"] == before + 1
    assert _build.library("parity_fake") is _build._LIBS["parity_fake"]


def test_launch_counts_lose_no_increment_under_threads():
    def fake():
        pass

    fake.launches = 0
    fake.launches_int8 = 0
    fake.launches_by_thread = {}
    n_threads, per = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch(fake, "launches")
                            for _ in range(per)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fake.launches == n_threads * per
    assert fake.launches_int8 == 0
    # (a finished thread's ident may be reused by a later one)
    assert sum(fake.launches_by_thread.values()) == n_threads * per
    assert {k[0] for k in fake.launches_by_thread} == {"launches"}
