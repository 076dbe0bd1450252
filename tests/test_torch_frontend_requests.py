"""Port parity: a request's own paths through the port's ServingFrontend
against the reference's, on the CPU at ``llama_tiny`` sizes (weights
carried by ``models/convert.py``; the reference engines in their sync
pipeline, ROADMAP.md §3):

- deadline expiry: a request whose deadline passes while it queues fails
  with the reference's ``DeadlineExceeded`` message, the others serve the
  reference's tokens;
- cancel: a queued request cancelled before the dispatchers start raises
  ``RequestCancelled`` in both, its neighbours are unaffected;
- ``stream()`` yields the tokens ``result()`` returns, and a wait bound
  that expires raises ``ResultTimeout`` without cancelling;
- tenant quota: a declared tenant's token bucket on an injected clock
  sheds the same submit with the same ``Overloaded(step="tenant_quota",
  tenant=..., retry_after_s=...)``, and an unknown tenant is refused;
- an adapter request (a rank-4 LoRA adapter registered in the frontend)
  serves the reference frontend's tokens beside base requests, and a
  tenant's adapter allowlist refuses another adapter alike.
Tokens are compared exactly. Every wait is bounded (60 s), every
frontend runs in a ``with`` block.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_tiny
from paddle_tpu.serving import Overloaded as JaxOverloaded
from paddle_tpu.serving import RequestCancelled as JaxCancelled
from paddle_tpu.serving import RequestFailed as JaxFailed
from paddle_tpu.serving import ServingFrontend as JaxFrontend
from paddle_tpu.serving import Tenant as JaxTenant
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.models.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.serving import (
    Overloaded, RequestCancelled, RequestFailed, ResultTimeout,
    ServingFrontend, Tenant,
)

ENGINE = dict(max_seqs=4, page_size=16, max_len=256, decode_block=4)
NEW = 10
WAIT = 60.0


@pytest.fixture(scope="module")
def models():
    paddle.seed(43)
    jm = JaxLlama(jax_tiny(num_hidden_layers=2, max_position_embeddings=256))
    jm.eval()
    tm = LlamaForCausalLM(
        llama_tiny(num_hidden_layers=2, max_position_embeddings=256),
        device="cpu")
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    rng = np.random.RandomState(17)
    prompts = [rng.randint(1, 128, n).astype(np.int32)
               for n in (12, 37, 5, 60)]
    return jm, tm, prompts


SIDES = {
    "ref": dict(fe=JaxFrontend, failed=JaxFailed, cancelled=JaxCancelled,
                overloaded=JaxOverloaded, tenant=JaxTenant),
    "port": dict(fe=ServingFrontend, failed=RequestFailed,
                 cancelled=RequestCancelled, overloaded=Overloaded,
                 tenant=Tenant),
}


def _engine(models, side):
    jm, tm, _ = models
    if side == "ref":
        return JaxEngine(jm, async_decode=False, **ENGINE)
    return ContinuousBatchingEngine(tm, device="cpu", **ENGINE)


def _outcome(h, side):
    s = SIDES[side]
    try:
        return ("ok", h.result(timeout=WAIT).tolist())
    except s["cancelled"]:
        return ("cancelled",)
    except s["failed"] as e:
        return ("failed", str(e))   # names the rid and the class


def _deadline_and_cancel(models, side):
    _, _, prompts = models
    s = SIDES[side]
    with s["fe"]([_engine(models, side)], heartbeat_deadline_s=120.0,
                 start=False) as fe:
        hs = [fe.submit(prompts[0], NEW),
              fe.submit(prompts[1], NEW, slo_class="batch", deadline_s=0.0),
              fe.submit(prompts[2], NEW),
              fe.submit(prompts[3], NEW, slo_class="batch")]
        hs[2].cancel()
        fe.start()
        out = [_outcome(h, side) for h in hs]
        statuses = [h.status for h in hs]
    return out, statuses


def test_deadline_expiry_and_cancel_match(models):
    want = _deadline_and_cancel(models, "ref")
    got = _deadline_and_cancel(models, "port")
    assert got == want
    assert got[1] == ["DONE", "FAILED", "CANCELLED", "DONE"]
    assert "spent longer than its deadline queued" in got[0][1][1]


def test_stream_and_result_timeout(models):
    _, _, prompts = models
    with ServingFrontend([_engine(models, "port")],
                         heartbeat_deadline_s=120.0, start=False) as fe:
        h = fe.submit(prompts[1], NEW)
        with pytest.raises(ResultTimeout):
            h.result(timeout=0.01)          # not started: still queued
        assert h.status == "QUEUED"
        fe.start()
        streamed = list(h.stream(timeout=WAIT))
        full = h.result(timeout=WAIT)
    assert streamed == full[len(prompts[1]):].tolist()
    assert len(streamed) == NEW


class _Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


def _tenant_quota(models, side):
    _, _, prompts = models
    s = SIDES[side]
    clock = _Clock()
    t = s["tenant"]("parity-quota", quota_rps=1.0, burst=2.0,
                    max_inflight=8, clock=clock)
    out = []
    with s["fe"]([_engine(models, side)], heartbeat_deadline_s=120.0,
                 tenants=[t]) as fe:
        hs = []
        for i in range(4):
            clock.t += 0.25
            try:
                hs.append(fe.submit(prompts[i % 4], NEW,
                                    tenant="parity-quota"))
                out.append(("admitted", i))
            except s["overloaded"] as e:
                out.append(("shed", i, e.step, e.tenant,
                            round(e.retry_after_s, 9), str(e)))
        try:
            fe.submit(prompts[0], NEW, tenant="ghost")
        except ValueError as e:
            out.append(("refused", str(e)))
        out.append([h.result(timeout=WAIT).tolist() for h in hs])
        rep = fe.tenant_report()["parity-quota"]
        out.append({k: rep[k] for k in ("quota_rps", "burst",
                                        "max_inflight", "inflight")})
    return out


def test_tenant_quota_sheds_alike(models):
    want = _tenant_quota(models, "ref")
    got = _tenant_quota(models, "port")
    assert got == want
    assert [o[0] for o in got[:4]] == ["admitted", "admitted", "shed",
                                       "shed"]


def _adapter_serve(models, side):
    jm, tm, prompts = models
    s = SIDES[side]
    rng = np.random.RandomState(5)
    a = (rng.randn(64, 4) * 0.3).astype(np.float32)
    b = (rng.randn(4, 128) * 0.3).astype(np.float32)
    t = s["tenant"]("parity-lora", adapters=("other",))
    out = []
    with s["fe"]([_engine(models, side), _engine(models, side)],
                 heartbeat_deadline_s=120.0, tenants=[t]) as fe:
        ad = fe.adapters.register("ad-rank4", a, b, scale=0.5)
        hs = [fe.submit(prompts[0], NEW, adapter="ad-rank4"),
              fe.submit(prompts[1], NEW),
              fe.submit(prompts[3], NEW, adapter=ad.digest)]
        try:
            fe.submit(prompts[2], NEW, tenant="parity-lora",
                      adapter="ad-rank4")
        except ValueError as e:
            out.append(("refused", str(e)))
        out.append([h.result(timeout=WAIT).tolist() for h in hs])
        out.append(fe.adapters.report())
    return out


def test_adapter_request_matches_the_reference(models):
    want = _adapter_serve(models, "ref")
    got = _adapter_serve(models, "port")
    assert got == want
    base = ContinuousBatchingEngine(models[1], device="cpu", **ENGINE)\
        .serve([models[2][0]], NEW)[0].tolist()
    assert got[1][0] != base      # the adapter moved the tokens
