"""Serving of the port (counterpart of ``paddle_tpu/serving``): the online
control plane over N ``ContinuousBatchingEngine`` replicas.

- ``frontend.py``: ``ServingFrontend`` (``submit`` / ``RequestHandle.
  stream()`` / ``result()`` / ``cancel()``), one dispatcher thread per
  replica, the liveness monitor, failover, drain, disaggregated
  prefill/decode and ``serving_report()``;
- ``scheduler.py``: SLO classes, EDF ordering, the queue bound
  (``Overloaded``) and deadline expiry; ``router.py``: prefix-affinity and
  load placement, replica health; ``brownout.py`` and ``breaker.py``: the
  overload ladder, the retry budget and the circuit breaker;
  ``tenancy.py``: tenants with token-bucket quotas;
- ``handoff.py``, ``transport.py``, ``wireformat.py``: the KV-page handoff
  bundles, the spool and wire transports and their non-executable
  encoding; ``kvfabric.py``: the cluster prefix residency and host spill
  ring;
- ``adapters.py``: the LoRA adapter registry;
- ``supervisor.py``: the replica supervisor (``ReplicaSupervisor``), which
  replaces dead replicas and scales the pool, and the generation fence of
  each incarnation (``ReplicaFence``).
"""
from ..inference.continuous import EngineRequest, canonical_sampling
from .adapters import AdapterRegistry, LoRAAdapter
from .breaker import BreakerPolicy, CircuitBreaker
from .brownout import BrownoutLadder, BrownoutStep, RetryBudget
from .frontend import (
    CANCELLED, DONE, FAILED, QUEUED, RUNNING, RequestCancelled,
    RequestFailed, RequestHandle, ResultTimeout, ServingFrontend,
)
from .handoff import (
    HandoffBundle, HandoffCorruptError, HandoffError, HandoffManager,
    StaleHandoffError,
)
from .kvfabric import HostSpillRing, KVFabric
from .router import (
    DEAD, DRAINING, LIVE, PROBATION, NoLiveReplicas, ReplicaHandle, Router,
)
from .scheduler import (
    BATCH, INTERACTIVE, DeadlineExceeded, Overloaded, SLOClass,
    SLOScheduler,
)
from .supervisor import ReplicaFence, ReplicaSupervisor
from .tenancy import DEFAULT_TENANT, Tenant, TenantRegistry
from .transport import (
    KVFetchTimeout, KVPageServer, KVPartitionError, KVTransportError,
    WireTransport, make_transport,
)

__all__ = [
    "ServingFrontend", "RequestHandle", "RequestFailed", "RequestCancelled",
    "ResultTimeout",
    "QUEUED", "RUNNING", "DONE", "FAILED", "CANCELLED",
    "Router", "ReplicaHandle", "NoLiveReplicas",
    "LIVE", "PROBATION", "DRAINING", "DEAD",
    "SLOScheduler", "SLOClass", "Overloaded", "DeadlineExceeded",
    "INTERACTIVE", "BATCH", "EngineRequest", "canonical_sampling",
    "BrownoutLadder", "BrownoutStep", "RetryBudget",
    "CircuitBreaker", "BreakerPolicy",
    "HandoffManager", "HandoffBundle", "HandoffError",
    "HandoffCorruptError", "StaleHandoffError",
    "KVFabric", "HostSpillRing",
    "WireTransport", "KVPageServer", "make_transport",
    "KVTransportError", "KVFetchTimeout", "KVPartitionError",
    "Tenant", "TenantRegistry", "DEFAULT_TENANT",
    "LoRAAdapter", "AdapterRegistry",
    "ReplicaSupervisor", "ReplicaFence",
]
