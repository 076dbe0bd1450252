"""SLO-aware request scheduling for the online serving control plane (the
port's own copy of ``paddle_tpu/serving/scheduler.py``).

Policy, not mechanism: this module owns WHICH queued request runs next and
WHETHER a new request is admitted at all. It holds no queues, starts no
threads, and never touches an engine — the frontend feeds it pending lists
and applies its verdicts, which keeps every decision unit-testable without
a model.

Three decisions:

- **Admission** (:meth:`SLOScheduler.check_admission`): bounded queue depth
  with load shedding. A full queue rejects the submit with
  :class:`Overloaded` *immediately* — the client gets a fast, explicit
  signal it can retry against another cell, instead of a request that sits
  in a hopeless queue until it times out silently. Interactive traffic may
  additionally reserve headroom (``interactive_reserve``) that batch
  submissions cannot consume, so a batch flood can't shed interactive
  requests.

- **Ordering** (:meth:`SLOScheduler.pick`): earliest-*virtual*-deadline
  first. Every request gets ``virtual_deadline = enqueue_time +
  min(user deadline, slo.target_wait_s)``. Interactive targets are small
  (they sort first under mixed load); batch targets are large but FINITE —
  once a batch request has waited past its target it has the earliest
  deadline in the queue and nothing submitted later can overtake it. EDF
  over finite virtual deadlines is starvation-free by construction, and the
  property is asserted under an interactive storm in
  tests/test_serving_frontend.py.

- **Expiry** (:meth:`SLOScheduler.expired`): a request whose *user-supplied*
  deadline passed while it queued is failed with :class:`DeadlineExceeded`
  at pick time — running it would waste decode slots producing tokens the
  caller has already abandoned.
"""
import time

__all__ = ["Overloaded", "DeadlineExceeded", "SLOClass", "SLOScheduler",
           "INTERACTIVE", "BATCH"]


class Overloaded(RuntimeError):
    """Raised by submit(): the control plane is shedding load. Retry against
    another cell / later — the request was never queued.

    Machine-readable: clients back off from the structured
    fields instead of parsing the message — ``retry_after_s`` is the
    server's backoff demand (honoring it is what keeps a retry storm from
    re-saturating a recovering fleet; retries that ignore it burn the
    per-class retry budget and get rejected harder), ``level``/``step``
    identify the brownout rung that shed the request (``None``/"queue"
    for a plain queue-bound shed), ``slo_class`` echoes the class, and
    ``tenant`` names the tenant whose quota/inflight bound (or private
    brownout ladder) shed it — ``step`` is ``"tenant_quota"`` /
    ``"tenant_inflight"`` for those sheds, with
    ``retry_after_s`` derived from the token bucket's refill deficit."""

    def __init__(self, msg, retry_after_s=None, level=None, step=None,
                 slo_class=None, tenant=None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.level = level
        self.step = step
        self.slo_class = slo_class
        self.tenant = tenant


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it reached a decode slot."""


class SLOClass:
    """One service class: a name and the queue-wait target that positions it
    in the EDF order. ``target_wait_s`` is the promise — interactive
    requests should start within ~this; batch requests tolerate this much
    delay but are guaranteed to start once it elapses (their virtual
    deadline becomes the earliest in the queue).

    The optional SLO-objective fields declare what the class
    PROMISES externally — "``slo_objective`` of requests see TTFT within
    ``ttft_slo_s`` / per-token latency within ``tpot_slo_s``" — and seed
    the frontend's burn-rate monitor (observability/slo.py). None disables
    that objective for the class; the deadline-miss objective always
    exists."""

    __slots__ = ("name", "target_wait_s", "ttft_slo_s", "tpot_slo_s",
                 "slo_objective")

    def __init__(self, name, target_wait_s, ttft_slo_s=None, tpot_slo_s=None,
                 slo_objective=0.99):
        self.name = str(name)
        self.target_wait_s = float(target_wait_s)
        self.ttft_slo_s = float(ttft_slo_s) if ttft_slo_s else None
        self.tpot_slo_s = float(tpot_slo_s) if tpot_slo_s else None
        self.slo_objective = float(slo_objective)

    def __repr__(self):
        return f"SLOClass({self.name!r}, target_wait_s={self.target_wait_s})"


INTERACTIVE = SLOClass("interactive", target_wait_s=0.05,
                       ttft_slo_s=1.0, tpot_slo_s=0.25)
BATCH = SLOClass("batch", target_wait_s=2.0,
                 ttft_slo_s=30.0, tpot_slo_s=1.0, slo_objective=0.95)


class SLOScheduler:
    def __init__(self, max_queue_depth=256, interactive_reserve=0.1,
                 classes=(INTERACTIVE, BATCH)):
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        self.max_queue_depth = int(max_queue_depth)
        #: fraction of the queue only sub-target classes (interactive) may
        #: use; batch submissions shed once depth reaches (1-reserve)*max
        self.interactive_reserve = float(interactive_reserve)
        self.classes = {c.name: c for c in classes}
        # the lowest-target class is the one the reserve protects
        self._reserve_class = min(self.classes.values(),
                                  key=lambda c: c.target_wait_s).name

    @property
    def reserve_class(self):
        """Name of the class the admission reserve (and the brownout
        ladder's shed_batch rung) protects — the lowest-target class."""
        return self._reserve_class

    def resolve(self, slo_class):
        """Name or SLOClass -> SLOClass (unknown names raise)."""
        if isinstance(slo_class, SLOClass):
            return slo_class
        try:
            return self.classes[slo_class]
        except KeyError:
            raise ValueError(
                f"unknown slo_class {slo_class!r}; have "
                f"{sorted(self.classes)}") from None

    # ---- admission ---------------------------------------------------------
    def check_admission(self, queued_count, slo):
        """Raise Overloaded instead of queueing past the bound. The caller
        holds its queue lock around check+enqueue so the depth can't race."""
        limit = self.max_queue_depth
        if slo.name != self._reserve_class:
            limit = int(limit * (1.0 - self.interactive_reserve))
        if queued_count >= limit:
            raise Overloaded(
                f"queue depth {queued_count} >= {limit} for SLO class "
                f"{slo.name!r} (max_queue_depth={self.max_queue_depth})",
                step="queue", slo_class=slo.name)

    # ---- ordering ----------------------------------------------------------
    @staticmethod
    def virtual_deadline(t_enqueue, slo, deadline_s=None):
        """Absolute EDF key: enqueue + the tighter of the class target and
        the caller's deadline."""
        vd = t_enqueue + slo.target_wait_s
        if deadline_s is not None:
            vd = min(vd, t_enqueue + float(deadline_s))
        return vd

    @staticmethod
    def expired(entry, now=None):
        """True when the USER deadline (not the class target) has passed
        before the request started running."""
        if entry.deadline_t is None:
            return False
        return (now if now is not None else time.monotonic()) > entry.deadline_t

    @staticmethod
    def pick(pending, now=None):
        """Index of the next entry to admit from ``pending`` (any indexable
        of objects with ``.virtual_deadline``), or None when empty. O(n)
        scan — pending lists are bounded by max_queue_depth, and an O(n)
        min beats a heap's churn under the re-queue/reroute paths."""
        if not pending:
            return None
        best, best_vd = None, None
        for i, e in enumerate(pending):
            vd = e.virtual_deadline
            if best_vd is None or vd < best_vd:
                best, best_vd = i, vd
        return best
