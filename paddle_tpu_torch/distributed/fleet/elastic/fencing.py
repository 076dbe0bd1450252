"""Generation fencing (the port's own copy of
``paddle_tpu/distributed/fleet/elastic/fencing.py``).

When a launcher re-forms an elastic job it bumps the generation counter in
its rendezvous store (``__elastic_gen__``) before it deploys the new
incarnation. A straggler of the old generation (a rank wedged in a
collective, an emergency-flush thread racing teardown) must not write
state that the live generation will then trust: it belongs to a membership
that no longer exists.

A write that must be fenced calls :func:`assert_writable` first. The check
is a no-op outside elastic launches (``PADDLE_ELASTIC_GENERATION`` unset)
and fails open when the store cannot be read: fencing defends against
split-brain writes; it is not a new availability dependency. The port's
process fence compares against the generation its environment names; the
rendezvous store that a re-forming launcher bumps comes with the launcher
(ROADMAP.md, §1 item 7), and :class:`GenerationFence` takes any store
object with ``check(key)`` and ``get(key)`` meanwhile.
"""
import threading

from ....observability.metrics import registry as _registry
from ....utils.metrics_bus import counters
from .membership import GENERATION_ENV
from .membership import generation as _membership_generation
from ....utils.envs import env_str

__all__ = ["StaleGenerationError", "GenerationFence", "GEN_STORE_KEY",
           "process_fence", "assert_writable"]

#: rendezvous-store key holding the newest generation (launcher-owned)
GEN_STORE_KEY = "__elastic_gen__"


class StaleGenerationError(RuntimeError):
    """This process belongs to a superseded elastic generation; the write
    it attempted was refused. The only correct reaction is to exit: the
    job has re-formed without this rank."""


class GenerationFence:
    """Compare our generation against the newest one the store has seen.

    ``check()`` raises :class:`StaleGenerationError` when the store holds a
    newer generation; an unreadable store fails open.
    """

    def __init__(self, store=None, generation=None):
        self.store = store
        self.generation = int(generation) if generation is not None \
            else _membership_generation()

    def newest_generation(self):
        """The newest generation visible: max(ours, the store's)."""
        newest = self.generation
        if self.store is not None:
            try:
                if self.store.check(GEN_STORE_KEY):
                    raw = self.store.get(GEN_STORE_KEY)
                    newest = max(newest, int(
                        raw.decode() if isinstance(raw, bytes) else raw))
            except Exception:
                counters.bump("fault.elastic.fence_check_failed")
        return newest

    def check(self, op="write"):
        newest = self.newest_generation()
        if newest > self.generation:
            counters.bump("fault.elastic.fenced_write")
            _registry.counter("elastic.fenced_writes").inc()
            raise StaleGenerationError(
                f"{op}: this process is elastic generation "
                f"{self.generation} but the job has re-formed at generation "
                f"{newest} — a superseded incarnation must not write "
                f"checkpoints; exiting is the only correct reaction")
        return True


# process-wide fence, resolved once (None = not yet resolved, False = not
# an elastic launch: a permanent no-op)
_process_fence = None
_fence_lock = threading.Lock()


def process_fence():
    """The environment's fence for this process: its generation from
    ``PADDLE_ELASTIC_GENERATION``. Returns False outside elastic
    launches."""
    global _process_fence
    f = _process_fence
    if f is not None:
        return f
    with _fence_lock:
        if _process_fence is not None:
            return _process_fence
        if not env_str(GENERATION_ENV):
            _process_fence = False
            return False
        _process_fence = GenerationFence(
            store=None, generation=_membership_generation())
        return _process_fence


def assert_writable(op="ckpt.write"):
    """The write gate: raises StaleGenerationError for a superseded
    generation, free outside elastic launches."""
    f = process_fence()
    if f is not False:
        f.check(op)


def _reset():
    """Test hook: forget the cached fence so env changes take effect."""
    global _process_fence
    _process_fence = None
