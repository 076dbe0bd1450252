"""Elastic membership, generation fencing and preemption handling of the
port (counterpart of ``paddle_tpu/distributed/fleet/elastic``).

- ``membership``: who is in the job right now (rank, world size,
  generation, live ranks) and the per-rank batch that keeps the global
  batch constant across re-forms;
- ``fencing``: :class:`GenerationFence`, the write gate a superseded
  incarnation fails (the serving supervisor's replica fences follow the
  same contract);
- :class:`GracefulPreemption`: SIGTERM as a preemption notice.

``ElasticManager`` (store leases) and ``autoresume`` stand on the
launcher's rendezvous store, which comes with the launcher (ROADMAP.md,
§1 item 7).
"""
import signal
import sys
import threading

from ....utils.metrics_bus import counters
from . import fencing, membership  # noqa: F401  (public submodules)
from .fencing import (  # noqa: F401
    GenerationFence, StaleGenerationError, assert_writable, process_fence,
)
from .membership import (  # noqa: F401
    generation as current_generation, live_ranks, scaled_per_rank_batch,
)

__all__ = ["membership", "fencing", "GenerationFence",
           "StaleGenerationError", "assert_writable", "process_fence",
           "current_generation", "live_ranks", "scaled_per_rank_batch",
           "GracefulPreemption", "PREEMPTED_EXIT_CODE"]

#: exit code of a trainer that received SIGTERM (preemption notice),
#: checkpointed and left cleanly: 128 + SIGTERM, what the process would
#: report had it not handled the signal, so outside supervisors classify
#: it the same way
PREEMPTED_EXIT_CODE = 143


class GracefulPreemption:
    """SIGTERM as a preemption notice (preemptible capacity sends SIGTERM,
    grants a grace window, then SIGKILLs). The handler only sets a flag; no
    checkpoint I/O runs in signal context. The training loop exits at its
    next checkpoint boundary through :meth:`exit_if_requested`, so the
    saved state is always a whole step."""

    def __init__(self):
        self._flag = threading.Event()
        self._prev = None

    def install(self, signals=(signal.SIGTERM,)):
        try:
            self._prev = [(s, signal.signal(s, self._on_signal))
                          for s in signals]
        except ValueError:
            # not the main thread: preemption handling is then the
            # embedder's job
            self._prev = None
        return self

    def uninstall(self):
        """Restore the previous handlers: an embedder (a test runner, a
        notebook) gets its own SIGTERM semantics back after training."""
        if self._prev:
            try:
                for s, h in self._prev:
                    signal.signal(s, h)
            except ValueError:
                pass
            self._prev = None

    def _on_signal(self, signum, frame):
        self._flag.set()

    @property
    def requested(self):
        return self._flag.is_set()

    def exit_if_requested(self, exit_code=PREEMPTED_EXIT_CODE):
        """Call right after a checkpoint commit: exits the process with the
        preemption code when SIGTERM arrived, so a launcher restarts it to
        resume."""
        if not self._flag.is_set():
            return
        counters.bump("fault.preempted_exit")
        sys.exit(exit_code)
