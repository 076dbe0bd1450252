"""Hang watchdog (the port's own copy of
``paddle_tpu/observability/watchdog.py``): turn "the job is stuck" into a
diagnosis.

Two halves, meeting in a shared telemetry directory
(``PADDLE_TELEMETRY_DIR``):

- **Heartbeat** (the worker's side): ``beat(step)`` atomically rewrites
  ``heartbeat.<rank>.json`` (rank, pid, step, wall time, generation) once
  per step; ``TrainStep`` calls :func:`maybe_beat`, a cached no-op when the
  variable is unset, and serving replicas beat under ``<dir>/serving``.
  Construction also registers a SIGUSR1 faulthandler that dumps every
  thread's stack to ``stacks.<rank>.txt``: faulthandler's C-level handler
  fires even when the Python main thread is wedged in a blocking call,
  which is the hang case.

- **HangWatchdog** (a monitor thread): polls the heartbeat files; when a
  rank's beat is staler than ``deadline_s`` it (1) asks every rank's pid
  for a fresh stack dump (SIGUSR1), (2) collects each rank's stack file,
  the tail of its span JSONL and its in-flight compile breadcrumb, and (3)
  commits one ``hang_report.json`` and a ``hang`` flight-record bundle.
  Diagnostic mode fires at most once; with ``signal_stalled`` set it also
  sends that signal to the stalled ranks, SIGKILLs any still alive after
  ``kill_grace_s`` and re-arms.

A heartbeat whose pid is this process's own (a serving replica beating
from a dispatcher thread, a watchdog watching its own trainer) is never
sent SIGUSR1: where no faulthandler hook is registered the signal's
default action ends the process. The watchdog writes this process's
stacks into that rank's stack file itself (``faulthandler.dump_traceback``
of every thread), which is what the signal would have produced.
"""
import json
import os
import re
import signal
import threading
import time

from ..utils.envs import env_int, env_str

__all__ = ["Heartbeat", "HangWatchdog", "maybe_beat", "heartbeat_path",
           "stacks_path", "spans_path", "REPORT_NAME", "DIR_ENV",
           "DEADLINE_ENV"]

DIR_ENV = "PADDLE_TELEMETRY_DIR"
DEADLINE_ENV = "PADDLE_HANG_DEADLINE_S"
REPORT_NAME = "hang_report.json"

_HB_RE = re.compile(r"^heartbeat\.(\d+)\.json$")


def _pid_alive(pid):
    try:
        os.kill(int(pid), 0)
        return True
    except ProcessLookupError:
        return False
    except (PermissionError, OSError, ValueError, OverflowError):
        return True  # can't prove it's dead: keep treating it as live


def heartbeat_path(d, rank):
    return os.path.join(d, f"heartbeat.{rank}.json")


def stacks_path(d, rank):
    return os.path.join(d, f"stacks.{rank}.txt")


def spans_path(d, rank):
    return os.path.join(d, f"spans.{rank}.jsonl")


class Heartbeat:
    """Per-rank liveness file + SIGUSR1 stack-dump hook."""

    def __init__(self, directory, rank, install_faulthandler=True):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.rank = int(rank)
        self.generation = env_int("PADDLE_ELASTIC_GENERATION", 0)
        self.path = heartbeat_path(directory, self.rank)
        self._stack_f = None
        if install_faulthandler and hasattr(signal, "SIGUSR1"):
            import faulthandler

            try:
                # keep the handle open for the process lifetime: faulthandler
                # writes to the raw fd from a signal context, repeated dumps
                # append — the watchdog reads the accumulated file
                self._stack_f = open(stacks_path(directory, self.rank), "w")
                faulthandler.register(signal.SIGUSR1, file=self._stack_f,
                                      all_threads=True)
            except (ValueError, OSError, RuntimeError):
                # non-main thread / exotic platform: liveness still works,
                # only the stack dump is lost
                if self._stack_f is not None:
                    self._stack_f.close()
                    self._stack_f = None
        self.beat(step=None, phase="init")

    def beat(self, step=None, **extra):
        """Atomic heartbeat write (tmp + rename): the watchdog never reads a
        torn json. Each beat is stamped with the elastic generation so a
        re-formed job's watchdog can fence out old-incarnation stragglers."""
        rec = {"rank": self.rank, "pid": os.getpid(), "step": step,
               "time": time.time(), "generation": self.generation}
        if extra:
            rec.update(extra)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)

    def close(self):
        if self._stack_f is not None:
            import faulthandler

            try:
                faulthandler.unregister(signal.SIGUSR1)
            except Exception:
                pass
            try:
                self._stack_f.close()
            except Exception:
                pass
            self._stack_f = None


#: cached process heartbeat: False = env unset (permanent no-op),
#: None = not yet resolved, Heartbeat = beating
_process_hb = None
_last_beat_t = 0.0
#: liveness granularity: sub-second step loops don't need sub-second
#: heartbeat writes (deadlines are seconds); throttling caps the hot-loop
#: file I/O at ~2 writes/s no matter how fast steps are
BEAT_INTERVAL_S = 0.5


def _env_heartbeat():
    """Resolve (once) the process heartbeat from PADDLE_TELEMETRY_DIR."""
    global _process_hb
    hb = _process_hb
    if hb is not None:
        return hb
    d = env_str(DIR_ENV)
    if not d:
        _process_hb = False
        return False
    rank = env_str("PADDLE_TRAINER_ID", env_str("RANK", "0")) or "0"
    try:
        hb = _process_hb = Heartbeat(d, int(rank))
    except (OSError, ValueError):
        hb = _process_hb = False
    return hb


def arm_from_env():
    """Register this process with the watchdog BEFORE the first step: writes
    the phase='init' beat (step=None), which the watchdog holds to the
    longer startup deadline, so a rank that wedges in its set-up, its
    first kernel build or its first step still gets diagnosed instead of
    never appearing in the heartbeat directory at all. Called from
    TrainStep construction; free when telemetry is not configured."""
    _env_heartbeat()


def note_phase(phase):
    """Stamp a step=None phase beat before known LONG blocking host work
    (synchronous checkpoint save, resume load): the watchdog holds step-less
    beats to the startup deadline, so a legitimate 90s save can't read as a
    hang and burn the fire-once report. The next maybe_beat restores normal
    step-deadline monitoring. Bypasses the beat throttle (rare calls)."""
    hb = _env_heartbeat()
    if hb is False:
        return
    try:
        hb.beat(step=None, phase=phase)
    except OSError:
        pass


def maybe_beat(step=None):
    """The train-loop hook: one cached env check when telemetry is not
    configured; at most ~2 small atomic file writes per second when it is.
    Fleet snapshot publication piggybacks on the same cadence:
    inside the throttled block, so the disabled path stays one check."""
    global _last_beat_t
    hb = _env_heartbeat()
    if hb is False:
        return
    now = time.monotonic()
    if now - _last_beat_t < BEAT_INTERVAL_S:
        return
    _last_beat_t = now
    try:
        hb.beat(step=step)
    except OSError:
        pass  # a full disk must not kill the training step
    from . import fleet

    fleet.maybe_publish(step)


def _reset_process_heartbeat():
    """Test hook: forget the cached heartbeat so env changes take effect."""
    global _process_hb, _last_beat_t
    if isinstance(_process_hb, Heartbeat):
        _process_hb.close()
    _process_hb = None
    _last_beat_t = 0.0
    from . import fleet

    fleet._reset_process_publisher()


class HangWatchdog:
    """Monitor thread over a telemetry directory's heartbeat files."""

    def __init__(self, directory, deadline_s, interval_s=None, on_hang=None,
                 last_n_spans=32, signal_grace_s=0.75,
                 startup_deadline_s=None, signal_stalled=None,
                 kill_grace_s=30.0, generation=0):
        self.dir = directory
        self.deadline_s = float(deadline_s)
        # elastic generation fencing: a launcher bumps this on
        # every shrink/grow re-form; heartbeats stamped by an OLDER
        # generation are invisible — a straggler from a dead incarnation
        # must not read as a live (or hung) rank of the new world
        self.generation = int(generation)
        # ranks that have only init-beaten (step=None: still in set-up or
        # a first kernel build) get a longer leash: first dispatches
        # legitimately take many times a steady-state step
        self.startup_deadline_s = (float(startup_deadline_s)
                                   if startup_deadline_s is not None
                                   else 10.0 * self.deadline_s)
        self.interval_s = interval_s if interval_s is not None else max(
            0.2, self.deadline_s / 4.0)
        self.on_hang = on_hang
        self.last_n_spans = int(last_n_spans)
        self.signal_grace_s = float(signal_grace_s)
        # optional escalation AFTER the diagnosis is safely committed: send
        # this signal (typically SIGTERM) to each STALLED rank, so its
        # GracefulPreemption handler exits it at the next checkpoint
        # boundary. A rank wedged too hard to reach one consumes no flag,
        # so after kill_grace_s a still-alive stalled pid is SIGKILLed.
        self.signal_stalled = signal_stalled
        self.kill_grace_s = float(kill_grace_s)
        self.report_path = os.path.join(directory, REPORT_NAME)
        self.fired = threading.Event()
        self._stop = threading.Event()
        self._thread = None
        # staleness is measured from max(last beat, OUR start): a heartbeat
        # left over from a previous incarnation of the job (reused log_dir)
        # must not fire the first scan — it only counts as stalled once a
        # full deadline has elapsed on THIS watchdog's watch without a fresh
        # beat.
        self._start_time = time.time()

    # ---- lifecycle --------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="paddle-hang-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self):
        while not self._stop.is_set():
            try:
                if self.scan_once():
                    if self.signal_stalled is None:
                        return  # diagnostic mode: fire once, the report IS
                        # the product
                    # escalation mode keeps watching: the preempted/killed
                    # ranks restart and may hang AGAIN — re-arm with a fresh
                    # leash (restarted ranks get the full startup deadline;
                    # the launcher deleted their heartbeats on restart). The
                    # leash starts AFTER the kill grace window, so a rank
                    # still dying under SIGTERM→SIGKILL is not re-diagnosed,
                    # re-signaled, and re-reaped every deadline tick.
                    self._start_time = time.time() + self.kill_grace_s
            except Exception:
                pass  # a watchdog crash must never take the launcher down
            self._stop.wait(self.interval_s)

    # ---- scanning ---------------------------------------------------------
    def _read_heartbeats(self):
        hbs = {}
        try:
            names = os.listdir(self.dir)
        except OSError:
            return hbs
        for name in names:
            m = _HB_RE.match(name)
            if not m:
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    hb = json.load(f)
            except (OSError, ValueError):
                continue  # racing a writer: next tick sees it
            if int(hb.get("generation", self.generation)) < self.generation:
                continue  # old-generation straggler: fenced out
            hbs[int(m.group(1))] = hb
        return hbs

    def scan_once(self):
        """One poll; returns the report path if a hang was diagnosed."""
        hbs = self._read_heartbeats()
        if not hbs:
            return None
        now = time.time()
        stalled = {}
        for r, hb in hbs.items():
            limit = (self.startup_deadline_s if hb.get("step") is None
                     else self.deadline_s)
            stale = now - max(hb.get("time", 0), self._start_time)
            if stale <= limit:
                continue
            # a silent heartbeat with a DEAD pid is an exited rank, not a
            # hang (clean early finishers, crashes the launcher already
            # handles) — firing on it would burn the one report
            pid = hb.get("pid")
            if pid and not _pid_alive(pid):
                continue
            stalled[r] = stale
        if not stalled:
            return None
        self._dump(hbs, stalled)
        return self.report_path

    def _dump(self, hbs, stalled):
        # fresh stacks from EVERY rank — the straggler's peers show what the
        # collective was waiting on
        me = os.getpid()
        for r, hb in hbs.items():
            pid = hb.get("pid")
            if pid == me:
                # never signal ourselves: without a faulthandler hook
                # SIGUSR1's default action ends this process
                self._dump_own_stacks(r)
            elif pid and hasattr(signal, "SIGUSR1"):
                try:
                    os.kill(pid, signal.SIGUSR1)
                except (ProcessLookupError, PermissionError, OSError):
                    pass  # dead rank: its last heartbeat tells the story
        time.sleep(self.signal_grace_s)
        now = time.time()
        ranks = {}
        for r, hb in sorted(hbs.items()):
            ranks[str(r)] = {
                "heartbeat": hb,
                "stale_s": now - hb.get("time", 0),
                "stalled": r in stalled,
                "stacks": self._read_text(stacks_path(self.dir, r)),
                "last_spans": self._tail_spans(spans_path(self.dir, r)),
            }
            # mid-compile diagnosis: the compile ledger writes a
            # compiling.<rank>.json breadcrumb while a compile (a kernel
            # build, a first dispatch) is in flight: a rank wedged in nvcc
            # shows the library and the elapsed time instead of an opaque
            # native stack
            comp = self._read_compiling(r, now)
            if comp is not None:
                ranks[str(r)]["compiling"] = comp
        report = {
            "detected_at": now,
            "deadline_s": self.deadline_s,
            "generation": self.generation,
            "stalled_ranks": sorted(stalled),
            "stalled_for_s": {str(r): s for r, s in stalled.items()},
            "ranks": ranks,
        }
        tmp = self.report_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=2)
        os.replace(tmp, self.report_path)
        from .metrics import registry

        registry.counter("fault.watchdog.hang").inc()
        # flight-record the hang: the bundle carries what the
        # full report cannot — THIS process's dynamics window, span ring
        # and compile tail — committed into the watched telemetry dir
        from . import flightrec

        flightrec.record(
            "hang", payload={"stalled_ranks": sorted(stalled),
                             "stalled_for_s": {str(r): round(s, 3)
                                               for r, s in stalled.items()},
                             "report": self.report_path},
            directory=self.dir)
        if self.signal_stalled is not None:
            pids = []
            for r in stalled:
                pid = hbs.get(r, {}).get("pid")
                if not pid:
                    continue
                try:
                    os.kill(pid, self.signal_stalled)
                    registry.counter("fault.watchdog.preempt").inc()
                    pids.append(pid)
                except (ProcessLookupError, PermissionError, OSError):
                    pass
            if pids:
                # escalation backstop for ranks too wedged to honor the
                # preemption flag: still alive after the grace window →
                # SIGKILL, so the launcher's restart + recovery ladder take
                # over instead of the job staying hung forever
                def _reap(pids=pids):
                    time.sleep(self.kill_grace_s)
                    for pid in pids:
                        if _pid_alive(pid):
                            try:
                                os.kill(pid, signal.SIGKILL)
                                registry.counter(
                                    "fault.watchdog.killed").inc()
                            except (ProcessLookupError, PermissionError,
                                    OSError):
                                pass

                threading.Thread(target=_reap, daemon=True,
                                 name="paddle-hang-reaper").start()
        self.fired.set()
        if self.on_hang is not None:
            try:
                self.on_hang(self.report_path)
            except Exception:
                pass

    def _dump_own_stacks(self, rank):
        """Append this process's thread stacks to ``rank``'s stack file."""
        import faulthandler

        try:
            with open(stacks_path(self.dir, rank), "a") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
        except (OSError, ValueError, RuntimeError):
            pass

    def _read_compiling(self, rank, now):
        """The rank's in-flight-compile breadcrumb, with elapsed times
        stamped by the reader; None when no compile is in flight."""
        from .compilemem import compiling_path

        try:
            with open(compiling_path(self.dir, rank)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return None
        for a in rec.get("active", []):
            if "started_at" in a:
                a["elapsed_s"] = round(now - a["started_at"], 3)
        return rec

    @staticmethod
    def _read_text(path, limit=1 << 20):
        try:
            with open(path, errors="replace") as f:
                return f.read(limit) or None
        except OSError:
            return None

    def _tail_spans(self, path):
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - (1 << 18)))
                lines = f.read().decode(errors="replace").splitlines()
        except OSError:
            return []
        out = []
        for line in lines[-self.last_n_spans:]:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
        return out
