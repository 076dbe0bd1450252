"""Port parity: the operator plane's observability against the JAX
package's, on the CPU. Each module here is the port's own copy of the
reference's; the same planted files and scripted calls, on a frozen clock
where the module reads one, go through both and the results must be equal
(bookkeeping, no rounding of its own):

- ``HangWatchdog`` reports over planted heartbeat files: the generation
  filter, the startup deadline of a step-less beat, a dead pid skipped, a
  fresh rank not stalled, the ``compiling`` breadcrumb entry; the port
  never signals its own pid (an in-process replica's dump leaves the
  process running and writes its stacks); the heartbeat hooks
  (``arm_from_env``, ``note_phase``, ``maybe_beat``);
- the compile ledger's breadcrumb while ``ops/_build.py::build`` runs a
  (stand-in) ``nvcc``: it names the library, and is gone after;
- ``FlightRecorder`` bundles: dedup, the per-trigger rate limit, the cap,
  ``force``; the capture registry's arm, tick, stop, manual, disarm and
  refuse states over a stub backend; the port's real ``torch.profiler``
  backend, and its refusal while another profiler runs;
- ``SnapshotPublisher``/``FleetAggregator`` over the same snapshot files:
  members, quorum, phase skew, straggler verdicts over rounds, the
  generation fence, the serving view, the merged exposition, the advisory;
  ``bench_block`` over the same directory;
- ``StatusServer`` over HTTP on ``127.0.0.1:0``: the same routes, codes
  and keys as the reference's (``/memz`` without the per-program analysis,
  documented), ``/healthz`` and ``/statusz`` over one stub frontend,
  ``/profilez`` arming and disarming.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from paddle_tpu.observability import fleet as ref_fleet
from paddle_tpu.observability import flightrec as ref_flightrec
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.observability import statusz as ref_statusz
from paddle_tpu.observability import watchdog as ref_watchdog
from paddle_tpu_torch.observability import compilemem as port_compilemem
from paddle_tpu_torch.observability import fleet as port_fleet
from paddle_tpu_torch.observability import flightrec as port_flightrec
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch.observability import statusz as port_statusz
from paddle_tpu_torch.observability import watchdog as port_watchdog
from paddle_tpu_torch.ops import _build

T0 = 1_800_000_000.0


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("PADDLE_TELEMETRY_DIR", raising=False)
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    for wd in (ref_watchdog, port_watchdog):
        wd._reset_process_heartbeat()
    yield
    for wd in (ref_watchdog, port_watchdog):
        wd._reset_process_heartbeat()
    for fr in (ref_flightrec, port_flightrec):
        fr._reset()


@pytest.fixture
def frozen(monkeypatch):
    """time.time and time.monotonic frozen at values the test steps."""
    clock = {"wall": T0, "mono": 5000.0}
    monkeypatch.setattr(time, "time", lambda: clock["wall"])
    monkeypatch.setattr(time, "monotonic", lambda: clock["mono"])
    return clock


@pytest.fixture(scope="module")
def sleeper():
    """A live pid that ignores SIGUSR1 (the watchdog signals every rank)."""
    p = subprocess.Popen(
        [sys.executable, "-c",
         "import signal, time\n"
         "signal.signal(signal.SIGUSR1, signal.SIG_IGN)\n"
         "print('ready', flush=True)\n"
         "time.sleep(120)\n"], stdout=subprocess.PIPE, text=True)
    assert p.stdout.readline().strip() == "ready"
    yield p.pid
    p.kill()
    p.wait()


def _dead_pid():
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


# ---------------------------------------------------------------------------
# the hang watchdog
# ---------------------------------------------------------------------------
def _plant(d, live_pid, dead_pid):
    os.makedirs(d, exist_ok=True)
    beats = {
        0: {"pid": live_pid, "step": 40, "time": T0 - 1.0, "generation": 2},
        1: {"pid": live_pid, "step": 38, "time": T0 - 30.0,
            "generation": 2},                          # stalled
        2: {"pid": dead_pid, "step": 12, "time": T0 - 90.0,
            "generation": 2},                          # exited, skipped
        3: {"pid": live_pid, "step": None, "time": T0 - 30.0,
            "generation": 2, "phase": "init"},         # startup leash
        4: {"pid": live_pid, "step": 1, "time": T0 - 500.0,
            "generation": 1},                          # old generation
    }
    for r, hb in beats.items():
        with open(os.path.join(d, f"heartbeat.{r}.json"), "w") as f:
            json.dump(dict(hb, rank=r), f)
    with open(os.path.join(d, "compiling.1.json"), "w") as f:
        json.dump({"rank": "1", "pid": live_pid, "active": [
            {"key": "build.paged_attention", "started_at": T0 - 25.0,
             "library": "libpaged_attention-0123.so", "tid": 7}]}, f)
    with open(os.path.join(d, "spans.1.jsonl"), "w") as f:
        for i in range(40):
            f.write(json.dumps({"name": f"s{i}", "dur_s": i}) + "\n")
        f.write("torn")


def test_watchdog_report_matches_the_reference(tmp_path, frozen, sleeper):
    reports = []
    for wd_mod in (ref_watchdog, port_watchdog):
        d = str(tmp_path / wd_mod.__name__)
        _plant(d, sleeper, _dead_pid())
        frozen["wall"] = T0 - 100.0              # the watchdog starts
        wd = wd_mod.HangWatchdog(d, deadline_s=10.0, signal_grace_s=0.0,
                                 generation=2, last_n_spans=8)
        frozen["wall"] = T0
        fired = []
        wd.on_hang = fired.append
        path = wd.scan_once()
        assert path == os.path.join(d, "hang_report.json") == fired[0]
        rep = json.load(open(path))
        for r in rep["ranks"].values():       # the planted pids differ
            r["heartbeat"].pop("pid")
        reports.append(rep)
        assert os.listdir(os.path.join(d, "flight")) == ["hang_n1.json"]
    assert reports[0] == reports[1]
    rep = reports[1]
    assert rep["stalled_ranks"] == [1]
    assert sorted(rep["ranks"]) == ["0", "1", "2", "3"]   # rank 4 fenced
    assert rep["ranks"]["1"]["compiling"]["active"][0]["elapsed_s"] == 25.0
    assert [s["name"] for s in rep["ranks"]["1"]["last_spans"]] == [
        f"s{i}" for i in range(33, 40)]


def test_watchdog_startup_deadline_and_fresh_start(tmp_path, frozen,
                                                   sleeper):
    for wd_mod in (ref_watchdog, port_watchdog):
        d = str(tmp_path / wd_mod.__name__)
        _plant(d, sleeper, _dead_pid())
        frozen["wall"] = T0
        # leftovers of a previous incarnation do not fire a fresh watch
        wd = wd_mod.HangWatchdog(d, deadline_s=10.0, signal_grace_s=0.0,
                                 generation=2)
        assert wd.scan_once() is None
        # past the startup leash (10x deadline) the init beat stalls too
        frozen["wall"] = T0 + 200.0
        rep = json.load(open(wd.scan_once()))
        assert rep["stalled_ranks"] == [0, 1, 3]


def test_port_watchdog_never_signals_its_own_pid(tmp_path, frozen):
    """An in-process replica's heartbeat (no faulthandler hook installed):
    the dump writes this process's stacks instead of sending SIGUSR1, whose
    default action would end the process."""
    d = str(tmp_path / "serving")
    hb = port_watchdog.Heartbeat(d, 0, install_faulthandler=False)
    hb.beat(step=None, role="serving")
    frozen["wall"] = T0 + 100.0
    wd = port_watchdog.HangWatchdog(d, deadline_s=1.0, startup_deadline_s=1.0,
                                    signal_grace_s=0.0)
    wd._start_time = T0
    handler = signal.getsignal(signal.SIGUSR1)
    rep = json.load(open(wd.scan_once()))
    assert signal.getsignal(signal.SIGUSR1) == handler
    assert rep["stalled_ranks"] == [0]
    assert "test_port_watchdog_never_signals_its_own_pid" in \
        rep["ranks"]["0"]["stacks"]


def test_heartbeat_hooks_match_the_reference(tmp_path, monkeypatch):
    recs = []
    for wd_mod in (ref_watchdog, port_watchdog):
        d = tmp_path / wd_mod.__name__
        monkeypatch.setenv("PADDLE_TELEMETRY_DIR", str(d))
        monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
        monkeypatch.setenv("PADDLE_ELASTIC_GENERATION", "5")
        wd_mod._reset_process_heartbeat()
        seen = []

        def read():
            rec = json.load(open(d / "heartbeat.3.json"))
            seen.append({k: v for k, v in rec.items()
                         if k not in ("time", "pid")})

        wd_mod.arm_from_env()
        read()
        wd_mod.note_phase("checkpoint.save")
        read()
        wd_mod.maybe_beat(7)
        read()
        wd_mod.maybe_beat(8)                  # throttled: no write
        read()
        wd_mod._last_beat_t = 0.0
        wd_mod.maybe_beat(9)
        read()
        assert (d / "stacks.3.txt").exists()
        assert (d / "fleetsnap.3.json").exists()
        wd_mod._reset_process_heartbeat()
        recs.append(seen)
    assert recs[0] == recs[1]
    assert [r["step"] for r in recs[1]] == [None, None, 7, 7, 9]


def test_build_breadcrumb_names_the_library(tmp_path, monkeypatch):
    """While ``nvcc`` runs, ``compiling.<rank>.json`` lists the build with
    its library; the stand-in compiler copies the breadcrumb it sees into
    its output, which becomes the library file."""
    d = tmp_path / "telemetry"
    monkeypatch.setenv("PADDLE_TELEMETRY_DIR", str(d))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ \"$1\" != \"-o\" ]; do shift; done\n"
        f"cat {d}/compiling.2.json > \"$2\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    port_compilemem.ledger.reset()
    built = _build.build(["paged_attention", "adamw"])
    for name, b in built.items():
        crumb = json.loads(open(b["path"]).read())
        assert crumb["rank"] == "2" and crumb["pid"] == os.getpid()
        libs = {a["key"]: a["library"] for a in crumb["active"]}
        assert libs[f"build.{name}"] == os.path.basename(b["path"])
    assert not (d / "compiling.2.json").exists()
    assert port_compilemem.ledger.active() == []


# ---------------------------------------------------------------------------
# the flight recorder and the capture registry
# ---------------------------------------------------------------------------
def test_flight_bundles_dedup_rate_limit_and_cap(tmp_path, frozen):
    runs = []
    for fr_mod, reg in ((ref_flightrec, ref_metrics.registry),
                        (port_flightrec, port_metrics.registry)):
        d = str(tmp_path / fr_mod.__name__)
        rec = fr_mod.FlightRecorder(directory=d, max_bundles=4,
                                    min_interval_s=10.0, capture_steps=0)
        b0 = int(getattr(reg.get("flightrec.bundles"), "value", 0) or 0)
        out = []

        def go(trigger, step=None, dt=0.0, force=False, payload=None):
            frozen["mono"] += dt
            p = rec.record(trigger, step=step, payload=payload, force=force)
            out.append(None if p is None else os.path.basename(p))

        go("nonfinite", 5, payload={"skips": 1})
        go("nonfinite", 6, 1.0)                # inside the window
        go("nonfinite", 5, 20.0)               # exact repeat: dedup
        go("nonfinite", 6)                     # past the window
        go("hang")                             # stepless: sequence name
        go("hang", dt=1.0)                     # rate limited
        go("hang", dt=11.0)                    # a second hang, own file
        go("slo page!")                        # sanitized, over the cap
        go("slo page!", force=True)            # force skips every bound
        st = rec.status()
        st.pop("dir")
        for c in st["committed"]:
            c["path"] = os.path.basename(c["path"])
        bundle = json.load(open(os.path.join(rec.dir, out[0])))
        runs.append((out, st, int(getattr(reg.get("flightrec.bundles"),
                                          "value", 0) or 0) - b0,
                     sorted(bundle), bundle["payload"], bundle["trigger"]))
    assert runs[0] == runs[1]
    assert runs[1][0] == ["nonfinite_5.json", None, None, "nonfinite_6.json",
                          "hang_n3.json", None, "hang_n4.json", None,
                          "slo-page-_n5.json"]


def test_module_record_needs_a_telemetry_dir(tmp_path, monkeypatch):
    for fr_mod in (ref_flightrec, port_flightrec):
        assert fr_mod.record("hang") is None
        monkeypatch.setenv("PADDLE_TELEMETRY_DIR", str(tmp_path / "t"))
        assert os.path.basename(fr_mod.record("hang")) == "hang_n1.json"
        assert fr_mod.report()[0]["committed"][0]["trigger"] == "hang"
        fr_mod._reset()
        monkeypatch.delenv("PADDLE_TELEMETRY_DIR")
        shutil.rmtree(tmp_path / "t")


def _public_status(status):
    drop = ("armed_at", "ended_at", "duration_s")
    act = status["active"]
    return {"active": None if act is None else {k: v for k, v in act.items()
                                                if k not in drop},
            "completed": [{k: v for k, v in c.items() if k not in drop}
                          for c in status["completed"]]}


def test_capture_registry_states_over_a_stub_backend(tmp_path, monkeypatch):
    runs = []
    for fr_mod in (ref_flightrec, port_flightrec):
        fr_mod._reset()
        calls = []
        fail = {"start": False}

        def start(log_dir, calls=calls, fail=fail):
            calls.append(("start", os.path.basename(log_dir)))
            if fail["start"]:
                raise OSError("profiler busy")

        monkeypatch.setattr(fr_mod, "_start_backend", start)
        monkeypatch.setattr(fr_mod, "_stop_backend",
                            lambda calls=calls: calls.append(("stop",)))
        t = []
        lg = str(tmp_path / "cap")
        t.append(fr_mod.arm_capture(0))
        t.append(fr_mod.arm_capture("x"))
        t.append(fr_mod.arm_capture(2, log_dir=lg)["armed"])
        t.append(fr_mod.arm_capture(1)["error"])
        fr_mod.maybe_capture_step(10)           # starts
        fr_mod.maybe_capture_step(11)           # 1 left
        t.append(_public_status(fr_mod.capture_status()))
        fr_mod.maybe_capture_step(12, n=4)      # a run_steps call: stops
        t.append(_public_status(fr_mod.capture_status()))
        fr_mod.start_capture(lg, trigger="api")
        fr_mod.maybe_capture_step(13)           # manual: untouched
        with pytest.raises(RuntimeError):
            fr_mod.start_capture(lg)
        fr_mod.stop_capture()
        with pytest.raises(RuntimeError):
            fr_mod.stop_capture()
        t.append(fr_mod.arm_capture(3, log_dir=lg)["armed"])
        t.append(fr_mod.disarm_capture())       # before it started
        t.append(fr_mod.disarm_capture())
        fail["start"] = True
        fr_mod.arm_capture(1, log_dir=lg, trigger="nonfinite")
        fr_mod.maybe_capture_step(20)           # the start fails: ledgered
        t.append(_public_status(fr_mod.capture_status()))
        runs.append((t, calls))
        fr_mod._reset()
    assert runs[0] == runs[1]
    last = runs[1][0][-1]["completed"]
    assert [c["trigger"] for c in last] == ["manual", "api", "nonfinite"]
    assert last[-1]["error"] == "OSError: profiler busy"


def test_port_capture_traces_with_torch_profiler(tmp_path):
    import torch

    port_flightrec._reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        refused = port_flightrec.arm_capture(1)
    assert "another torch.profiler session" in refused["error"]
    lg = str(tmp_path / "trace")
    assert port_flightrec.arm_capture(2, log_dir=lg)["armed"]
    x = torch.ones(64, 64)
    for step in range(3):
        torch.mm(x, x)
        port_flightrec.maybe_capture_step(step)
    done = port_flightrec.capture_status()["completed"]
    assert len(done) == 1 and "error" not in done[0]
    trace = json.load(open(os.path.join(lg, "trace.json")))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    # a capture that finds another profiler running when it starts is
    # refused through the registry, never nested
    assert port_flightrec.arm_capture(1, log_dir=lg)["armed"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        port_flightrec.maybe_capture_step(9)
    last = port_flightrec.capture_status()["completed"][-1]
    assert "another torch.profiler session" in last["error"]
    port_flightrec._reset()


# ---------------------------------------------------------------------------
# fleet snapshots and the aggregator
# ---------------------------------------------------------------------------
def _rank_snapshots(d, rounds, generation=2):
    """Planted rank snapshots (written by the reference's publisher from
    injected registries): rank 2 computes 3x slower; ranks 0 and 1 wait on
    it at the collective. ``rounds`` more steps each call."""
    for r in range(3):
        reg = ref_metrics.MetricsRegistry()
        cs = ref_fleet.CollectiveStats(registry=reg)
        h = reg.histogram("span.train.step.dispatch_s")
        compute = 0.03 if r == 2 else 0.01
        wait = 0.0 if r == 2 else 0.02
        for _ in range(8 * rounds):
            h.observe(compute + wait)
            cs.note("all_reduce", wait, 0.001)
        reg.counter("train.steps", help="steps").inc(8 * rounds)
        reg.histogram("serving.ttft_s", labels={"rank": "x"}).observe(0.05)
        pub = ref_fleet.SnapshotPublisher(
            d, rank=r, registry=reg, collectives_stats=cs,
            min_interval_s=0.0, generation=generation, world=4)
        pub.publish(step=8 * rounds)


def _replica_snapshots(d):
    for i, state in enumerate(("LIVE", "DEAD")):
        reg = ref_metrics.MetricsRegistry()
        reg.counter("serving.completed").inc(3 + i)
        reg.gauge("serving.replica.occupancy",
                  labels={"replica": f"replica{i}"}).set(0.5)
        pub = ref_fleet.SnapshotPublisher(
            os.path.join(d, "serving"), rank=i, role="replica",
            registry=reg, min_interval_s=0.0, generation=2,
            instance="host-abc-11",
            extra_provider=lambda i=i, state=state: {"replica": {
                "name": f"replica{i}", "state": state, "pending": i,
                "active": 1, "load": 0.25}})
        pub.publish()


def _strip(view):
    view = json.loads(json.dumps(view))
    view.pop("time", None)
    for m in view.get("members", {}).values():
        m.pop("age_s", None)
        m.pop("pid", None)
    for r in (view.get("serving") or {}).get("replicas", {}).values():
        r.pop("age_s", None)
    view["errors"] = [e.rsplit(":", 1)[-1] for e in view["errors"]]
    return view


def test_aggregator_views_match_over_rounds(tmp_path):
    d = str(tmp_path)
    aggs = [mod.FleetAggregator(d, window=4, registry=reg_mod
                                .MetricsRegistry(), stale_s=0)
            for mod, reg_mod in ((ref_fleet, ref_metrics),
                                 (port_fleet, port_metrics))]
    _replica_snapshots(d)
    # an old incarnation's straggler and a torn file
    with open(os.path.join(d, "fleetsnap.3.json"), "w") as f:
        json.dump({"kind": "fleet_snapshot", "version": 1, "rank": 3,
                   "generation": 1, "time": T0}, f)
    with open(os.path.join(d, "fleetsnap.4.json"), "w") as f:
        f.write("{torn")
    views = [[], []]
    for rnd in range(1, 5):
        _rank_snapshots(d, rnd)
        for agg, out in zip(aggs, views):
            out.append(_strip(agg.collect()))
    assert views[0] == views[1]
    last = views[1][-1]
    assert last["generation"] == 2 and last["fenced_out"] == 1
    assert last["quorum"] == {"expected_world": 4, "present": [0, 1, 2],
                              "missing": [3]}
    assert last["straggler"]["persistent"] == [2]
    assert last["straggler"]["ranks"]["2"]["verdict"] == "compute"
    assert last["straggler"]["ranks"]["0"]["verdict"] == "ok"
    assert sorted(last["serving"]["replicas"]) == ["0@host-abc-11",
                                                   "1@host-abc-11"]
    assert aggs[0].straggler_advisory() == aggs[1].straggler_advisory()
    assert "rank 2" in aggs[1].straggler_advisory()
    assert aggs[0].to_prometheus() == aggs[1].to_prometheus()
    assert 'rank="2"' in aggs[1].to_prometheus()
    refreshed = [_strip(a.view(refresh=True)) for a in aggs]
    assert refreshed[0] == refreshed[1]


def test_port_publisher_snapshots_merge_like_the_reference(tmp_path):
    """The same series published by either package's publisher give the
    same aggregated phases, stragglers, members and exposition."""
    views, texts = [], []
    for fleet_mod, reg_mod in ((ref_fleet, ref_metrics),
                               (port_fleet, port_metrics)):
        d = str(tmp_path / fleet_mod.__name__)
        for r in range(2):
            reg = reg_mod.MetricsRegistry()
            cs = fleet_mod.CollectiveStats(registry=reg)
            h = reg.histogram("span.train.step_s")
            for _ in range(8):
                h.observe(0.02 * (r + 1))
                cs.note("all_gather", 0.001, 0.002)
            fleet_mod.SnapshotPublisher(
                d, rank=r, registry=reg, collectives_stats=cs,
                min_interval_s=0.0, generation=0, world=2).publish(step=8)
        agg = ref_fleet.FleetAggregator(d, registry=ref_metrics
                                        .MetricsRegistry())
        v = _strip(agg.collect())
        views.append({k: v[k] for k in ("phases", "straggler", "quorum",
                                        "generation")})
        texts.append(agg.to_prometheus())
        snap = json.load(open(port_fleet.snapshot_path(d, 0)))
        assert snap["kind"] == "fleet_snapshot" and snap["version"] == 1
    assert views[0] == views[1]
    assert texts[0] == texts[1]


def test_bench_block_over_the_same_directory(tmp_path, monkeypatch):
    blocks = []
    for fleet_mod, reg_mod in ((ref_fleet, ref_metrics),
                               (port_fleet, port_metrics)):
        d = str(tmp_path / fleet_mod.__name__)
        _rank_snapshots(d, 2)
        monkeypatch.setenv("PADDLE_TELEMETRY_DIR", d)
        monkeypatch.setenv("PADDLE_TRAINER_ID", "9")
        monkeypatch.setenv("PADDLE_ELASTIC_GENERATION", "2")
        # this process's own snapshot carries an empty registry, so only
        # the planted ranks' series are merged
        monkeypatch.setattr(fleet_mod, "_registry", reg_mod.MetricsRegistry())
        blocks.append(fleet_mod.bench_block())
    assert blocks[0] == blocks[1]
    assert "error" not in blocks[1] and blocks[1]["snapshots"] == 4
    assert blocks[1]["stragglers"] == {"2": "compute"}
    monkeypatch.delenv("PADDLE_TELEMETRY_DIR")
    monkeypatch.delenv("PADDLE_ELASTIC_GENERATION")
    block = port_fleet.bench_block()          # a scratch directory
    assert "error" not in block and block["snapshots"] == 1


def test_collective_seam_splits_wait_and_body(monkeypatch):
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.testing import chaos

    stats = port_fleet.CollectiveStats(registry=port_metrics.MetricsRegistry())
    monkeypatch.setattr(port_fleet, "collectives", stats)
    with chaos.FaultPlan().fail("fleet.collective_wait", times=None) as plan:
        with pytest.raises(chaos.FaultInjected):
            with port_fleet.collective_seam("collective.all_reduce"):
                pass                          # disabled: only the seam
    assert plan.rules[0].fired == 1 and stats.export() == {}
    tracing.enable()
    try:
        with port_fleet.collective_seam("collective.all_reduce"):
            time.sleep(0.01)
    finally:
        tracing.disable()
    rec = stats.export()["all_reduce"]
    assert rec["count"] == 1 and rec["body_s"] >= 0.01


# ---------------------------------------------------------------------------
# the status server
# ---------------------------------------------------------------------------
class _StubRep:
    def __init__(self, name, state):
        self.name, self.state = name, state


class _StubFrontend:
    def __init__(self, states):
        self.replicas = [_StubRep(f"replica{i}", s)
                         for i, s in enumerate(states)]

    def serving_report(self):
        return {"replicas": {r.name: r.state for r in self.replicas}}

    def tenant_report(self):
        return {"default": {"inflight": 0}}


def _get(port, route):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=30) as r:
            return r.status, r.read().decode(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers["Content-Type"]


#: the port's /memz: the allocator's live and peak bytes where the
#: reference reports its per-program memory analysis (temp peaks)
MEMZ_PORT_ONLY = {"live_bytes", "peak_bytes"}
MEMZ_REF_ONLY = {"temp_peak_bytes", "top_programs_by_temp"}


@pytest.mark.parametrize("states", [("LIVE", "DEAD"), ("DEAD", "DEAD"),
                                    None])
def test_status_routes_over_http(tmp_path, states):
    d = str(tmp_path)
    _rank_snapshots(d, 1)
    servers = []
    for mod in (ref_statusz, port_statusz):
        fe = _StubFrontend(states) if states else None
        servers.append(mod.StatusServer(port=0, frontend=fe,
                                        telemetry_dir=d).start())
    try:
        assert servers[0].route_names() == servers[1].route_names()
        for route in servers[1].route_names() + ["/nope", "/"]:
            got = [_get(s.port, route) for s in servers]
            assert got[0][0] == got[1][0], route
            assert got[0][2] == got[1][2], route
            if got[1][2] != "application/json":
                continue
            keys = [set(json.loads(g[1])) for g in got]
            if route == "/memz":
                assert keys[1] - keys[0] == MEMZ_PORT_ONLY
                assert keys[0] - keys[1] == MEMZ_REF_ONLY
            else:
                assert keys[0] == keys[1], route
        health = [json.loads(_get(s.port, "/healthz")[1]) for s in servers]
        for h in health:
            h.pop("uptime_s")
        assert health[0] == health[1]
        code = _get(servers[1].port, "/healthz")[0]
        assert code == (503 if states == ("DEAD", "DEAD") else 200)
        nf = json.loads(_get(servers[1].port, "/nope")[1])
        assert nf["routes"] == servers[1].route_names()
        if states:
            sz = [json.loads(_get(s.port, "/statusz")[1])["serving"]
                  for s in servers]
            assert sz[0] == sz[1] == {"replicas": dict(
                (f"replica{i}", s) for i, s in enumerate(states))}
        fz = [json.loads(_get(s.port, "/fleetz")[1]) for s in servers]
        assert _strip(fz[0])["straggler"] == _strip(fz[1])["straggler"]
        code, text, ctype = _get(servers[1].port, "/varz")
        assert code == 200 and ctype == "text/plain; version=0.0.4"
        assert "# TYPE " in text
    finally:
        for s in servers:
            s.stop()


def test_profilez_arms_and_disarms_the_capture():
    srv = port_statusz.StatusServer(port=0).start()
    try:
        port_flightrec._reset()
        armed = json.loads(_get(srv.port, "/profilez?steps=3")[1])
        assert armed["armed"] and armed["capture"]["steps"] == 3
        assert armed["capture"]["trigger"] == "http"
        again = json.loads(_get(srv.port, "/profilez?steps=2")[1])
        assert again["error"] == "a capture is already armed or active"
        st = json.loads(_get(srv.port, "/profilez")[1])
        assert st["active"]["steps_left"] == 3
        assert json.loads(_get(srv.port, "/profilez?disarm=1")[1]) == {
            "disarmed": True}
        assert json.loads(_get(srv.port, "/profilez")[1])["active"] is None
    finally:
        srv.stop()
        port_flightrec._reset()
