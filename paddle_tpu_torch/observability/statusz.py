"""Live introspection HTTP endpoint (the port's own copy of
``paddle_tpu/observability/statusz.py``): stdlib ``http.server`` only,
served from the serving frontend (``ServingFrontend(statusz_port=...)``)
or started around any process that publishes into the telemetry registry.

Routes (GET only):

- ``/statusz``: JSON overview: process facts, uptime, telemetry state,
  the training and serving goodput splits, and the frontend's
  ``serving_report()`` (replica health, per-class latency, SLO burn,
  the supervisor) when one is attached.
- ``/varz``: the metrics registry in the Prometheus text exposition
  format (``text/plain; version=0.0.4``).
- ``/tracez``: recent request traces, the slowest N and the errored N.
- ``/compilez``: the compile ledger: per-key compile counts and wall
  (kernel builds, program families' first dispatches), churn, compiles
  in flight.
- ``/memz``: the device-memory ledger: components (the KV page pools)
  against the card's capacity, the allocator's live and peak bytes, the
  programs' cost rows. The reference's per-program memory analysis needs
  a captured graph and is not part of it.
- ``/fleetz``: the fleet view: merged per-rank and per-replica
  snapshots, members, quorum, phase skew, stragglers, the serving rollup
  (``?refresh=1`` forces a fresh merge).
- ``/dynamicsz``: training dynamics and the flight recorder's bundles.
- ``/profilez``: the on-demand ``torch.profiler`` capture: ``?steps=K``
  arms a capture of the next K train steps through the flight recorder's
  capture registry, ``?disarm=1`` cancels it; a bare GET returns the
  capture's state and history.
- ``/perfz``: the device-time plane (devprof): per-program device
  seconds, MFU, roofline verdicts (``?program=<key-prefix>`` filters).
- ``/kvz``: the cluster KV fabric; ``/tenantz``: tenants and adapters.
- ``/healthz``: liveness: 200 with per-replica states and heartbeat
  ages, 503 when nothing can serve (no LIVE replica) or every heartbeat
  is stale.

Dispatch is table-driven (``self.routes``): the 404 body's route listing
derives from the same dict. The server binds 127.0.0.1 by default
(introspection is an operator surface, not a public one) and ``port=0``
picks a free port. Every payload comes from a plain method, testable
without sockets.
"""
import json
import os
import threading
import time

from ..utils.envs import env_str
from . import compilemem, goodput, request_trace, tracing
from .metrics import registry as _registry

__all__ = ["StatusServer"]


class StatusServer:
    """One daemon HTTP server exposing the process's telemetry.

    ``frontend`` (optional) is a ServingFrontend — /statusz gains its
    ``serving_report()`` and /healthz its replica states. ``telemetry_dir``
    (optional, defaults to ``PADDLE_TELEMETRY_DIR``) lets /healthz reuse
    the heartbeat files the watchdog reads."""

    def __init__(self, port=0, host="127.0.0.1", frontend=None,
                 telemetry_dir=None, heartbeat_stale_s=60.0,
                 tracez_n=10, elastic_info=None, fleet=None):
        self.host = host
        self.port = int(port)
        self.frontend = frontend
        # elastic membership provider: a launcher passes a callable with
        # its live view (generation/world/parked); workers fall back to
        # their env contract
        self.elastic_info = elastic_info
        # fleet aggregator: a host may pass its live FleetAggregator;
        # standalone servers build one lazily over telemetry_dir on the
        # first /fleetz hit
        self.fleet = fleet
        self.telemetry_dir = (telemetry_dir
                              or env_str("PADDLE_TELEMETRY_DIR"))
        self.heartbeat_stale_s = float(heartbeat_stale_s)
        self.tracez_n = int(tracez_n)
        self._t0 = time.time()
        self._httpd = None
        self._thread = None
        # THE dispatch table: every route — handler, 404 listing, docs
        # test — derives from this one dict, so a new route cannot be
        # silently omitted from the listing. Each
        # handler takes the query string and returns (code, body, ctype).
        self.routes = {
            "/statusz": self._route_json(lambda q: (200, self.statusz())),
            "/varz": lambda q: (200, self.varz(),
                                "text/plain; version=0.0.4"),
            "/tracez": self._route_json(lambda q: (200, self.tracez())),
            "/compilez": self._route_json(
                lambda q: (200, self.compilez())),
            "/memz": self._route_json(lambda q: (200, self.memz())),
            "/fleetz": self._route_json(
                lambda q: (200, self.fleetz(refresh="refresh=1" in q))),
            "/dynamicsz": self._route_json(
                lambda q: (200, self.dynamicsz())),
            "/profilez": self._route_json(
                lambda q: (200, self.profilez(q))),
            "/perfz": self._route_json(
                lambda q: (200, self.perfz(q))),
            "/kvz": self._route_json(lambda q: (200, self.kvz())),
            "/tenantz": self._route_json(lambda q: (200, self.tenantz())),
            "/healthz": self._route_json(lambda q: self.healthz()),
        }

    @staticmethod
    def _route_json(fn):
        def handler(query):
            code, payload = fn(query)
            return (code, json.dumps(payload, indent=1, default=str),
                    "application/json")
        return handler

    def route_names(self):
        """The live route listing (served in the 404 body) — derived from
        the dispatch table, never hand-maintained."""
        return sorted(self.routes)

    # ---- payloads (plain methods: no sockets needed to test) --------------
    def statusz(self):
        out = {
            "pid": os.getpid(),
            "time": time.time(),
            "uptime_s": round(time.time() - self._t0, 3),
            "telemetry_enabled": tracing.enabled(),
            "telemetry_dir": self.telemetry_dir,
            "goodput": goodput.report(),
            "serving_goodput": goodput.serving.report(),
            "traces": {
                "started": getattr(_registry.get("rtrace.traces"),
                                   "value", 0),
                "open": getattr(_registry.get("rtrace.open"), "value", 0),
                "dropped_spans": getattr(
                    _registry.get("rtrace.dropped_spans"), "value", 0),
                "recent": len(request_trace.recent()),
            },
            "metrics": len(_registry.names()),
            "elastic": self._elastic(),
        }
        fe = self.frontend
        if fe is not None:
            try:
                out["serving"] = fe.serving_report()
            except Exception as e:  # a shut-down frontend must not 500
                out["serving"] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def kvz(self):
        """Cluster KV fabric view: tier hit/fallthrough
        counters, spill-ring occupancy, residency by owner — the
        frontend fabric's ``report()``, armored like every other route
        (a frontend-less or shut-down server answers shaped JSON)."""
        fe = self.frontend
        fab = getattr(fe, "kvfabric", None) if fe is not None else None
        if fab is None:
            return {"enabled": False,
                    "error": "no serving frontend (or no KV fabric) bound"}
        try:
            return fab.report()
        except Exception as e:
            return {"enabled": False, "error": f"{type(e).__name__}: {e}"}

    def tenantz(self):
        """Multi-tenant serving view: per-tenant quota/bucket/
        inflight state, private brownout rung, SLO burn rates, and
        tenant-labeled latency summaries, plus the LoRA adapter cache —
        the frontend's ``tenant_report()``, armored like /kvz (a
        frontend-less or shut-down server answers shaped JSON)."""
        fe = self.frontend
        if fe is None or not hasattr(fe, "tenant_report"):
            return {"error": "no serving frontend (or no tenant plane) "
                             "bound"}
        try:
            out = {"tenants": fe.tenant_report()}
            adapters = getattr(fe, "adapters", None)
            if adapters is not None:
                out["adapters"] = adapters.report()
            return out
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    def _elastic(self):
        """Elastic membership view: the configured provider (launcher), or
        this process's env contract (worker), or a fixed-width default."""
        if self.elastic_info is not None:
            try:
                return self.elastic_info()
            except Exception as e:
                return {"error": f"{type(e).__name__}: {e}"}
        # armored parses: /statusz must survive exactly the malformed env a
        # misconfigured worker is being debugged FOR
        from ..utils.envs import env_int

        out = {
            "generation": env_int("PADDLE_ELASTIC_GENERATION", 0),
            "world_size": env_int("PADDLE_TRAINERS_NUM", 0) or None,
            "live_ranks": None,
        }
        raw = env_str("PADDLE_ELASTIC_RANKS")
        if raw:
            try:
                out["live_ranks"] = [int(r) for r in raw.split(",")
                                     if r.strip()]
            except ValueError:
                pass
        return out

    def varz(self):
        return _registry.to_prometheus()

    def tracez(self):
        return {
            "recent": len(request_trace.recent()),
            "dropped_spans": getattr(
                _registry.get("rtrace.dropped_spans"), "value", 0),
            "slowest": request_trace.slowest(self.tracez_n),
            "errored": request_trace.errored(self.tracez_n),
        }

    def compilez(self):
        """The compile ledger: per-key compile rollup, churned programs,
        recent events, compiles in flight, cache sizes."""
        return compilemem.ledger.report()

    def memz(self):
        """The device-memory ledger: components against the card's
        capacity, the allocator's live and peak bytes, the programs'
        cost rows."""
        return compilemem.memory.report()

    def fleetz(self, refresh=False):
        """The fleet view: merged per-rank/per-replica
        snapshots — members, quorum, cross-rank phase skew, straggler
        verdicts, serving rollup. An aggregator with a thread of its own
        serves its last view (``?refresh=1`` forces a fresh merge);
        a standalone server lazily builds an aggregator over its
        telemetry dir."""
        agg = self.fleet
        if agg is None:
            if not self.telemetry_dir:
                return {"error": "no telemetry dir configured "
                                 "(PADDLE_TELEMETRY_DIR or telemetry_dir=)"}
            from .fleet import FleetAggregator
            from .metrics import MetricsRegistry

            # scratch registry: a scrape-driven merge must not inject
            # cluster-level fleet.* gauges into THIS process's live
            # registry (its own snapshot publisher would re-export them
            # as if they were local series)
            agg = self.fleet = FleetAggregator(
                self.telemetry_dir, registry=MetricsRegistry())
        if callable(agg) and not hasattr(agg, "view"):
            return agg()  # provider callable (tests / custom hosts)
        # a launcher-hosted aggregator refreshes on its own monitor
        # cadence — serve its last view; a lazily-built standalone one has
        # no thread, so every scrape must merge fresh or the view freezes
        # at the first-ever request
        if getattr(agg, "_thread", None) is None:
            refresh = True
        return agg.view(refresh=refresh)

    def dynamicsz(self):
        """The training-dynamics view: every live monitor's
        layer groups, last spilled summary and recent window, plus the
        flight recorder's committed-bundle ledger."""
        from . import dynamics, flightrec

        return {
            "monitors": dynamics.reports(),
            "flight": flightrec.report(),
            "capture": flightrec.capture_status(),
        }

    def profilez(self, query):
        """The on-demand profiler capture surface:
        ``/profilez?steps=K`` arms a capture of the next K train steps
        through the flight recorder's capture registry;
        ``?disarm=1`` cancels/stops the armed capture (the remediation
        for a capture armed on a process that never steps — without it
        the one-capture slot would wedge until restart); a bare GET
        returns the armed/active capture and the completed-capture
        history."""
        import re as _re

        from . import flightrec

        if _re.search(r"(?:^|&)disarm=1", query or ""):
            return flightrec.disarm_capture()
        m = _re.search(r"(?:^|&)steps=(\d+)", query or "")
        if m:
            return flightrec.arm_capture(int(m.group(1)), trigger="http")
        return flightrec.capture_status()

    def perfz(self, query):
        """The device-time profiling surface: per-program device-seconds,
        MFU, and roofline verdicts from the devprof plane.
        ``?program=<key-prefix>`` filters rows (URL-encoded: program keys
        contain brackets)."""
        import re as _re
        import urllib.parse as _up

        from . import devprof

        program = None
        m = _re.search(r"(?:^|&)program=([^&]*)", query or "")
        if m and m.group(1):
            program = _up.unquote(m.group(1))
        return devprof.report(program=program)

    def _heartbeats(self):
        """{rank: age_s} from the heartbeat files, when a telemetry dir is
        configured."""
        d = self.telemetry_dir
        if not d:
            return {}
        from .watchdog import _HB_RE

        out = {}
        try:
            names = os.listdir(d)
        except OSError:
            return out
        now = time.time()
        for name in names:
            m = _HB_RE.match(name)
            if not m:
                continue
            try:
                with open(os.path.join(d, name)) as f:
                    hb = json.load(f)
                out[m.group(1)] = round(now - hb.get("time", 0), 3)
            except (OSError, ValueError):
                continue
        return out

    def healthz(self):
        """(http_status, payload). ``status`` is the worst verdict across
        both signals — replica states and heartbeat ages — and the HTTP
        code follows it (503 iff ``unhealthy``), so a probe keying on
        either agrees with one keying on the other."""
        payload = {"uptime_s": round(time.time() - self._t0, 3)}
        status = "ok"
        fe = self.frontend
        if fe is not None:
            states = {r.name: r.state for r in fe.replicas}
            payload["replicas"] = states
            if any(s == "DEAD" for s in states.values()):
                status = "degraded"
            if not any(s == "LIVE" for s in states.values()):
                status = "unhealthy"
        hbs = self._heartbeats()
        if hbs:
            payload["heartbeat_age_s"] = hbs
            stale = {r: a for r, a in hbs.items()
                     if a > self.heartbeat_stale_s}
            if stale:
                payload["stale_ranks"] = sorted(stale)
                if len(stale) == len(hbs):
                    status = "unhealthy"
                elif status == "ok":
                    status = "degraded"
        payload["status"] = status
        return (503 if status == "unhealthy" else 200), payload

    # ---- HTTP ------------------------------------------------------------
    def start(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no stderr spam from scrapers
                pass

            def _send(self, code, body, ctype):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                raw_path, _, query = self.path.partition("?")
                path = raw_path.rstrip("/") or "/statusz"
                handler = server.routes.get(path)
                try:
                    if handler is None:
                        # the listing IS the dispatch table: a route added
                        # above appears here by construction
                        self._send(404, json.dumps(
                            {"error": "not found",
                             "routes": server.route_names()}),
                            "application/json")
                    else:
                        code, body, ctype = handler(query)
                        self._send(code, body, ctype)
                except Exception as e:  # introspection must never crash
                    self._send(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}),
                        "application/json")

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="paddle-statusz")
        self._thread.start()
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
