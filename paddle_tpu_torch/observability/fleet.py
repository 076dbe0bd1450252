"""The serving side of the fleet rollup (the port's own copy of
``serving_rollup`` in ``paddle_tpu/observability/fleet.py``): one
cluster-level view of a serving cell's replicas, SLO burn and goodput,
distilled into the ``pressure``/``scale_hint`` signal an autoscaler reads.
The training side (snapshot publishers, the aggregator, the collectives)
waits for the operator plane (ROADMAP.md, slice 16).
"""
from .metrics import registry as _registry

__all__ = ["serving_rollup"]


def serving_rollup(replica_snapshots, slo_report, goodput_report):
    """The ``serving_report()["fleet"]`` block: one cluster-level view —
    per-replica burn inputs are already cluster-scoped (the SLO monitor
    spans every dispatcher), so this distills replicas + burn + goodput
    into the single ``pressure``/``scale_hint`` signal an autoscaler
    reads, and publishes the ``fleet.serving.*`` gauges a scraper joins
    with the training-side fleet view."""
    states = [s.get("state") for s in replica_snapshots.values()]
    live = sum(1 for st in states if st == "LIVE")
    queue_depth = sum(s.get("pending") or 0
                      for s in replica_snapshots.values())
    # occupancy over LIVE replicas only, matching the slots accounting:
    # averaging in DEAD replicas' zero occupancy dilutes the pressure
    # signal exactly when the survivors are saturated — the moment an
    # autoscaler most needs to hear "grow"
    occs, slots = [], 0
    for s in replica_snapshots.values():
        max_seqs = s.get("max_seqs") or 0
        if max_seqs and s.get("state") == "LIVE":
            occs.append((s.get("active") or 0) / max_seqs)
            slots += max_seqs
    occupancy_mean = round(sum(occs) / len(occs), 4) if occs else 0.0
    # cluster KV fabric: advertised prefix residency summed
    # across replicas — the router scores placement against this index,
    # so the rollup is how an operator sees the cluster cache's size
    kv_resident = sum(s.get("kv_resident") or 0
                      for s in replica_snapshots.values())
    # the multi-window AND: an objective pages only when BOTH windows
    # burn, so min(fast, slow) is the page-relevant burn per objective
    worst_burn, worst_objective = 0.0, None
    for name, r in (slo_report.get("objectives") or {}).items():
        burn = min(r.get("fast", 0.0), r.get("slow", 0.0))
        if burn > worst_burn:
            worst_burn, worst_objective = burn, name
    alerts = slo_report.get("alerts") or []
    queue_pressure = (min(1.0, queue_depth / slots) if slots
                      else (1.0 if queue_depth else 0.0))
    pressure = round(max(occupancy_mean, queue_pressure), 4)
    if alerts or (live == 0 and states):
        scale_hint = "grow"
    elif pressure > 0.85:
        scale_hint = "grow"
    elif pressure < 0.15 and live > 1 and worst_burn < 1.0:
        scale_hint = "shrink"
    else:
        scale_hint = "hold"
    _registry.gauge(
        "fleet.serving.live_replicas",
        help="replicas currently LIVE in this serving cell").set(live)
    _registry.gauge(
        "fleet.serving.queue_depth",
        help="cluster-wide routed-but-not-admitted requests").set(
        queue_depth)
    _registry.gauge(
        "fleet.serving.occupancy_mean",
        help="mean decode-slot occupancy across replicas").set(
        occupancy_mean)
    _registry.gauge(
        "fleet.serving.worst_burn",
        help="worst min(fast, slow) SLO burn rate across objectives"
    ).set(round(worst_burn, 4))
    _registry.gauge(
        "fleet.serving.pressure",
        help="blended autoscaling pressure signal (0..1)").set(pressure)
    _registry.gauge(
        "fleet.serving.kv_resident",
        help="cluster KV-fabric prefix entries advertised across "
             "replicas").set(kv_resident)
    # per-role sub-rollup: a disaggregated fleet's prefill and
    # decode pools saturate independently, so each role gets its own
    # pressure + scale_hint — the supervisor scales the pools off these,
    # and a blended mean can no longer hide one saturated pool behind the
    # other's idle slots. Homogeneous fleets roll up as one "blended" role.
    by_role = {}
    for s in replica_snapshots.values():
        role = s.get("role") or "blended"
        r = by_role.setdefault(role, {"replicas": 0, "live": 0,
                                      "queue_depth": 0, "occs": [],
                                      "slots": 0})
        r["replicas"] += 1
        r["queue_depth"] += s.get("pending") or 0
        max_seqs = s.get("max_seqs") or 0
        if s.get("state") == "LIVE":
            r["live"] += 1
            if max_seqs:
                r["occs"].append((s.get("active") or 0) / max_seqs)
                r["slots"] += max_seqs
    roles = {}
    for role, r in sorted(by_role.items()):
        occ = (round(sum(r["occs"]) / len(r["occs"]), 4)
               if r["occs"] else 0.0)
        qp = (min(1.0, r["queue_depth"] / r["slots"]) if r["slots"]
              else (1.0 if r["queue_depth"] else 0.0))
        p = round(max(occ, qp), 4)
        if alerts or (r["live"] == 0 and r["replicas"]):
            hint = "grow"
        elif p > 0.85:
            hint = "grow"
        elif p < 0.15 and r["live"] > 1 and worst_burn < 1.0:
            hint = "shrink"
        else:
            hint = "hold"
        _registry.gauge(
            "serving.role.pressure", labels={"role": role},
            help="per-role autoscaling pressure (0..1) — prefill/decode "
                 "pools saturate independently").set(p)
        _registry.gauge(
            "serving.role.live_replicas", labels={"role": role},
            help="LIVE replicas per disaggregation role").set(r["live"])
        roles[role] = {"replicas": r["replicas"], "live": r["live"],
                       "queue_depth": r["queue_depth"],
                       "occupancy_mean": occ, "pressure": p,
                       "scale_hint": hint}
    return {
        "replicas": len(replica_snapshots),
        "live_replicas": live,
        "queue_depth": queue_depth,
        "occupancy_mean": occupancy_mean,
        "goodput": {k: round(v, 4) for k, v in
                    (goodput_report.get("fractions") or {}).items()},
        "slo": {
            "worst_burn": round(worst_burn, 4),
            "worst_objective": worst_objective,
            "alerting": [a.get("objective") for a in alerts],
        },
        "pressure": pressure,
        "scale_hint": scale_hint,
        "roles": roles,
        "kv_resident": kv_resident,
    }
