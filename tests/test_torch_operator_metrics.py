"""Port parity: the metrics registry's dumps and the metrics bus's writers
against the JAX package's, on the CPU. The same scripted registry contents
go into ``paddle_tpu.observability.metrics.MetricsRegistry`` and the port's,
and their outputs must match byte for byte (bookkeeping, no rounding of its
own):

- ``export`` (the fleet snapshot payload, with prefixes);
- ``load_series``: the export reloaded into a fresh registry of either
  package, with and without extra labels, gives the same exposition, and a
  record whose family is registered as another type is refused (None);
- ``dump_jsonl`` lines with an ``extra`` stamp;
- ``to_prometheus`` text: counters, gauges with their high-water family,
  histograms with cumulative buckets and ``+Inf``, labels and help text
  escaped, names sanitized;
- ``JsonlWriter`` (context manager, idempotent close, writes after the
  close dropped) and ``stdout_logger``.
"""
import json
import logging

import pytest

from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.utils import metrics_bus as ref_bus
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch.utils import metrics_bus as port_bus


def _fill(mod):
    """One registry of ``mod`` holding every kind of series the dumps
    render: help text with a backslash and a newline, label values with
    quotes, a name starting with a digit, a zero counter, an empty
    histogram, custom buckets."""
    r = mod.MetricsRegistry()
    r.counter("serving.requests", help="requests\nsubmitted").inc(7)
    r.counter("serving.rerouted", labels={"replica": 'r"0'},
              help="reroutes by \\ replica").inc(2)
    r.counter("serving.rerouted", labels={"replica": "r1"}).inc(3)
    r.counter("fault.none")                       # zero: omitted by export
    r.gauge("serving.replica.occupancy", labels={"replica": "r0"},
            help="active / max_seqs").set(0.75)
    g = r.gauge("device.bytes")
    g.set(9.0)
    g.set(4.0)                                    # hwm 9
    h = r.histogram("serving.ttft_s", labels={"slo": "interactive"},
                    help="time to first token")
    for v in (0.0004, 0.02, 0.3, 2.0, 99.0):
        h.observe(v)
    r.histogram("compile.wall_s", buckets=(0.5, 5.0)).observe(1.0)
    r.histogram("span.idle_s")                    # empty: omitted by export
    r.counter("1st.metric-name").inc()
    return r


def test_export_is_the_reference_export():
    ref, port = _fill(ref_metrics), _fill(port_metrics)
    assert port.export() == ref.export()
    for prefixes in (["serving."], ["device.", "compile."], ["nothing"]):
        assert port.export(prefixes) == ref.export(prefixes)


def test_to_prometheus_byte_for_byte():
    ref, port = _fill(ref_metrics), _fill(port_metrics)
    text = port.to_prometheus()
    assert text == ref.to_prometheus()
    assert "# TYPE serving_ttft_s histogram" in text
    assert 'serving_ttft_s_bucket{slo="interactive",le="+Inf"} 5' in text
    assert "# TYPE device_bytes_hwm gauge" in text
    assert "_1st_metric_name 1" in text
    assert "# HELP serving_requests requests\\nsubmitted" in text
    assert port_metrics.MetricsRegistry().to_prometheus() == ""


@pytest.mark.parametrize("extra", [None, {"rank": "3"}])
@pytest.mark.parametrize("target", ["ref", "port"])
def test_load_series_round_trip(target, extra):
    """The port's export reloads into either package's registry exactly as
    the reference's does (the aggregator merges snapshots this way)."""
    mod = ref_metrics if target == "ref" else port_metrics
    texts = []
    for src in (ref_metrics, port_metrics):
        merged = mod.MetricsRegistry()
        for rec in _fill(src).export():
            assert merged.load_series(rec, extra_labels=extra) is not None
        texts.append(merged.to_prometheus())
    assert texts[0] == texts[1]
    if extra:
        assert 'serving_requests{rank="3"} 7' in texts[1]


def test_load_series_refuses_a_conflicting_family():
    for mod in (ref_metrics, port_metrics):
        r = mod.MetricsRegistry()
        r.gauge("serving.requests")
        rec = {"family": "serving.requests", "type": "counter", "value": 1}
        assert r.load_series(rec) is None
        assert r.load_series({"family": "x", "type": "bogus"}) is None


def test_dump_jsonl_lines(tmp_path):
    lines = []
    for mod in (ref_metrics, port_metrics):
        path = tmp_path / f"{mod.__name__}.jsonl"
        r = _fill(mod)
        r.dump_jsonl(str(path), extra={"rank": 3, "step": 11})
        r.dump_jsonl(str(path))                   # appends
        lines.append(path.read_text().splitlines())
    assert lines[0] == lines[1]
    recs = [json.loads(x) for x in lines[1]]
    assert recs[0]["rank"] == 3 and "rank" not in recs[-1]
    empty = tmp_path / "empty" / "m.jsonl"
    port_metrics.MetricsRegistry().dump_jsonl(str(empty))
    assert empty.read_text() == ""


def test_jsonl_writer_matches_the_reference(tmp_path):
    out = []
    for mod in (ref_bus, port_bus):
        path = str(tmp_path / f"{mod.__name__}" / "m.jsonl")
        with mod.JsonlWriter(path) as w:
            w({"step": 1, "loss": 2.5})
            w({"step": 2, "loss": float("inf")})
        w.close()                                 # a second close is safe
        w({"step": 3})                            # dropped after the close
        out.append(open(path).read())
    assert out[0] == out[1]
    assert [json.loads(x)["step"] for x in out[1].splitlines()] == [1, 2]


def test_stdout_logger_matches_the_reference(caplog):
    rec = {"step": 4, "loss": 1.25, "tokens_per_sec": 10.0}
    with caplog.at_level(logging.INFO):
        ref_bus.stdout_logger("train")(rec)
        port_bus.stdout_logger("train")(rec)
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs == ["train step=4 loss=1.25 tokens_per_sec=10.0"] * 2
