"""Stdlib-http /metrics endpoint (opt-in via NodeHostConfig.enable_metrics).

Serves the Prometheus text exposition of one or more
``telemetry.Registry`` objects (a NodeHost serves its per-hub registry
concatenated with the process-global one that module-scoped producers
like the logdb engines write to), plus ``/flight`` — the flight
recorder tail as JSON — ``/trace`` — the lifecycle tracer's completed
proposal spans as Chrome-trace-event JSON, loadable directly in
Perfetto / chrome://tracing — ``/healthz``, and the fleet-health
drill-down pair ``/debug/groups`` (NodeHost.info(): health summary +
NodeHostInfo-parity shard list) and ``/debug/group/<id>``
(NodeHost.shard_info(): one group's O(1) device row + host registers),
``/debug/capacity`` (capacity.py merged snapshot: live/peak bytes,
headroom, per-entry compile counters), and ``/debug/fabric``
(fabric.py: per-link transport telemetry + the commit-path hop
census).  ``/trace`` merges the compile tracker's spans and the
fabric meter's remote child spans into the lifecycle ring's, so one
Perfetto timeline shows proposals beside the compiles that stalled
them and the remote hosts their quorum rounds touched.

``/healthz`` is honest: with a ``health_source`` wired (core/health.py
merged snapshot), any nonzero anomaly-class count turns it into a 503
with a structured JSON body naming the tripped classes; a
``capacity_source`` reporting memory pressure or a retrace storm
degrades it the same way (with a ``capacity`` section in the body);
without either it keeps the legacy unconditional ``ok``.

A ``ThreadingHTTPServer`` on a daemon thread: scrapes never run on an
engine thread, and the collect path takes no registry lock while
evaluating callback gauges (see telemetry.Registry.collect), so a
scrape cannot invert against engine-held host locks.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dragonboat_tpu_torch import flight
from dragonboat_tpu_torch import lifecycle
from dragonboat_tpu_torch.logger import get_logger

_LOG = get_logger("metrics_http")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """One /metrics listener over a list of registries."""

    def __init__(self, registries, address: str = "127.0.0.1:0",
                 flight_recorder=None, tracer=None,
                 health_source=None, info_source=None,
                 shard_info_source=None, capacity_source=None,
                 compile_tracker=None, invariants_source=None,
                 fabric_source=None, fabric_trace_source=None) -> None:
        self.registries = list(registries)
        self.flight_recorder = (flight_recorder if flight_recorder
                                is not None else flight.RECORDER)
        self.tracer = tracer if tracer is not None else lifecycle.TRACER
        # health_source() -> health dict (core/health.py empty_dict
        # shape); info_source() -> NodeHost.info() dict;
        # shard_info_source(shard_id) -> dict | None;
        # capacity_source() -> capacity dict (capacity.py empty_dict
        # shape) — serves /debug/capacity and widens /healthz
        self.health_source = health_source
        self.info_source = info_source
        self.shard_info_source = shard_info_source
        self.capacity_source = capacity_source
        # invariants_source() -> invariants dict (core/invariants.py
        # empty_dict shape + violations_seen) — widens /healthz: a
        # protocol-invariant violation is a BUG, so the degradation is
        # sticky (violations_seen, not the instantaneous total)
        self.invariants_source = invariants_source
        # fabric_source() -> fabric.FabricMeter.snapshot() dict (serves
        # /debug/fabric); fabric_trace_source() -> remote child spans as
        # Chrome events, merged into /trace so one Perfetto timeline
        # shows the origin's span beside every remote host it touched
        self.fabric_source = fabric_source
        self.fabric_trace_source = fabric_trace_source
        if compile_tracker is None:
            # imported here, not at module top: capacity.py pulls jax,
            # which importers of this module must not pay for eagerly
            from dragonboat_tpu_torch import capacity as _capacity

            compile_tracker = _capacity.TRACKER
        self.compile_tracker = compile_tracker
        host, _, port = address.rpartition(":")
        if not host:
            host, port = address or "127.0.0.1", "0"
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:          # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                status = 200
                if path == "/metrics":
                    body = outer.render().encode("utf-8")
                    ctype = CONTENT_TYPE
                elif path == "/flight":
                    body = (outer.flight_recorder.dump_json(indent=2)
                            + "\n").encode("utf-8")
                    ctype = "application/json"
                elif path == "/trace":
                    # one timeline: proposal spans beside compile spans
                    # and the fabric's remote child spans (distinct pid
                    # rows in Perfetto / chrome://tracing; remote spans
                    # share the proposal's tid, stitching the hosts)
                    trace = outer.tracer.export_chrome_trace()
                    events = (list(trace.get("traceEvents", ()))
                              + outer.compile_tracker.chrome_events())
                    if outer.fabric_trace_source is not None:
                        events += outer.fabric_trace_source()
                    trace["traceEvents"] = events
                    body = (json.dumps(trace, sort_keys=True)
                            + "\n").encode("utf-8")
                    ctype = "application/json"
                elif path == "/healthz":
                    status, body, ctype = outer.healthz()
                elif path == "/debug/fabric" and outer.fabric_source:
                    body = (json.dumps(outer.fabric_source(),
                                       sort_keys=True)
                            + "\n").encode("utf-8")
                    ctype = "application/json"
                elif path == "/debug/capacity" and outer.capacity_source:
                    body = (json.dumps(outer.capacity_source(),
                                       sort_keys=True)
                            + "\n").encode("utf-8")
                    ctype = "application/json"
                elif path == "/debug/groups" and outer.info_source:
                    body = (json.dumps(outer.info_source(), sort_keys=True)
                            + "\n").encode("utf-8")
                    ctype = "application/json"
                elif (path.startswith("/debug/group/")
                        and outer.shard_info_source):
                    try:
                        sid = int(path[len("/debug/group/"):])
                    except ValueError:
                        self.send_error(404)
                        return
                    d = outer.shard_info_source(sid)
                    if d is None:
                        self.send_error(404)
                        return
                    body = (json.dumps(d, sort_keys=True)
                            + "\n").encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args) -> None:
                _LOG.debug("metrics http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"metrics-http-{self._httpd.server_address[1]}",
            daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    def healthz(self) -> tuple[int, bytes, str]:
        """(status, body, content-type) for /healthz: degraded (503 +
        structured JSON) when any anomaly-class count is nonzero, when
        the capacity view reports memory pressure / a retrace storm, or
        when the invariant probe has EVER seen a protocol-invariant
        violation (sticky — a violation is a bug, not a condition that
        clears)."""
        h = (self.health_source() if self.health_source is not None
             else None)
        counts = h.get("class_count", {}) if h else {}
        tripped = {c: n for c, n in counts.items() if n}
        cap = (self.capacity_source() if self.capacity_source is not None
               else None)
        cap_tripped = [k for k in ("memory_pressure", "retrace_storm")
                       if cap and cap.get(k)]
        inv = (self.invariants_source()
               if self.invariants_source is not None else None)
        inv_tripped = bool(inv) and (inv.get("violations_seen", 0) > 0
                                     or inv.get("total", 0) > 0)
        if not tripped and not cap_tripped and not inv_tripped:
            return 200, b"ok\n", "text/plain"
        payload = {
            "status": "degraded",
            "class_count": counts,
            "anomalous": h.get("anomalous", 0) if h else 0,
            "worst": h.get("worst", []) if h else [],
        }
        if cap_tripped:
            payload["capacity"] = {
                "tripped": cap_tripped,
                "headroom_pct": cap["headroom_pct"],
                "bytes_in_use": cap["bytes_in_use"],
                "budget_bytes": cap["budget_bytes"],
                "entries": cap["entries"],
            }
        if inv_tripped:
            payload["invariants"] = {
                "total": inv.get("total", 0),
                "violations_seen": inv.get("violations_seen", 0),
                "per_invariant": inv.get("per_invariant", {}),
                "first": inv.get("first"),
            }
        body = json.dumps(payload, sort_keys=True) + "\n"
        return 503, body.encode("utf-8"), "application/json"

    def render(self) -> str:
        return "".join(r.exposition() for r in self.registries)

    def close(self) -> None:
        self._httpd.shutdown()
        self._thread.join(timeout=2)
        self._httpd.server_close()
