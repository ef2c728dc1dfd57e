"""Prometheus-style metrics endpoint + debug surfaces.

The reference *declares* `metrics: {enabled, port: 9090}` in its config but
no server exists — the keys are read by nothing (reference config.yaml:29-31,
SURVEY §5 "dead config"; README.md:184 defers it to future work). This module
makes the endpoint real: a stdlib ThreadingHTTPServer serving

    /metrics           Prometheus text exposition of scheduler + engine stats
                       (gauges, plus genuine `histogram` families for every
                       PhaseRecorder phase — `_bucket`/`_sum`/`_count` with
                       derived p50/p95/p99 gauges beside them)
    /healthz           liveness (200 when the loop is running)
    /stats             the full merged stats dict as JSON
    /debug/decisions   flight-recorder trace summaries (observability/spans;
                       ?n= limit, ?since= seq cursor for `cli trace tail`,
                       ?max_bytes= hard size cap -> truncated/next_cursor)
    /debug/trace/<id>  one complete decision trace (span tree + metadata)
    /debug/export      held traces as JSONL (replayable records; ?since= +
                       ?max_bytes= paginate — a trailer line carries
                       {"truncated": true, "next_cursor": N} on a capped
                       response so a resume never re-ships the prefix)
    /debug/engine      engine telemetry ring series (observability/sampler)
    /debug/profile     continuous wave profiler: per-wave step timeline,
                       segment fractions, MFU loss decomposition
                       (observability/profiler)
    /debug/slo         SLO burn-rate engine state: per-objective fast/slow
                       burn + trips (observability/slo)

Stats are pulled from a provider callable at scrape time — no push path,
no extra locks on the hot path. When an engine sampler / profiler / SLO
engine is attached, their latest readings merge into the /metrics
exposition as gauges HERE (not in caller wiring), so they are visible to
scrapers regardless of which stats provider the server was built with.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

from k8s_llm_scheduler_tpu_torch.observability.trace import BUCKET_BOUNDS_S, HIST_KEY

logger = logging.getLogger(__name__)

_PREFIX = "llm_scheduler"


def _escape_label_value(value: str) -> str:
    """Escape a label VALUE per the Prometheus exposition spec: backslash,
    double quote, and newline must be escaped or the line is unparseable
    (a node name or breaker-state string containing any of them previously
    emitted invalid exposition text)."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _flatten(stats: dict[str, Any], prefix: str = "") -> dict[str, float]:
    out: dict[str, float] = {}
    for key, value in stats.items():
        if key == HIST_KEY:
            continue  # histogram payloads render as their own families
        name = f"{prefix}_{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flatten(value, name))
        elif isinstance(value, bool):
            out[name] = 1.0 if value else 0.0
        elif isinstance(value, (int, float)):
            out[name] = float(value)
        # strings (e.g. breaker state) become labeled gauges below
        elif isinstance(value, str):
            out[f'{name}{{value="{_escape_label_value(value)}"}}'] = 1.0
        elif isinstance(value, (list, tuple)):
            # index-labeled gauges: per-replica lists (fanout_routed) and
            # per-wave arena series (sim/arena) were silently DROPPED
            # before this — a scrape showed totals but never the series
            for i, item in enumerate(value):
                if isinstance(item, dict):
                    out.update(_flatten(item, f"{name}_{i}"))
                elif isinstance(item, bool):
                    out[f'{name}{{index="{i}"}}'] = 1.0 if item else 0.0
                elif isinstance(item, (int, float)):
                    out[f'{name}{{index="{i}"}}'] = float(item)
    return out


def _collect_histograms(
    stats: dict[str, Any], prefix: str = ""
) -> list[tuple[str, dict]]:
    """(flattened path, histogram payload) pairs for every embedded
    PhaseRecorder histogram (trace.HIST_KEY dicts) in the stats tree."""
    out: list[tuple[str, dict]] = []
    for key, value in stats.items():
        if not isinstance(value, dict):
            continue
        name = f"{prefix}_{key}" if prefix else key
        hist = value.get(HIST_KEY)
        if (
            isinstance(hist, dict)
            and "counts" in hist
            and len(hist["counts"]) == len(BUCKET_BOUNDS_S) + 1
        ):
            out.append((name, hist))
        out.extend(_collect_histograms(value, name))
    return out


def _format_bound(bound: float) -> str:
    """Stable short text for a bucket bound (no float noise in labels)."""
    text = f"{bound:.10f}".rstrip("0").rstrip(".")
    return text or "0"


def render_prometheus(stats: dict[str, Any]) -> str:
    # Group samples by metric FAMILY (name sans labels) so each family gets
    # exactly one `# TYPE <family> gauge` header with its samples contiguous
    # under it — the exposition-format contract scrapers validate (bare
    # samples with no TYPE parse, but registries flag them and typed
    # queries treat them as untyped). Point-in-time readings render as
    # gauges; PhaseRecorder phases additionally render as genuine
    # `histogram` families (cumulative `_bucket{le=...}` + `_sum`/`_count`)
    # so bind p99 under burst is a PromQL histogram_quantile away, not a
    # guess from an average.
    families: dict[str, list[tuple[str, float]]] = {}
    for name, value in sorted(_flatten(stats).items()):
        metric = f"{_PREFIX}_{name}"
        family = metric
        # metric names cannot contain '{' — split label part back out
        if "{" in name:
            base, label = name.split("{", 1)
            family = f"{_PREFIX}_{base}"
            metric = f"{family}{{{label}"
        families.setdefault(family, []).append((metric, value))
    lines = []
    for family, samples in families.items():
        lines.append(f"# TYPE {family} gauge")
        lines.extend(f"{metric} {value}" for metric, value in samples)
    for path, hist in sorted(_collect_histograms(stats)):
        family = f"{_PREFIX}_{path}_seconds"
        lines.append(f"# TYPE {family} histogram")
        acc = 0
        for bound, count in zip(BUCKET_BOUNDS_S, hist["counts"]):
            acc += int(count)
            lines.append(
                f'{family}_bucket{{le="{_format_bound(bound)}"}} {acc}'
            )
        acc += int(hist["counts"][-1])  # overflow bucket
        lines.append(f'{family}_bucket{{le="+Inf"}} {acc}')
        lines.append(f"{family}_sum {float(hist['sum_s'])}")
        lines.append(f"{family}_count {int(hist['count'])}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Serve scheduler stats on the (formerly dead) metrics port.

    `flight_recorder` (default: the global spans.flight) backs the
    /debug/decisions + /debug/trace surfaces; `engine_sampler` (optional)
    backs /debug/engine; `engine_profiler` (optional) backs /debug/profile;
    `slo_engine` (optional) backs /debug/slo. All three also contribute
    gauges to /metrics at scrape time."""

    # Default hard byte caps on the paginated debug surfaces: a
    # 16-replica telemetry_pull round must never ship unbounded JSONL in
    # one frame (?max_bytes= overrides per request).
    DECISIONS_MAX_BYTES = 1 << 20
    EXPORT_MAX_BYTES = 4 << 20

    def __init__(
        self,
        stats_provider: Callable[[], dict[str, Any]],
        port: int = 9090,
        host: str = "0.0.0.0",
        is_alive: Callable[[], bool] = lambda: True,
        flight_recorder: Any | None = None,
        engine_sampler: Any | None = None,
        engine_profiler: Any | None = None,
        slo_engine: Any | None = None,
        blackbox_provider: Callable[[], dict[str, Any] | None] | None = None,
    ) -> None:
        from k8s_llm_scheduler_tpu_torch.observability import spans

        self.stats_provider = stats_provider
        self.is_alive = is_alive
        self.flight_recorder = (
            flight_recorder if flight_recorder is not None else spans.flight
        )
        self.engine_sampler = engine_sampler
        self.engine_profiler = engine_profiler
        self.slo_engine = slo_engine
        # /debug/blackbox: the persistent loop's wedge black-box dump
        # (engine.persistent_blackbox) — None/absent when the backend has
        # no resident loop or telemetry is off.
        self.blackbox_provider = blackbox_provider

        server = self

        class Handler(BaseHTTPRequestHandler):
            # Socket deadline for the whole exchange: a stalled scraper
            # (connects, never finishes its request, or stops reading the
            # response) must not pin a handler thread forever.
            timeout = 10.0

            def do_GET(self) -> None:  # noqa: N802
                try:
                    body, ctype, code = server._route(self.path)
                except Exception as exc:  # pragma: no cover
                    body, ctype, code = str(exc).encode(), "text/plain", 500
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError, TimeoutError):
                    # Client disconnected mid-write (or stopped reading past
                    # the socket timeout): nothing to deliver to, and a
                    # traceback from the handler thread helps nobody.
                    self.close_connection = True

            def handle(self) -> None:
                # BaseHTTPRequestHandler surfaces a socket timeout (the
                # class attr above) by raising from rfile reads; contain it
                # like a disconnect instead of dumping a thread traceback.
                try:
                    super().handle()
                except (
                    BrokenPipeError, ConnectionResetError, TimeoutError
                ):
                    self.close_connection = True

            def log_message(self, fmt: str, *args: Any) -> None:
                logger.debug("metrics: " + fmt, *args)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]  # resolved (port=0 ok)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="metrics"
        )

    # ------------------------------------------------------------- routing
    @staticmethod
    def _query_int(path: str, key: str, default: int) -> int:
        from urllib.parse import parse_qs, urlsplit

        try:
            values = parse_qs(urlsplit(path).query).get(key)
            return int(values[0]) if values else default
        except (ValueError, TypeError):
            return default

    def _scrape_stats(self) -> dict[str, Any]:
        """Provider stats + attached-component gauges. The merge lives in
        the server (not caller wiring) so EngineSampler ring series /
        profiler segments / SLO burns are real Prometheus gauges whenever
        the component is attached — previously the sampler was visible to
        scrapers only when one specific CLI path wrapped the provider."""
        stats = dict(self.stats_provider())
        if self.engine_sampler is not None:
            stats["engine_telemetry"] = self.engine_sampler.latest()
        if self.engine_profiler is not None:
            stats["engine_profile"] = self.engine_profiler.gauges()
            # Mount the llm_scheduler_persistent_* family at the top
            # level (not under engine_profile) so the gauge names match
            # across /metrics, the SLO provider tree, and the fleet
            # merge; never clobber a provider-supplied subtree.
            if "persistent" not in stats and hasattr(
                self.engine_profiler, "persistent_gauges"
            ):
                stats["persistent"] = self.engine_profiler.persistent_gauges()
        if self.slo_engine is not None:
            stats["slo"] = self.slo_engine.gauges()
        return stats

    def _route(self, path: str) -> tuple[bytes, str, int]:
        if path.startswith("/metrics"):
            return (
                render_prometheus(self._scrape_stats()).encode(),
                "text/plain; version=0.0.4",
                200,
            )
        if path.startswith("/healthz"):
            ok = self.is_alive()
            return (b"ok" if ok else b"not running"), "text/plain", (
                200 if ok else 503
            )
        if path.startswith("/stats"):
            return (
                json.dumps(self.stats_provider()).encode(),
                "application/json",
                200,
            )
        if path.startswith("/debug/decisions"):
            from k8s_llm_scheduler_tpu_torch.observability.spans import (
                budget_slice,
            )

            n = self._query_int(path, "n", 50)
            since = self._query_int(path, "since", -1)
            max_bytes = self._query_int(
                path, "max_bytes", self.DECISIONS_MAX_BYTES
            )
            if since >= 0:
                # Forward-pagination walk (`cli trace tail`, resume after
                # a truncated response): oldest-first past the cursor,
                # with BOTH the n cut and the byte cap surfacing as
                # truncated/next_cursor — a newest-n cut here would skip
                # older entries without the client ever knowing.
                summaries = self.flight_recorder.list(
                    n=None, since_seq=since,
                )
                kept, next_cursor, truncated = budget_slice(
                    summaries, since_seq=since,
                    max_traces=n, max_bytes=max_bytes,
                )
            else:
                # No cursor: the recent-traces view (`cli trace list`) —
                # newest n, byte cap keeping the oldest of that window so
                # a resume via next_cursor still walks forward.
                summaries = self.flight_recorder.list(n=n)
                kept, next_cursor, truncated = budget_slice(
                    summaries, max_bytes=max_bytes,
                )
            body = json.dumps({
                "recorder": self.flight_recorder.stats(),
                "traces": kept,
                "truncated": truncated,
                "next_cursor": next_cursor,
            }).encode()
            return body, "application/json", 200
        if path.startswith("/debug/trace/"):
            from urllib.parse import urlsplit

            trace_id = urlsplit(path).path[len("/debug/trace/"):]
            entry = self.flight_recorder.get(trace_id)
            if entry is None:
                return b"trace not found (ring may have evicted it)", (
                    "text/plain"
                ), 404
            return json.dumps(entry).encode(), "application/json", 200
        if path.startswith("/debug/export"):
            since = self._query_int(path, "since", 0)
            entries, next_cursor, truncated = (
                self.flight_recorder.export_slices(
                    since_seq=since,
                    max_bytes=self._query_int(
                        path, "max_bytes", self.EXPORT_MAX_BYTES
                    ),
                )
            )
            lines = [
                json.dumps(e, sort_keys=True, separators=(",", ":"))
                for e in entries
            ]
            if truncated:
                # trailer line, still valid JSONL: consumers resume from
                # next_cursor without re-shipping the prefix
                lines.append(json.dumps(
                    {"truncated": True, "next_cursor": next_cursor},
                    sort_keys=True, separators=(",", ":"),
                ))
            body = ("".join(line + "\n" for line in lines)).encode()
            return body, "application/x-ndjson", 200
        if path.startswith("/debug/engine"):
            if self.engine_sampler is None:
                return b"no engine sampler attached", "text/plain", 404
            if self.engine_sampler.samples_taken == 0:
                # cold sampler (queried before its first interval): tick
                # it once so the endpoint answers with data, not an empty
                # ring — sample_once is read-only against the engine
                try:
                    self.engine_sampler.sample_once()
                except Exception:
                    logger.exception("cold engine sample failed")
            return (
                json.dumps(self.engine_sampler.series()).encode(),
                "application/json",
                200,
            )
        if path.startswith("/debug/profile"):
            if self.engine_profiler is None:
                return b"no engine profiler attached", "text/plain", 404
            return (
                json.dumps(self.engine_profiler.snapshot()).encode(),
                "application/json",
                200,
            )
        if path.startswith("/debug/slo"):
            if self.slo_engine is None:
                return b"no slo engine attached", "text/plain", 404
            return (
                json.dumps(self.slo_engine.snapshot()).encode(),
                "application/json",
                200,
            )
        if path.startswith("/debug/blackbox"):
            if self.blackbox_provider is None:
                return b"no persistent black-box attached", "text/plain", 404
            dump = self.blackbox_provider()
            if dump is None:
                return (
                    b"no black-box dump yet (no residency, or telemetry "
                    b"off)",
                    "text/plain",
                    404,
                )
            return json.dumps(dump).encode(), "application/json", 200
        return b"not found", "text/plain", 404

    def start(self) -> None:
        self._thread.start()
        logger.info(
            "metrics endpoint on :%d (/metrics /healthz /stats /debug/*)",
            self.port,
        )

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        # Attached background components stop WITH the server (idempotent
        # — callers that own them may stop them again): `cli run` exits
        # and tests previously leaked the sampler's daemon thread when a
        # teardown path missed its own stop call.
        if self.engine_sampler is not None:
            self.engine_sampler.stop()
        if self.slo_engine is not None and hasattr(self.slo_engine, "stop"):
            self.slo_engine.stop()
