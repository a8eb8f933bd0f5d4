"""Registry exporters: Prometheus text exposition, JSON, scrape endpoint.

Stdlib-only.  Histograms export as Prometheus *summaries* (precomputed
quantiles over the bounded reservoir) — ``name{quantile="0.5"}`` rows
plus ``name_sum`` / ``name_count`` — counters and gauges as themselves.

:func:`start_metrics_server` serves ``/metrics`` (text exposition,
version 0.0.4) and ``/metrics.json`` (the registry snapshot) from a
daemon-threaded ``http.server``; ``port=0`` binds an ephemeral port
(``server.port`` reports it), which is what the CI smoke uses.
:func:`parse_prometheus` is the matching minimal parser the smoke and
tests validate the exposition with.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from .metrics import Registry, get_registry

_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def to_prometheus(registry: Optional[Registry] = None) -> str:
    """Render the registry in Prometheus text exposition format 0.0.4."""
    registry = registry if registry is not None else get_registry()
    lines: List[str] = []
    for name, kind, help, rows in registry.collect():
        if help:
            lines.append(f"# HELP {name} {help}")
        prom_type = {"counter": "counter", "gauge": "gauge",
                     "histogram": "summary"}[kind]
        lines.append(f"# TYPE {name} {prom_type}")
        for labels, samples in rows:
            if kind == "histogram":
                for q, key in _QUANTILES:
                    ql = dict(labels)
                    ql["quantile"] = q
                    lines.append(f"{name}{_fmt_labels(ql)} {_fmt_value(samples[key])}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(samples['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {_fmt_value(samples['count'])}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(samples['value'])}")
    return "\n".join(lines) + "\n"


def to_json(registry: Optional[Registry] = None, indent: Optional[int] = None) -> str:
    """The registry snapshot as a JSON document."""
    registry = registry if registry is not None else get_registry()
    return json.dumps(registry.snapshot(), indent=indent, sort_keys=True)


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+\d+)?$"  # optional timestamp
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, dict]:
    """Parse a text exposition into ``family -> {type, samples}``.

    ``samples`` is a list of ``(sample_name, labels_dict, value)`` — the
    ``_sum`` / ``_count`` / quantile rows of a summary land under their
    base family.  Raises ``ValueError`` on any malformed line, which is
    exactly what the CI smoke wants from a scrape validation.
    """
    families: Dict[str, dict] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ValueError(f"line {lineno}: malformed TYPE line: {raw!r}")
            families.setdefault(parts[2], {"type": None, "samples": []})
            families[parts[2]]["type"] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {raw!r}")
        name = m.group("name")
        labels = dict(_LABEL_PAIR_RE.findall(m.group("labels") or ""))
        try:
            value = float(m.group("value"))
        except ValueError as e:
            raise ValueError(f"line {lineno}: bad value in {raw!r}") from e
        base = name
        for suffix in ("_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in families:
                base = name[: -len(suffix)]
        families.setdefault(base, {"type": None, "samples": []})
        families[base]["samples"].append((name, labels, value))
    return families


class MetricsServer:
    """Scrape endpoint over ``http.server`` (daemon thread, stdlib-only)."""

    def __init__(self, registry: Optional[Registry] = None, port: int = 0,
                 host: str = "127.0.0.1"):
        registry = registry if registry is not None else get_registry()
        self.registry = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(handler):  # noqa: N805 — http.server API
                if handler.path.split("?")[0] in ("/metrics", "/"):
                    body = to_prometheus(registry).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif handler.path.split("?")[0] == "/metrics.json":
                    body = to_json(registry, indent=2).encode()
                    ctype = "application/json"
                else:
                    handler.send_response(404)
                    handler.end_headers()
                    return
                handler.send_response(200)
                handler.send_header("Content-Type", ctype)
                handler.send_header("Content-Length", str(len(body)))
                handler.end_headers()
                handler.wfile.write(body)

            def log_message(handler, *args):  # silence per-request stderr spam
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-server",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_metrics_server(registry: Optional[Registry] = None,
                         port: int = 0) -> MetricsServer:
    """Start a scrape endpoint; ``port=0`` picks an ephemeral port."""
    return MetricsServer(registry=registry, port=port)
