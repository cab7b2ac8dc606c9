"""OpenMetrics text exposition for a MetricsRegistry (the port's copy of
deeplearning4j_tpu/telemetry/prometheus.py): `# HELP` / `# TYPE`
headers, one sample line per label-set, histograms as cumulative
`_bucket{le=...}` series (with their exemplars) plus `_sum` and `_count`,
counter families without the `_total` sample suffix, and `# EOF`.
"""
from __future__ import annotations

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def _escape_help(s):
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s):
    return str(s).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _fmt_value(v):
    if v is None:
        return "NaN"
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels, extra=None):
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(items.items()))
    return "{" + body + "}"


def _le(bound):
    return "+Inf" if bound == float("inf") else _fmt_value(bound)


def _bucket_exemplar(exemplars, lo, hi):
    """Latest exemplar whose value falls in this bucket's (lo, hi] range,
    rendered as the OpenMetrics ` # {...} value ts` suffix (or "")."""
    for e in reversed(exemplars):
        if lo < e["value"] <= hi:
            return (f' # {{trace_id="{_escape_label(e["trace_id"])}"}}'
                    f' {_fmt_value(e["value"])} {_fmt_value(e["time"])}')
    return ""


def render(registry) -> str:
    """The full exposition text for every instrument in `registry`."""
    lines = []
    for m in registry.collect():
        # OpenMetrics counters: the `_total` suffix belongs to the SAMPLE,
        # not the family — `# TYPE requests counter` / `requests_total 5`
        family = m.name
        sample = m.name
        if m.kind == "counter":
            family = m.name[:-6] if m.name.endswith("_total") else m.name
            sample = family + "_total"
        lines.append(f"# HELP {family} {_escape_help(m.help)}")
        lines.append(f"# TYPE {family} {m.kind}")
        if m.kind == "histogram":
            for labels, data in m.series():
                exemplars = data.get("exemplars", ())
                lo = float("-inf")
                for bound, cum in data["buckets"]:
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(labels, {'le': _le(bound)})}"
                        f" {_fmt_value(cum)}"
                        f"{_bucket_exemplar(exemplars, lo, bound)}")
                    lo = bound
                lines.append(f"{m.name}_sum{_fmt_labels(labels)}"
                             f" {_fmt_value(data['sum'])}")
                lines.append(f"{m.name}_count{_fmt_labels(labels)}"
                             f" {_fmt_value(data['count'])}")
        else:
            series = m.series()
            if not series:
                continue
            for labels, value in series:
                lines.append(f"{sample}{_fmt_labels(labels)}"
                             f" {_fmt_value(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"
