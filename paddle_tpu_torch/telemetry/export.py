"""Prometheus-text and JSONL exporters over a MetricRegistry.

Both exporters read live metric objects (not a snapshot) so bucket
layouts are exact; both are pure stdlib.
"""
from __future__ import annotations

import json
import time


def _escape_label_value(v):
    """Prometheus exposition escaping: backslash, double-quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text):
    """HELP-line escaping per the exposition format: backslash and
    newline only (no quote escaping — HELP text is not quoted). A help
    string containing a literal newline would otherwise split into a
    second, unparseable exposition line."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labelnames, labels, extra=()):
    # extra pairs (today only histogram `le` bounds) go through the
    # SAME value escaping as named labels: the exposition format makes
    # no distinction, and an unescaped quote/backslash/newline in any
    # label value splits or corrupts the line for every parser
    pairs = [f'{k}="{_escape_label_value(v)}"'
             for k, v in zip(labelnames, labels)]
    pairs.extend(f'{k}="{_escape_label_value(v)}"' for k, v in extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_bucket_bound(b):
    return repr(float(b))


def export_prometheus(registry) -> str:
    """Render every series in the Prometheus text exposition format."""
    lines = []
    for m in registry.metrics():
        series = m.series()
        if not series:
            continue
        if m.help:
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for labels, value in sorted(series.items()):
            if m.kind == "histogram":
                cum = 0
                for bound, count in zip(
                        m.buckets,
                        (value["buckets"][repr(b)] for b in m.buckets)):
                    cum += count
                    lbl = _fmt_labels(m.labelnames, labels,
                                      [("le", _fmt_bucket_bound(bound))])
                    lines.append(f"{m.name}_bucket{lbl} {cum}")
                lbl = _fmt_labels(m.labelnames, labels, [("le", "+Inf")])
                lines.append(f"{m.name}_bucket{lbl} {value['count']}")
                base = _fmt_labels(m.labelnames, labels)
                lines.append(f"{m.name}_sum{base} {value['sum']}")
                lines.append(f"{m.name}_count{base} {value['count']}")
            else:
                lbl = _fmt_labels(m.labelnames, labels)
                lines.append(f"{m.name}{lbl} {value}")
    return "\n".join(lines) + ("\n" if lines else "")


#: keys dump_jsonl owns on every line — a caller tag must not be able to
#: silently clobber them (a run tagged extra={"value": "r06"} would
#: corrupt every counter in the file undetectably)
_RESERVED_JSONL_KEYS = frozenset(
    {"ts", "metric", "kind", "labels", "value", "buckets",
     "count", "sum", "min", "max", "mean", "p50", "p95", "p99"})


def dump_jsonl(registry, path, mode="a", extra=None) -> int:
    """Append one JSON line per live series to `path`.

    Line shape: {"ts", "metric", "kind", "labels": {name: value}, and
    either "value" (counter/gauge) or the histogram stats dict}. Returns
    the number of lines written. `extra` (a dict) is merged into every
    line — callers tag runs (bench round, step number) that way; a tag
    colliding with a reserved record key raises ValueError instead of
    silently overwriting it."""
    if extra:
        bad = sorted(_RESERVED_JSONL_KEYS & set(extra))
        if bad:
            raise ValueError(
                f"dump_jsonl: extra keys {bad} collide with reserved "
                "record fields — rename the tags (e.g. prefix them: "
                f"{', '.join('tag_' + b for b in bad)})")
    ts = time.time()
    n = 0
    with open(path, mode) as f:
        for m in registry.metrics():
            for labels, value in sorted(m.series().items()):
                rec = {"ts": ts, "metric": m.name, "kind": m.kind,
                       "labels": dict(zip(m.labelnames, labels))}
                if m.kind == "histogram":
                    rec.update({k: v for k, v in value.items()
                                if k != "buckets"})
                    rec["buckets"] = value["buckets"]
                else:
                    rec["value"] = value
                if extra:
                    rec.update(extra)
                f.write(json.dumps(rec) + "\n")
                n += 1
    return n


def load_jsonl(path):
    """Parse a dump_jsonl file back into a list of record dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
