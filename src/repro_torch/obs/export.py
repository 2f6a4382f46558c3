"""Prometheus text exposition + JSONL snapshots (and their validators).

One ``Registry.collect()`` snapshot feeds both exporters, so live
metrics, bench rows and CI artifacts share a single source of truth:

  * :func:`to_prometheus` — the text exposition format (version 0.0.4):
    ``# HELP`` / ``# TYPE`` headers, escaped label values, cumulative
    ``_bucket{le=...}`` / ``_sum`` / ``_count`` histogram series;
  * :func:`write_jsonl` — one JSON object per snapshot appended to a
    ``.jsonl`` file (timestamped, with optional run metadata) for
    offline trajectory analysis;
  * :func:`validate_prometheus` / ``trace.validate_chrome_trace`` —
    format checkers used by tests and the CI smoke step
    (``python -m repro_torch.obs.export --validate metrics.prom
    --validate-trace failover_trace.json``).

Zero third-party deps — stdlib only.
"""

from __future__ import annotations

import json
import math
import re
import time
from typing import Any, Dict, List, Optional, Tuple

from .registry import Registry, default_registry


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Dict[str, str], extra: Tuple[Tuple[str, str], ...] = ()
                ) -> str:
    items = list(labels.items()) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_esc_label(str(v))}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def _fmt_le(le: float) -> str:
    return "+Inf" if math.isinf(le) else f"{le:g}"


def to_prometheus(registry: Optional[Registry] = None) -> str:
    """Render a registry snapshot in the Prometheus text format."""
    reg = registry if registry is not None else default_registry()
    lines: List[str] = []
    for row_name, rows in _group_by_name(reg.collect()):
        kind = rows[0]["kind"]
        help_ = rows[0]["help"]
        if help_:
            lines.append(f"# HELP {row_name} {_esc_help(help_)}")
        lines.append(f"# TYPE {row_name} {kind}")
        for row in rows:
            labels = row["labels"]
            if kind == "histogram":
                for le, c in row["buckets"]:
                    lines.append(
                        f"{row_name}_bucket"
                        f"{_fmt_labels(labels, (('le', _fmt_le(le)),))}"
                        f" {c}")
                lines.append(f"{row_name}_sum{_fmt_labels(labels)}"
                             f" {_fmt_value(row['sum'])}")
                lines.append(f"{row_name}_count{_fmt_labels(labels)}"
                             f" {row['count']}")
            else:
                lines.append(f"{row_name}{_fmt_labels(labels)}"
                             f" {_fmt_value(row['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def _group_by_name(rows: List[Dict[str, Any]]
                   ) -> List[Tuple[str, List[Dict[str, Any]]]]:
    out: List[Tuple[str, List[Dict[str, Any]]]] = []
    for row in rows:
        if out and out[-1][0] == row["name"]:
            out[-1][1].append(row)
        else:
            out.append((row["name"], [row]))
    return out


def write_prometheus(path: str, registry: Optional[Registry] = None) -> str:
    with open(path, "w") as f:
        f.write(to_prometheus(registry))
    return path


def write_jsonl(path: str, registry: Optional[Registry] = None,
                meta: Optional[Dict[str, Any]] = None) -> str:
    """Append one timestamped snapshot object to a JSONL file."""
    reg = registry if registry is not None else default_registry()
    rows = reg.collect()
    for row in rows:                       # JSON has no Infinity
        if "buckets" in row:
            row["buckets"] = [["+Inf" if math.isinf(le) else le, c]
                              for le, c in row["buckets"]]
    snap = {"ts_unix": time.time(), "metrics": rows}
    if meta:
        snap["meta"] = meta
    with open(path, "a") as f:
        f.write(json.dumps(snap) + "\n")
    return path


# ---------------------------------------------------------------------------
# exposition-format parsing + validation
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?'
    r'\s+(?P<value>[^\s]+)(?:\s+(?P<ts>-?\d+))?$')
_LABEL_PAIR_RE = re.compile(
    r'\s*([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"\s*(?:,|$)')
_UNESCAPE_RE = re.compile(r'\\(.)')


def _unescape_label(s: str) -> str:
    # single pass: sequential str.replace would corrupt e.g. a literal
    # backslash followed by 'n' into a newline
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), s)


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    if s == "NaN":
        return math.nan
    return float(s)


def parse_prometheus(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse exposition text into ``{name: {"type":..., "help":...,
    "samples": [(sample_name, labels, value)]}}``.  Raises ``ValueError``
    on malformed lines (validation wraps this)."""
    out: Dict[str, Dict[str, Any]] = {}

    def family(name: str) -> Dict[str, Any]:
        return out.setdefault(
            name, {"type": None, "help": None, "samples": []})

    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            family(parts[0])["help"] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split(" ", 1)
            if len(parts) != 2 or parts[1] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {ln}: bad TYPE line {line!r}")
            family(parts[0])["type"] = parts[1]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: unparseable sample {line!r}")
        name = m.group("name")
        labels: Dict[str, str] = {}
        body = m.group("labels")
        if body is not None:
            pos = 0
            while pos < len(body):
                pm = _LABEL_PAIR_RE.match(body, pos)
                if not pm:
                    raise ValueError(
                        f"line {ln}: bad label syntax in {line!r}")
                labels[pm.group(1)] = _unescape_label(pm.group(2))
                pos = pm.end()
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            stem = name[:-len(suffix)] if name.endswith(suffix) else None
            if stem and out.get(stem, {}).get("type") == "histogram":
                base = stem
                break
        family(base)["samples"].append(
            (name, labels, _parse_value(m.group("value"))))
    return out


def validate_prometheus(text: str) -> List[str]:
    """Check exposition text; returns a list of problems (empty == OK):
    parseable lines, a TYPE for every family, non-negative counters, and
    coherent histograms (cumulative buckets, ``+Inf`` bucket == _count).
    """
    errs: List[str] = []
    try:
        fams = parse_prometheus(text)
    except ValueError as e:
        return [str(e)]
    if not fams:
        return ["no metric families found"]
    for name, fam in fams.items():
        if fam["type"] is None:
            errs.append(f"{name}: no # TYPE line")
            continue
        if not fam["samples"]:
            errs.append(f"{name}: no samples")
            continue
        if fam["type"] == "counter":
            for sname, labels, v in fam["samples"]:
                if not (v >= 0):
                    errs.append(f"{name}{labels}: negative counter {v}")
        if fam["type"] == "histogram":
            series: Dict[Tuple, Dict[str, Any]] = {}
            for sname, labels, v in fam["samples"]:
                key = tuple(sorted((k, vv) for k, vv in labels.items()
                                   if k != "le"))
                s = series.setdefault(key, {"buckets": [], "sum": None,
                                            "count": None})
                if sname.endswith("_bucket"):
                    if "le" not in labels:
                        errs.append(f"{name}{labels}: _bucket without le")
                        continue
                    s["buckets"].append((_parse_value(labels["le"]), v))
                elif sname.endswith("_sum"):
                    s["sum"] = v
                elif sname.endswith("_count"):
                    s["count"] = v
                else:
                    errs.append(f"{name}: stray sample {sname}")
            for key, s in series.items():
                bs = sorted(s["buckets"])
                if not bs or not math.isinf(bs[-1][0]):
                    errs.append(f"{name}{dict(key)}: no +Inf bucket")
                    continue
                counts = [c for _, c in bs]
                if any(b > a for b, a in zip(counts, counts[1:])):
                    errs.append(f"{name}{dict(key)}: non-cumulative buckets")
                if s["count"] is None or s["sum"] is None:
                    errs.append(f"{name}{dict(key)}: missing _sum/_count")
                elif counts[-1] != s["count"]:
                    errs.append(
                        f"{name}{dict(key)}: +Inf bucket {counts[-1]} "
                        f"!= _count {s['count']}")
    return errs


# ---------------------------------------------------------------------------
# CLI: CI smoke validation
# ---------------------------------------------------------------------------

def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Validate observability artifacts")
    ap.add_argument("--validate", metavar="PROM",
                    help="Prometheus text file to validate")
    ap.add_argument("--validate-trace", metavar="JSON",
                    help="Chrome trace JSON file to validate")
    args = ap.parse_args(argv)
    rc = 0
    if args.validate:
        with open(args.validate) as f:
            errs = validate_prometheus(f.read())
        if errs:
            rc = 1
            for e in errs:
                print(f"PROM INVALID: {e}")
        else:
            n = len(parse_prometheus(open(args.validate).read()))
            print(f"prometheus OK: {args.validate} ({n} families)")
    if args.validate_trace:
        from .trace import validate_chrome_trace
        with open(args.validate_trace) as f:
            obj = json.load(f)
        errs = validate_chrome_trace(obj)
        if errs:
            rc = 1
            for e in errs:
                print(f"TRACE INVALID: {e}")
        else:
            print(f"trace OK: {args.validate_trace} "
                  f"({len(obj['traceEvents'])} events)")
    return rc


if __name__ == "__main__":
    raise SystemExit(_main())
