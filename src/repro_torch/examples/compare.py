"""Holds two runs' printed outputs to each other, token by token: a
driver's ``--device cuda`` run against its ``--device cpu`` run, or the
port's driver against the reference's.

Each line splits into numbers and the text between them.  Words,
integers and booleans must be equal; a float must be within ``rtol``
(1e-6) of the other, or ``loose_rtol`` (1e-5) inside a span one of the
driver's ``loose`` patterns names (the availability integral, a float32
sum taken in another order), plus one unit in the last place where both
were printed to the same place: each side is its value rounded to that
place, so two values within rtol of each other can print a unit apart
(0.999695 within 1e-6 of 0.999694 prints 0.99970 and 0.99969 at five
places).  A shortest ``repr`` is its float exactly and gets no unit.

A span one of the driver's ``masks`` matches (a wall time, a rate, the
device's name, a number that follows the random weights or a draw of a
device generator) is replaced by ``<name>`` on both sides before the
comparison: where a pattern has groups, only the groups; a line one of
its ``drop`` patterns matches (a list whose length follows such a draw)
is left out.  Against the reference (``reference=True``) the
``ref_masks`` apply too: numbers that follow the reference's
``jax.random`` draws, which the port draws from its own seeded
generators.

  PYTHONPATH=src python -m repro_torch.examples.compare NAME GOT WANT \
      [--reference]
"""

from __future__ import annotations

import dataclasses
import re
import sys
from typing import Dict, List, Tuple

RTOL = 1e-6
LOOSE_RTOL = 1e-5

_NUMBER = r"\d+(?:,\d{3})*(?:\.\d+)?(?:[eE][-+]?\d+)?"
_TOKEN = re.compile(rf"<[a-z_0-9]+>|{_NUMBER}|[^\s\d]+")
_SECONDS = r"(\d+\.\d+)s\b"


@dataclasses.dataclass(frozen=True)
class Rules:
    masks: Tuple[Tuple[str, str], ...] = ()
    loose: Tuple[str, ...] = ()
    drop: Tuple[str, ...] = ()
    ref_masks: Tuple[Tuple[str, str], ...] = ()


_AVAIL = (r"avail integral (\S+)", r"avail_mean=(\S+)",
          r"availability integral: (\S+)",
          r"t_availability_mean\w*\s+(\S+)")

RULES: Dict[str, Rules] = {
    # the runtime layer samples its RPC stream with a generator on the
    # device: the card's stream can flag one edge more or less
    "harden_fleet": Rules(masks=(
        ("plan_s", rf"rounds \({_SECONDS}\)"),
        ("paper_s", rf"ensemble in {_SECONDS}"),
        ("draws", r"detection: runtime=(\d+)"))),
    "temporal_sweep": Rules(masks=(
        ("sweep_s", rf"scenarios in {_SECONDS}"),
        ("rate", r"\(([\d,]+) scenarios/s\)")), loose=_AVAIL),
    # the Monte-Carlo faults come from a generator on the device
    "chaos_campaign": Rules(masks=(
        ("campaign_s", r"engine evals in (\d+\.\d+)s"),
        ("draws", r"SLA violations: (\d+)/\d+ \((\S+)%\)")),
        drop=(r"^    \w+\s+\d\.\d{3}$",)),
    "live_failover_drill": Rules(masks=(
        ("drill_s", r"drill wall time (\d+\.\d+)s"),
        ("campaign_s", r"campaign wall time (\d+\.\d+)s"))),
    # the CEM populations: a host torch.Generator in the port
    "optimize_capacity": Rules(ref_masks=(
        ("cem", r"-> (\d+\.\d+)x \(optimized\)"),
        ("cem", r"buffer=(\S+), overcommit=(\S+)x, ramp=(\S+), "
                r"evict_lambda=(\S+)$"))),
    # the simulator's draws: a host torch.Generator in the port
    "capacity_planner": Rules(ref_masks=(
        ("draws", r"^  \d\.\d\d   (\s*\d\.\d{4}) (#*)"),)),
    "failover_drill": Rules(masks=(
        ("loss", r"loss (\d+\.\d+)"),)),
    "serve_batched": Rules(masks=(
        ("serve_s", rf"decoded in {_SECONDS}"),
        ("rate", r"\((\d+) tok/s on (.+)\)$"))),
    "quickstart": Rules(masks=(
        ("loss", r"loss: (\d+\.\d+)"),)),
    "train_multihost": Rules(masks=(
        ("loss", r"loss (\d+\.\d+)"),)),
}


def _masked(line: str, masks) -> str:
    for name, pat in masks:
        def sub(m, name=name):
            if not m.re.groups:
                return f"<{name}>"
            out, at = [], m.start()
            for g in range(1, m.re.groups + 1):
                if m.start(g) < 0:
                    continue
                out += [m.string[at:m.start(g)], f"<{name}>"]
                at = m.end(g)
            return "".join(out) + m.string[at:m.end()]
        line = re.sub(pat, sub, line)
    return line


def _tokens(line: str, rules: Rules) -> List[Tuple[str, bool]]:
    """(token, in a loose span) for each token of a masked line."""
    spans = []
    for pat in rules.loose:
        for m in re.finditer(pat, line):
            spans += [m.span(g) for g in range(1, (m.re.groups or 0) + 1)] \
                or [m.span()]
    return [(m.group(), any(a <= m.start() < b for a, b in spans))
            for m in _TOKEN.finditer(line)]


def _number(tok: str):
    if not re.fullmatch(_NUMBER, tok):
        return None
    t = tok.replace(",", "")
    return float(t) if any(c in t for c in ".eE") else int(t)


def _place(tok: str) -> int:
    """The power of ten of a printed number's last place."""
    mant, _, exp = tok.replace(",", "").lower().partition("e")
    return int(exp or 0) - len(mant.partition(".")[2])


def _ulp(x: str, y: str) -> float:
    """One unit in the last place two numbers were printed to, where both
    were printed to the same place (a fixed format); 0 where not: a
    shortest ``repr`` is its float to the last bit."""
    return 10.0 ** _place(x) if _place(x) == _place(y) else 0.0


def differences(name: str, got: str, want: str,
                reference: bool = False) -> List[str]:
    """Every difference between two outputs of driver ``name`` under its
    rules (an empty list when they agree); ``reference``: ``want`` is the
    reference driver's output."""
    rules = RULES[name]
    masks = rules.masks + (rules.ref_masks if reference else ())
    kept = lambda text: [ln for ln in text.splitlines()
                         if not any(re.search(p, ln) for p in rules.drop)]
    a, b = kept(got), kept(want)
    out = []
    if len(a) != len(b):
        out.append(f"{len(a)} lines, want {len(b)}")
    for i, (la, lb) in enumerate(zip(a, b)):
        ta, tb = _tokens(_masked(la, masks), rules), \
            _tokens(_masked(lb, masks), rules)
        bad = len(ta) != len(tb)
        for (x, lx), (y, ly) in zip(ta, tb):
            if bad:
                break
            nx, ny = _number(x), _number(y)
            if isinstance(nx, float) or isinstance(ny, float):
                rtol = LOOSE_RTOL if (lx or ly) else RTOL
                bad = nx is None or ny is None or abs(nx - ny) > (
                    rtol * max(abs(nx), abs(ny)) + _ulp(x, y))
            else:
                bad = x != y
        if bad:
            out.append(f"line {i + 1}: {la!r}, want {lb!r}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    reference = "--reference" in argv
    name, got, want = [a for a in argv if a != "--reference"]
    diffs = differences(name, open(got).read(), open(want).read(),
                        reference)
    for d in diffs:
        print(d)
    return 1 if diffs else 0


if __name__ == "__main__":
    sys.exit(main())
