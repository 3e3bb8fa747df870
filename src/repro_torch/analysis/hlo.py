"""HLO text analysis: collective-traffic extraction from compiled modules.

The port of ``repro.analysis.hlo``: a pure-Python parser of HLO text, the
port's own copy.  The port's collectives are counted as they are made
(``core.distributed.collective_stats``); this parser reads the same
counts out of a module's text, as the reference reads XLA's.

``compiled.as_text()`` is the post-SPMD-partitioning module, so every
cross-device transfer appears as an explicit collective op.  We parse each
op's result/operand shapes and replica groups and convert to *per-device
bytes on the wire* using ring-algorithm costs:

    all-reduce        2 * B * (n-1)/n
    all-gather        B * (n-1)/n          (B = result bytes)
    reduce-scatter    B_in * (n-1)/n       (B_in = operand bytes)
    all-to-all        B * (n-1)/n
    collective-permute B
"""
from __future__ import annotations

import dataclasses
import re

_DTYPE_BYTES = {
    "pred": 1, "s4": 0.5, "u4": 0.5, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(", re.M)
_GROUPS_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def shape_bytes(type_str: str) -> int:
    """Sum byte sizes of all array shapes inside a type string."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        total += int(n * _DTYPE_BYTES[dtype])
    return total


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_kind: dict
    total_wire_bytes: float   # per-device bytes on the wire

    def __str__(self):
        parts = [f"{k}:{v} ({self.bytes_by_kind[k]/1e6:.1f} MB)"
                 for k, v in sorted(self.counts.items())]
        return (f"collectives[{', '.join(parts)}] "
                f"total {self.total_wire_bytes/1e9:.3f} GB/device")


def _group_size(line: str, default_n: int) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    return default_n


_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*(?:\([^{]*)?\{\s*$")
_WHILE_RE = re.compile(
    r"while\(.*?\)[^\n]*?(?:condition=%?([\w.\-]+))[^\n]*?(?:body=%?([\w.\-]+))"
    r"|while\(.*?\)[^\n]*?(?:body=%?([\w.\-]+))[^\n]*?(?:condition=%?([\w.\-]+))")
_CONST_RE = re.compile(r"=\s*s32\[\]\s*constant\((\d+)\)")


def _computation_multipliers(hlo_text: str) -> dict:
    """Trip-count multiplier per computation: a collective inside a scan
    body executes (trip count) times, nested loops multiply.  XLA's own
    cost analysis counts loop bodies once (EXPERIMENTS.md caveat); this is
    the correction for collectives."""
    comp = None
    comp_lines: dict = {}
    whiles = []  # (parent_comp, cond, body)
    for line in hlo_text.splitlines():
        m = _COMP_RE.match(line)
        if m and line.rstrip().endswith("{"):
            comp = m.group(1)
            comp_lines.setdefault(comp, [])
            continue
        if comp is not None:
            comp_lines[comp].append(line)
        if "while(" in line and ("body=" in line or "condition=" in line):
            mc = re.search(r"condition=%?([\w.\-]+)", line)
            mb = re.search(r"body=%?([\w.\-]+)", line)
            if mc and mb and comp:
                whiles.append((comp, mc.group(1), mb.group(1)))

    def trips(cond_name: str) -> int:
        consts = []
        for line in comp_lines.get(cond_name, []):
            consts += [int(x) for x in _CONST_RE.findall(line)]
        return max(consts) if consts else 1

    mult = {name: 1.0 for name in comp_lines}
    # fixpoint propagation (nested whiles)
    for _ in range(8):
        changed = False
        for parent, cond, body in whiles:
            new = mult.get(parent, 1.0) * max(1, trips(cond))
            if body in mult and mult[body] != new:
                mult[body] = new
                changed = True
            elif body not in mult:
                mult[body] = new
                changed = True
        if not changed:
            break
    return mult


def collective_stats(hlo_text: str, default_group: int = 2) -> CollectiveStats:
    counts: dict = {}
    by_kind: dict = {}
    total = 0.0
    mult = _computation_multipliers(hlo_text)
    comp = None
    for line in hlo_text.splitlines():
        mcomp = _COMP_RE.match(line)
        if mcomp and line.rstrip().endswith("{"):
            comp = mcomp.group(1)
        m = _OP_RE.match(line)
        if not m:
            continue
        if "-done(" in line:
            continue  # counted at -start
        type_str, kind = m.group(1), m.group(2)
        k_mult = mult.get(comp, 1.0)
        n = _group_size(line, default_group)
        b_result = shape_bytes(type_str)
        # first operand type for reduce-scatter input volume
        if kind == "reduce-scatter":
            inner = line.split("(", 1)[1]
            b_in = shape_bytes(inner.split(")")[0]) or b_result * n
            wire = b_in * (n - 1) / max(n, 1)
        elif kind == "all-reduce":
            wire = 2.0 * b_result * (n - 1) / max(n, 1)
        elif kind == "collective-permute":
            wire = float(b_result)
        else:  # all-gather, all-to-all
            wire = b_result * (n - 1) / max(n, 1)
        counts[kind] = counts.get(kind, 0) + 1
        by_kind[kind] = by_kind.get(kind, 0.0) + wire * k_mult
        total += wire * k_mult
    return CollectiveStats(counts, by_kind, total)
