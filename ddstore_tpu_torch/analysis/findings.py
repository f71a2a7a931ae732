"""Finding record + baseline handling for the static analyzer.

A finding's identity for baseline matching is ``category:file:symbol``
— deliberately NOT the line number, so pre-existing pinned findings
survive unrelated edits that shift lines. The line is carried for
humans (and asserted exact in the fixture tests, where the input is
synthetic and stable).
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from typing import Dict, List, Tuple


@dataclass
class Finding:
    category: str   # guard | lock-order | blocking-under-lock |
    #                 excludes | requires | dtor-order | capi-binding |
    #                 knob-registry | tier1-skip
    file: str       # repo-relative path
    line: int       # 1-based; 0 when the finding is not line-anchored
    symbol: str     # stable anchor, e.g. "TcpTransport::ReadVOn@Conn::fd"
    message: str

    def key(self) -> str:
        return f"{self.category}:{self.file}:{self.symbol}"

    def render(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        return f"[{self.category}] {loc} {self.symbol}\n    {self.message}"


def load_baseline(path: str) -> Dict[str, dict]:
    """baseline.json -> {finding key: entry}. Every entry must carry a
    `reason` — a baseline without one is itself a lint error upstream."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    out = {}
    for e in data.get("findings", []):
        key = f"{e['category']}:{e['file']}:{e['symbol']}"
        out[key] = e
    return out


def diff_baseline(findings: List[Finding], baseline: Dict[str, dict]
                  ) -> Tuple[List[Finding], List[dict]]:
    """(new findings not pinned in the baseline, stale baseline entries
    that no longer fire)."""
    keys = {f.key() for f in findings}
    new = [f for f in findings if f.key() not in baseline]
    stale = [e for k, e in baseline.items() if k not in keys]
    return new, stale


def baseline_entry(f: Finding, reason: str) -> dict:
    d = asdict(f)
    d["reason"] = reason
    return d
