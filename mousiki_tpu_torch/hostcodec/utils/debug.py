"""TIC/TOC nested timer registry + env-gated stage tracing.

Parity with the reference's silk_tic_toc feature (src/silk/debug.rs:22-70:
named timers with min/max/avg reports) and the env-var-gated stage dumps
(src/test_trace.rs:17-28). Disabled by default; zero overhead when off."""

from __future__ import annotations

import os
import time
from collections import defaultdict

ENABLED = bool(os.environ.get("MOUSIKI_TIC_TOC"))


class TicToc:
    """Nested named timers. Use tic(name)/toc(name) or the context manager."""

    def __init__(self):
        self._starts = {}
        self._stack = []
        self._stats = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])

    def tic(self, name: str) -> None:
        if not ENABLED:
            return
        self._stack.append(name)
        self._starts[name] = time.perf_counter()

    def toc(self, name: str) -> None:
        if not ENABLED:
            return
        t = time.perf_counter() - self._starts.pop(name, time.perf_counter())
        if self._stack and self._stack[-1] == name:
            self._stack.pop()
        s = self._stats[name]
        s[0] += 1
        s[1] += t
        s[2] = min(s[2], t)
        s[3] = max(s[3], t)

    class _Span:
        def __init__(self, reg, name):
            self.reg, self.name = reg, name

        def __enter__(self):
            self.reg.tic(self.name)

        def __exit__(self, *exc):
            self.reg.toc(self.name)
            return False

    def span(self, name: str) -> "TicToc._Span":
        return TicToc._Span(self, name)

    def report(self) -> str:
        lines = [f"{'name':<32} {'count':>8} {'avg_ms':>10} {'min_ms':>10} "
                 f"{'max_ms':>10} {'total_ms':>10}"]
        for name, (n, tot, mn, mx) in sorted(self._stats.items()):
            if n == 0:
                continue
            lines.append(f"{name:<32} {n:>8} {1e3 * tot / n:>10.3f} "
                         f"{1e3 * mn:>10.3f} {1e3 * mx:>10.3f} "
                         f"{1e3 * tot:>10.1f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._stats.clear()
        self._starts.clear()
        self._stack.clear()


GLOBAL = TicToc()
tic = GLOBAL.tic
toc = GLOBAL.toc
span = GLOBAL.span
report = GLOBAL.report


def trace_enabled(var: str) -> bool:
    """Env-gated stage tracing (CELT_TRACE_* style)."""
    return bool(os.environ.get(var))


def trace_println(var: str, msg: str) -> None:
    if trace_enabled(var):
        print(f"[{var}] {msg}")
