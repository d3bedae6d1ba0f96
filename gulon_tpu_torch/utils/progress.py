"""ANSI progress rendering + stage timing for the CLI.

Counterpart of reference ``command/CommandUtils.scala``: a 20-char progress
bar with cursor control (``CommandUtils.scala:22-48``), colored
RUNNING/SUCCESS/ERROR stage lines (``:75-82``), the ``logTask`` timing
wrapper (``:99-110``), and byte/duration formatters (``:15-20, 84-97``).
A copy of ``gulon_tpu/utils/progress.py``, so the port stands alone.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Iterator, Optional, TextIO

_BAR_WIDTH = 20

GREEN = "\033[32m"
RED = "\033[31m"
YELLOW = "\033[33m"
RESET = "\033[0m"
CLEAR_LINE = "\033[2K\r"


def format_bytes(n: float) -> str:
    """Human-readable byte count (``CommandUtils.scala:15-20``)."""
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}PiB"


def format_duration(seconds: float) -> str:
    """Compact duration (``CommandUtils.scala:84-97``)."""
    if seconds < 1e-3:
        return f"{seconds * 1e6:.0f}us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.0f}ms"
    if seconds < 60.0:
        return f"{seconds:.1f}s"
    minutes, secs = divmod(seconds, 60.0)
    if minutes < 60:
        return f"{int(minutes)}m{secs:.0f}s"
    hours, minutes = divmod(minutes, 60.0)
    return f"{int(hours)}h{int(minutes)}m"


def render_bar(fraction: float, width: int = _BAR_WIDTH) -> str:
    """``[=====>    ]`` 20-char bar (``CommandUtils.scala:22-48``)."""
    fraction = min(max(fraction, 0.0), 1.0)
    filled = int(fraction * width)
    head = ">" if 0 < filled < width else ""
    body = "=" * (filled - (1 if head else 0)) + head
    return f"[{body:<{width}}] {fraction * 100:3.0f}%"


class Reporter:
    """Stateful progress-line writer; silent when not a TTY."""

    def __init__(self, out: Optional[TextIO] = None, force: bool = False):
        self.out = out if out is not None else sys.stderr
        self.enabled = force or self.out.isatty()
        self._line_open = False

    def progress(self, label: str, fraction: Optional[float], detail: str = ""):
        if not self.enabled:
            return
        if fraction is None:
            bar = "[ running ]"
        else:
            bar = render_bar(fraction)
        self.out.write(f"{CLEAR_LINE}{YELLOW}RUNNING{RESET} {label} {bar} {detail}")
        self.out.flush()
        self._line_open = True

    def _close_line(self):
        if self._line_open and self.enabled:
            self.out.write(CLEAR_LINE)
            self._line_open = False

    def success(self, label: str, elapsed: float):
        self._close_line()
        self.out.write(
            f"{GREEN}SUCCESS{RESET} {label} in {format_duration(elapsed)}\n"
        )
        self.out.flush()

    def error(self, label: str, elapsed: float, err: BaseException):
        self._close_line()
        self.out.write(
            f"{RED}ERROR{RESET} {label} after {format_duration(elapsed)}: {err}\n"
        )
        self.out.flush()

    @contextlib.contextmanager
    def task(self, label: str) -> Iterator["Reporter"]:
        """``logTask``: RUNNING line while active, SUCCESS/ERROR with timing."""
        start = time.monotonic()
        self.progress(label, None)
        try:
            yield self
        except BaseException as e:
            self.error(label, time.monotonic() - start, e)
            raise
        self.success(label, time.monotonic() - start)
