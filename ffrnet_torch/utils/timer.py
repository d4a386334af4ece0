"""Wall-clock section timing for the train loop (a copy of
ffrnet_tpu/utils/timer.py).

Monotonic clock, context-manager or mark-style sections. The one-line
summary has the reference timer's fields: timestamp, Elapse, TimeLeft (the
latest per-iteration total x iterations left), IterTotal and the
per-section times, so run logs of the two packages compare.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from datetime import datetime, timedelta
from typing import Callable, Dict, Iterator


class Timer:
    """Tracks named wall-clock sections within a loop iteration.

    Two recording styles, freely mixable:

    * scoped:     ``with timer.section("Forward"): ...``
    * mark-style: ``timer.update_time("DataTime")`` records the time since
      the previous mark (or since construction/reset for the first mark).

    Each section keeps its *latest* duration (one value per iteration), so a
    long-running loop that never resets still reports the current iteration's
    cost — the property the ETA estimate relies on. Total run time is counted
    from construction on the monotonic clock (immune to wall-clock jumps).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._run_started = clock()
        self._last_mark = self._run_started
        self._sections: Dict[str, float] = {}

    # -- recording ---------------------------------------------------------

    def reset_timer(self) -> None:
        """Drop all sections and restart the mark cursor (not run elapsed)."""
        self._sections.clear()
        self._last_mark = self._clock()

    @contextmanager
    def section(self, name: str) -> Iterator[None]:
        begin = self._clock()
        try:
            yield
        finally:
            self._sections[name] = self._clock() - begin
            self._last_mark = self._clock()

    def update_time(self, name: str) -> None:
        now = self._clock()
        self._sections[name] = now - self._last_mark
        self._last_mark = now

    # -- derived quantities --------------------------------------------------

    @property
    def elapsed(self) -> float:
        """Seconds since this Timer was constructed."""
        return self._clock() - self._run_started

    @property
    def iter_total(self) -> float:
        """Sum of the latest duration of every section (≈ one iteration)."""
        return sum(self._sections.values())

    def eta(self, iters_left: int) -> float:
        """Projected seconds remaining at the current per-iteration cost."""
        return self.iter_total * max(int(iters_left), 0)

    # -- reporting -----------------------------------------------------------

    def to_string(self, iters_left: int, short: bool = False) -> str:
        names = "|".join(self._sections)
        fields = [
            f"{datetime.now():%Y-%m-%d %H:%M:%S}",
            f"Elapse: {timedelta(seconds=round(self.elapsed))}",
            f"TimeLeft: {timedelta(seconds=round(self.eta(iters_left)))}",
        ]
        if short:
            fields.append(f"{names}: {self.iter_total:.2f}s")
        else:
            fields.append(f"IterTotal: {self.iter_total:.2f}s")
            per_section = " ".join(f"{v:.2f}s" for v in self._sections.values())
            fields.append(f"{names}: {per_section}")
        return "\t".join(fields)
