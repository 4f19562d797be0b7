"""Minimal 5-field cron parser/scheduler — the port's copy of
``mlrun_tpu/service/cron.py`` (replaces the reference's APScheduler
dependency, server/api/utils/scheduler.py:48)."""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Optional


def _parse_field(field: str, lo: int, hi: int) -> set[int]:
    values: set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            start_s, end_s = part.split("-", 1)
            start, end = int(start_s), int(end_s)
        else:
            start = end = int(part)
        if start < lo or end > hi:
            raise ValueError(f"cron field value out of range [{lo},{hi}]: "
                             f"{part}")
        values.update(range(start, end + 1, step))
    return values


class CronSchedule:
    """minute hour day-of-month month day-of-week."""

    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) != 5:
            raise ValueError(f"cron expression must have 5 fields: '{expr}'")
        self.expr = expr
        self.minutes = _parse_field(fields[0], 0, 59)
        self.hours = _parse_field(fields[1], 0, 23)
        self.days = _parse_field(fields[2], 1, 31)
        self.months = _parse_field(fields[3], 1, 12)
        self.weekdays = _parse_field(fields[4], 0, 6)  # 0 = monday (ISO-1)

    def matches(self, when: datetime) -> bool:
        return (when.minute in self.minutes and when.hour in self.hours
                and when.day in self.days and when.month in self.months
                and when.weekday() in self.weekdays)

    def next_after(self, when: datetime) -> Optional[datetime]:
        """Next matching minute after `when` (searches up to 366 days)."""
        candidate = when.replace(second=0, microsecond=0) + \
            timedelta(minutes=1)
        for _ in range(366 * 24 * 60):
            if self.matches(candidate):
                return candidate
            candidate += timedelta(minutes=1)
        return None

    def min_interval_seconds(self) -> float:
        """Rough lower bound on firing interval (for validation)."""
        if len(self.minutes) > 1:
            sorted_m = sorted(self.minutes)
            gaps = [b - a for a, b in zip(sorted_m, sorted_m[1:])]
            gaps.append(60 - sorted_m[-1] + sorted_m[0])
            return min(gaps) * 60
        if len(self.hours) > 1:
            return 3600
        return 24 * 3600
