"""Small reductions the per-layer metrics share."""

from __future__ import annotations

import statistics


def call_ms(record, part: str):
    """The median device-timeline ms of one call of `part` over a spans
    record, or None when the part never ran."""
    calls = record.get("calls", {}).get(part) if record else None
    if not calls:
        return None
    return statistics.median(ms for _, ms, _ in calls)


def step_ms(record, part: str):
    """The median over the steps that ran `part` of its ms in that step
    (the sum of its calls), or None."""
    calls = record.get("calls", {}).get(part) if record else None
    if not calls:
        return None
    per_step = {}
    for i, ms, _ in calls:
        per_step[i] = per_step.get(i, 0.0) + ms
    return statistics.median(per_step.values())


def peak_bytes(record, part: str):
    """The most device memory allocated while `part` ran, or None."""
    calls = record.get("calls", {}).get(part) if record else None
    peaks = [pk for _, _, pk in calls or () if pk is not None]
    return max(peaks) if peaks else None
