"""Pareto-front utilities for (latency, energy) design points."""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

from .simulator import SimReport


def is_dominated(a: Tuple[float, float], b: Tuple[float, float]) -> bool:
    """True if point `a` is dominated by `b` (b no worse in both, better in one)."""
    return (b[0] <= a[0] and b[1] <= a[1]) and (b[0] < a[0] or b[1] < a[1])


def pareto_front(points: Sequence[Tuple[float, float]]) -> List[int]:
    """Indices of non-dominated (latency, energy) points, sorted by latency."""
    idx = sorted(range(len(points)), key=lambda i: (points[i][0], points[i][1]))
    front: List[int] = []
    best_e = float("inf")
    for i in idx:
        if points[i][1] < best_e:
            front.append(i)
            best_e = points[i][1]
    return front


def pareto_reports(reports: Iterable[SimReport]) -> List[SimReport]:
    reps = list(reports)
    pts = [(r.latency_s, r.energy_j) for r in reps]
    return [reps[i] for i in pareto_front(pts)]
