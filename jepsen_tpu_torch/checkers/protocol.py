"""The ``Checker`` protocol and ``compose``.

``check(test, history, opts) -> result-map`` where the result map carries
a ``"valid?"`` key; ``compose`` runs a named map of checkers and merges
their ``"valid?"``.  ``"valid?"`` is tri-state, like jepsen's: ``True``,
``False``, or ``"unknown"``.
"""

from __future__ import annotations

import abc
from typing import Any, Mapping, Sequence

from jepsen_tpu_torch.history.ops import Op

VALID = "valid?"
UNKNOWN = "unknown"


def merge_valid(values) -> Any:
    """jepsen ``checker/merge-valid``: False ≺ "unknown" ≺ True."""
    out: Any = True
    for v in values:
        if v is False or v is None:
            return False
        if v == UNKNOWN:
            out = UNKNOWN
    return out


class Checker(abc.ABC):
    """A pure function of a recorded history."""

    name: str = "checker"

    @abc.abstractmethod
    def check(
        self,
        test: Mapping[str, Any],
        history: Sequence[Op],
        opts: Mapping[str, Any] | None = None,
    ) -> dict[str, Any]:
        """Analyze ``history`` and return a result map with ``"valid?"``."""


class ComposedChecker(Checker):
    name = "compose"

    def __init__(self, checkers: Mapping[str, Checker]):
        self.checkers = dict(checkers)

    def check(self, test, history, opts=None):
        results = {
            name: c.check(test, history, opts) for name, c in self.checkers.items()
        }
        results[VALID] = merge_valid(
            r.get(VALID, False) for r in results.values()
        )
        return results


def compose(checkers: Mapping[str, Checker]) -> Checker:
    """``{:queue (total-queue), :linear (queue)}``-style composition."""
    return ComposedChecker(checkers)
