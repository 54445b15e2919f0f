"""Operation schema for recorded histories.

The port's own copy of the JAX package's op model
(``jepsen_tpu/history/ops.py``), with the same integer codes, so that the
two packages pack a history to the same bytes.  An op is
``{:type, :f, :value, :process, :time, :error?}`` where

- ``type``  ∈ {invoke, ok, fail, info}.  ``info`` marks an *indeterminate*
  completion (e.g. a publish-confirm timeout).
- ``f``     ∈ {enqueue, dequeue, drain} for clients, {start, stop} for the
  nemesis, {log, sleep} for bookkeeping, plus the stream, transactional
  and mutex workloads' functions.
- ``value`` — an int for enqueue/dequeue; a list of ints for a drain
  completion; None for bare dequeue invocations.
- ``process`` — the logical process (worker) id; -1 for the nemesis.
- ``time`` — nanoseconds since test start (Jepsen convention).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Iterable


NO_VALUE = -1  # packed-tensor sentinel for "no value" (nil)
NEMESIS_PROCESS = -1


class OpType(enum.IntEnum):
    """Op lifecycle phase.  Integer codes are the packed-tensor encoding."""

    INVOKE = 0
    OK = 1
    FAIL = 2
    INFO = 3  # indeterminate — the op may or may not have taken effect

    @classmethod
    def from_name(cls, name: str) -> "OpType":
        return _TYPE_BY_NAME[name]


class OpF(enum.IntEnum):
    """Op function.  Integer codes are the packed-tensor encoding."""

    ENQUEUE = 0
    DEQUEUE = 1
    DRAIN = 2
    # nemesis / bookkeeping ops (excluded from client-op kernels by mask)
    START = 3
    STOP = 4
    LOG = 5
    # stream workload: APPEND publishes to a log, READ observes it
    APPEND = 6
    READ = 7
    # transactional workload: value is a list of micro-ops
    TXN = 8
    # mutex workload
    ACQUIRE = 9
    RELEASE = 10

    @classmethod
    def from_name(cls, name: str) -> "OpF":
        return _F_BY_NAME[name]


_TYPE_BY_NAME = {t.name.lower(): t for t in OpType}
_F_BY_NAME = {f.name.lower(): f for f in OpF}

CLIENT_FS = (
    OpF.ENQUEUE,
    OpF.DEQUEUE,
    OpF.DRAIN,
    OpF.APPEND,
    OpF.READ,
    OpF.TXN,
    OpF.ACQUIRE,
    OpF.RELEASE,
)


@dataclass
class Op:
    """One history entry.

    ``index`` is the position in the recorded history (assigned by the
    recorder, monotonically increasing over invocations *and* completions).
    """

    type: OpType
    f: OpF
    process: int
    value: Any = None  # int | list[int] | str | None
    time: int = -1  # ns since test start
    index: int = -1
    error: Any = None

    @classmethod
    def invoke(cls, f: OpF, process: int, value: Any = None, **kw: Any) -> "Op":
        return cls(OpType.INVOKE, f, process, value, **kw)

    def complete(
        self, type: OpType, value: Any = None, time: int = -1, error: Any = None
    ) -> "Op":
        """Build the completion op for this invocation."""
        return Op(
            type=type,
            f=self.f,
            process=self.process,
            value=self.value if value is None else value,
            time=time,
            error=error,
        )

    @property
    def is_invoke(self) -> bool:
        return self.type == OpType.INVOKE

    @property
    def is_ok(self) -> bool:
        return self.type == OpType.OK

    @property
    def is_fail(self) -> bool:
        return self.type == OpType.FAIL

    @property
    def is_info(self) -> bool:
        return self.type == OpType.INFO

    @property
    def is_client_op(self) -> bool:
        return self.process != NEMESIS_PROCESS and self.f in CLIENT_FS

    def to_json(self) -> dict:
        d = {
            "index": self.index,
            "type": self.type.name.lower(),
            "f": self.f.name.lower(),
            "process": self.process,
            "time": self.time,
        }
        if self.value is not None:
            d["value"] = self.value
        if self.error is not None:
            d["error"] = self.error
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Op":
        return cls(
            type=OpType.from_name(d["type"]),
            f=OpF.from_name(d["f"]),
            process=d.get("process", NEMESIS_PROCESS),
            value=d.get("value"),
            time=d.get("time", -1),
            index=d.get("index", -1),
            error=d.get("error"),
        )


def reindex(history: Iterable[Op]) -> list[Op]:
    """Assign sequential indices to a history (in recorded order)."""
    out = []
    for i, op in enumerate(history):
        op.index = i
        out.append(op)
    return out


def workload_of(history) -> str:
    """Classify a history's workload family by the client op kinds it
    contains."""
    for op in history:
        if op.f in (OpF.APPEND, OpF.READ):
            return "stream"
        if op.f == OpF.TXN:
            return "elle"
        if op.f in (OpF.ACQUIRE, OpF.RELEASE):
            return "mutex"
    return "queue"
