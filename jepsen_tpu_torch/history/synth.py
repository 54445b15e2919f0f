"""Synthetic quorum-queue histories with injectable anomalies.

The queue part of the JAX package's ``history/synth.py``.  It makes the
same ``random.Random(seed)`` calls in the same order, so a spec yields the
same history in both packages.  N worker processes issue enqueues (values
from one incrementing counter) and dequeues against a queue, with
indeterminate enqueues (publish-confirm timeouts → ``info``), failed ops
and a final per-thread drain; then chosen anomaly counts are injected:

- ``lost``        — acknowledged enqueues whose value is silently dropped
- ``duplicated``  — values delivered twice
- ``unexpected``  — reads of values never attempted
- ``phantom_fail``— reads of values whose enqueue definitely failed
- ``causality``   — a read that completes before its enqueue is invoked

Every injected anomaly is reported back as ground truth.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any

from jepsen_tpu_torch.history.ops import Op, OpF, OpType, reindex


@dataclass
class SynthSpec:
    n_processes: int = 5
    n_ops: int = 200  # client invocations before drain
    p_enqueue: float = 0.5
    p_enq_info: float = 0.03  # confirm timeout; effect coin-flipped
    p_enq_fail: float = 0.02  # definite failure, no effect
    p_deq_fail: float = 0.05  # :exhausted / timeout
    drain: bool = True
    mean_latency_ns: int = 2_000_000
    seed: int = 0
    # anomaly injection counts
    lost: int = 0
    duplicated: int = 0
    unexpected: int = 0
    phantom_fail: int = 0
    causality: int = 0


@dataclass
class SynthHistory:
    ops: list[Op]
    # ground truth
    lost: set[int] = field(default_factory=set)
    duplicated: set[int] = field(default_factory=set)
    unexpected: set[int] = field(default_factory=set)
    phantom_fail: set[int] = field(default_factory=set)
    causality: set[int] = field(default_factory=set)

    @property
    def clean(self) -> bool:
        return not (
            self.lost
            or self.duplicated
            or self.unexpected
            or self.phantom_fail
            or self.causality
        )


def synth_history(spec: SynthSpec) -> SynthHistory:
    if not spec.drain and (
        spec.lost or spec.duplicated or spec.unexpected or spec.phantom_fail
    ):
        # these injections only materialize via the drain phase
        raise ValueError("anomaly injection requires drain=True")
    rng = random.Random(spec.seed)
    next_value = 0
    clock = 0
    queue: list[int] = []  # values visible to dequeuers
    acked: list[int] = []  # values whose enqueue was confirmed
    failed_enq: list[int] = []
    ops: list[Op] = []
    out = SynthHistory(ops=ops)

    def tick() -> int:
        nonlocal clock
        clock += rng.randint(100_000, 2_000_000)
        return clock

    def lat() -> int:
        return max(1, int(rng.expovariate(1.0 / spec.mean_latency_ns)))

    def emit(op: Op) -> Op:
        ops.append(op)
        return op

    # -- phase 1: concurrent-ish enqueue/dequeue mix ----------------------
    for _ in range(spec.n_ops):
        p = rng.randrange(spec.n_processes)
        t0 = tick()
        if rng.random() < spec.p_enqueue:
            v = next_value
            next_value += 1
            inv = emit(Op.invoke(OpF.ENQUEUE, p, v, time=t0))
            roll = rng.random()
            if roll < spec.p_enq_fail:
                emit(inv.complete(OpType.FAIL, time=t0 + lat(), error="publish-failed"))
                failed_enq.append(v)
            elif roll < spec.p_enq_fail + spec.p_enq_info:
                emit(inv.complete(OpType.INFO, time=t0 + lat(), error="timeout"))
                if rng.random() < 0.5:  # indeterminate op took effect
                    queue.append(v)
            else:
                emit(inv.complete(OpType.OK, time=t0 + lat()))
                queue.append(v)
                acked.append(v)
        else:
            inv = emit(Op.invoke(OpF.DEQUEUE, p, time=t0))
            if queue and rng.random() >= spec.p_deq_fail:
                v = queue.pop(rng.randrange(len(queue)))
                emit(inv.complete(OpType.OK, value=v, time=t0 + lat()))
            else:
                emit(
                    inv.complete(
                        OpType.FAIL, value=None, time=t0 + lat(), error="exhausted"
                    )
                )

    # -- anomaly injection -------------------------------------------------
    in_queue_acked = [v for v in queue if v in set(acked)]
    rng.shuffle(in_queue_acked)
    for _ in range(spec.lost):
        if not in_queue_acked:
            break
        v = in_queue_acked.pop()
        queue.remove(v)
        out.lost.add(v)

    delivered = [op.value for op in ops if op.f == OpF.DEQUEUE and op.is_ok]
    rng.shuffle(delivered)
    for _ in range(spec.duplicated):
        if not delivered:
            break
        v = delivered.pop()
        queue.append(v)  # broker re-delivers: value comes out again
        out.duplicated.add(v)

    for _ in range(spec.unexpected):
        v = next_value + 1000 + len(out.unexpected)  # never attempted
        queue.append(v)
        out.unexpected.add(v)

    rng.shuffle(failed_enq)
    for _ in range(spec.phantom_fail):
        if not failed_enq:
            break
        v = failed_enq.pop()
        queue.append(v)
        out.phantom_fail.add(v)

    if spec.causality:
        # a value "read" before its enqueue was ever invoked
        for _ in range(spec.causality):
            v = next_value
            next_value += 1
            p = rng.randrange(spec.n_processes)
            t_read = tick()
            emit(Op.invoke(OpF.DEQUEUE, p, time=t_read))
            emit(Op(OpType.OK, OpF.DEQUEUE, p, v, time=t_read + lat()))
            t_enq = tick() + 10_000_000  # invoked strictly after the read
            emit(Op.invoke(OpF.ENQUEUE, p, v, time=t_enq))
            emit(Op(OpType.OK, OpF.ENQUEUE, p, v, time=t_enq + lat()))
            acked.append(v)
            out.causality.add(v)

    # -- phase 4: per-thread drain ----------------------------------------
    if spec.drain:
        rng.shuffle(queue)
        per = {p: [] for p in range(spec.n_processes)}
        for i, v in enumerate(queue):
            per[i % spec.n_processes].append(v)
        for p in range(spec.n_processes):
            t0 = tick()
            emit(Op.invoke(OpF.DRAIN, p, time=t0))
            emit(Op(OpType.OK, OpF.DRAIN, p, per[p], time=t0 + lat()))
        queue.clear()

    reindex(ops)
    return out


def synth_batch(
    n: int, base: SynthSpec | None = None, **overrides: Any
) -> list[SynthHistory]:
    """Generate ``n`` histories with varying seeds."""
    base = base or SynthSpec()
    out = []
    for i in range(n):
        kw = {**base.__dict__, **overrides, "seed": base.seed + i}
        out.append(synth_history(SynthSpec(**kw)))
    return out
