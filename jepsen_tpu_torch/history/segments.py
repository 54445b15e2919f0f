"""Fixed-shape segment streaming over recorded histories.

The port's own copy of the JAX package's ``history/segments.py``.  A
recorded ``history.jsonl`` is read one segment of ``segment_ops`` ops
(= non-blank JSONL lines) at a time, without ever holding the whole op
list: peak host memory is one segment of ``Op`` objects plus the
checker's carry (``checkers/segmented.py``).

Every segment carries the source anchor the checkpoint contract needs:
the byte offset one past the segment's last line and the SHA-256 of
every source byte up to that offset, kept incrementally as the file
streams.  A resume hashes exactly the consumed prefix again and refuses
to continue over a mismatch, so a rewritten or truncated source is never
grafted onto another run's carry.

A line that fails to parse raises :class:`SegmentPoisonError` with the
line number and the parse error as evidence; the segmented checker
quarantines from there (unknown with evidence, never a silent
truncation).  A torn final line of a file at rest is the same poison.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

from jepsen_tpu_torch.history.ops import Op


class SegmentPoisonError(Exception):
    """A segment's source bytes cannot be decoded into ops.

    Carries the evidence the quarantine reports: the 0-based segment
    index, the 1-based source line number, and the underlying error."""

    def __init__(self, segment_idx: int, line_no: int, error: str):
        self.segment_idx = segment_idx
        self.line_no = line_no
        self.error = error
        super().__init__(
            f"segment {segment_idx}: line {line_no}: {error}"
        )


class SourceMismatchError(Exception):
    """The source prefix no longer hashes to the checkpoint's digest."""


@dataclass
class Segment:
    """``segment_ops`` consecutive ops of one history (the last segment
    may be short), plus the source anchor through its final byte."""

    idx: int  # 0-based segment index
    ops: list[Op]
    start_op: int  # global op index of ops[0]
    byte_end: int  # one-past the last consumed source byte
    sha256: str  # hex digest of source bytes [0, byte_end)
    final: bool = False  # True on the last segment of the file
    line_end: int = 0  # 1-based line number of the last consumed line
    extra: dict = field(default_factory=dict)


def _parse_line(raw: bytes, seg_idx: int, line_no: int) -> Op:
    try:
        return Op.from_json(json.loads(raw))
    except Exception as e:  # noqa: BLE001 - rewrapped as poison evidence
        raise SegmentPoisonError(
            seg_idx, line_no, f"{type(e).__name__}: {e}"
        ) from e


def prefix_sha256(path: str | Path, nbytes: int) -> str:
    """SHA-256 of the first ``nbytes`` bytes of ``path`` (the resume
    validation read — O(prefix), no parse)."""
    h = hashlib.sha256()
    left = nbytes
    with open(path, "rb") as fh:
        while left > 0:
            chunk = fh.read(min(1 << 20, left))
            if not chunk:
                raise SourceMismatchError(
                    f"{path}: only {nbytes - left} of the {nbytes} "
                    f"checkpointed prefix bytes exist (source truncated)"
                )
            h.update(chunk)
            left -= len(chunk)
    return h.hexdigest()


def iter_segments(
    path: str | Path,
    segment_ops: int,
    start_segment: int = 0,
    expect_sha256: str | None = None,
    expect_bytes: int | None = None,
) -> Iterator[Segment]:
    """Stream ``path`` as :class:`Segment`\\ s of ``segment_ops`` ops.

    ``start_segment`` resumes mid-file: the skipped prefix is *hashed
    but not parsed* (cheap fast-forward), and when ``expect_sha256``/
    ``expect_bytes`` are given — the checkpoint's anchor — the prefix
    must land on exactly that (offset, digest) pair or
    :class:`SourceMismatchError` refuses the resume.

    Empty/whitespace lines are skipped for op counting (matching
    ``read_history_jsonl``) but still hashed — the anchor always covers
    every source byte.  A non-empty line that fails to parse raises
    :class:`SegmentPoisonError`; a torn final line (no trailing
    newline, unparseable) is the same poison, because an at-rest file
    that ends mid-record IS corrupt.
    """
    if segment_ops <= 0:
        raise ValueError(f"segment_ops must be positive, got {segment_ops}")
    path = Path(path)
    h = hashlib.sha256()
    consumed = 0
    line_no = 0
    skip_ops = start_segment * segment_ops
    skipped = 0
    idx = start_segment
    ops: list[Op] = []
    start_op = skip_ops
    with open(path, "rb") as fh:
        while True:
            line = fh.readline()
            if not line:
                break
            h.update(line)
            consumed += len(line)
            line_no += 1
            raw = line.strip()
            if not raw:
                continue
            if skipped < skip_ops:
                # fast-forward: count + hash, never parse
                skipped += 1
                if skipped == skip_ops:
                    if expect_bytes is not None and consumed != expect_bytes:
                        raise SourceMismatchError(
                            f"{path}: resume anchor expects byte offset "
                            f"{expect_bytes} after segment "
                            f"{start_segment - 1}, file has {consumed}"
                        )
                    if (
                        expect_sha256 is not None
                        and h.hexdigest() != expect_sha256
                    ):
                        raise SourceMismatchError(
                            f"{path}: source prefix sha256 diverged from "
                            f"the checkpoint anchor (the recorded bytes "
                            f"changed; refusing to resume)"
                        )
                continue
            ops.append(_parse_line(raw, idx, line_no))
            if len(ops) == segment_ops:
                yield Segment(
                    idx=idx,
                    ops=ops,
                    start_op=start_op,
                    byte_end=consumed,
                    sha256=h.hexdigest(),
                    final=False,
                    line_end=line_no,
                )
                start_op += len(ops)
                ops = []
                idx += 1
    if skip_ops and skipped < skip_ops:
        # fewer ops than start_segment full segments: legal in exactly
        # one shape — the checkpoint was written at the FINAL (short)
        # segment, so the whole file is the consumed prefix and the
        # anchor must land on EOF exactly.  Anything else is a
        # truncated/mutated source and refuses.
        if (
            expect_bytes is not None
            and consumed == expect_bytes
            and (expect_sha256 is None or h.hexdigest() == expect_sha256)
        ):
            yield Segment(
                idx=idx,
                ops=[],
                start_op=skipped,
                byte_end=consumed,
                sha256=h.hexdigest(),
                final=True,
                line_end=line_no,
            )
            return
        raise SourceMismatchError(
            f"{path}: resume expects >= {skip_ops} ops before segment "
            f"{start_segment}, file holds {skipped}"
        )
    # the final (possibly short, possibly empty) segment: always yielded
    # so the caller learns the end-of-file anchor even for an op count
    # that divides evenly
    yield Segment(
        idx=idx,
        ops=ops,
        start_op=start_op,
        byte_end=consumed,
        sha256=h.hexdigest(),
        final=True,
        line_end=line_no,
    )
