"""Fleet prefix-checkpoint index: resume a segmented check from what the
fleet already proved.

The port's own copy of the JAX package's ``history/prefix_index.py``,
with the same layout, contract digest and entry CRC, so that an index
published by either package serves the other to the same verdict.

Segment checkpoints (``checkers/segmented.py``) anchor every carry on
``(prefix_sha256, offset)``: the SHA-256 of every source byte up to one
past the segment's last line.  This module makes those anchors shared:
every full-segment checkpoint written during a check is also published
into a directory index keyed by content hash only (never by source path
or basename: a ``.prev`` rotation or two histories both named
``history.jsonl`` must never cross-match), so that a re-submitted
history sharing a verified prefix with one checked before (a soak
extended by an hour, a shrink candidate sharing its head with its
parent) resumes from the deepest matching anchor instead of op 0.

Layout::

    <root>/<contract>/<offset:020d>-<prefix_sha256>.json

``contract`` is a digest over ``(substrate, workload, segment_ops,
opts)``: a carry resumes only under the contract it was built with.
The entry name is the anchor; the entry body is the whole CRC'd
checkpoint document.

Lookup is one ascending hash pass over the candidate file's own bytes:
each indexed offset no larger than the file is probed against the
running digest, and the deepest match wins.  Bytes that diverge before
an anchor's offset unmatch it, so a shallower anchor serves instead and
a stale carry is never served.  A matching entry whose body is torn or
corrupt is refused loudly and the next-deepest match is used.

The ``jtc`` substrate anchors on row prefixes instead of source bytes
(``prefix_rows``, ``prefix_sha256`` over the first N rows of the mmap'd
rows section).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

from jepsen_tpu_torch.obs.metrics import REGISTRY

logger = logging.getLogger(__name__)

#: conventional index location under a store tree
DEFAULT_INDEX_DIR = "ckpt_index"

_ENTRY_RE = re.compile(r"^(\d{20})-([0-9a-f]{64})\.json$")
_CHUNK = 1 << 20


class PrefixIndexError(Exception):
    """An index entry is torn, corrupt, or missing its anchor."""


def _entry_crc(doc: dict) -> int:
    """The checkpoint CRC (``segmented._ckpt_crc``): the published body
    is a checkpoint document, checked the same way.  Kept here so that
    ``history/`` never imports ``checkers/``."""
    body = {k: v for k, v in doc.items() if k != "crc32"}
    return zlib.crc32(
        json.dumps(body, sort_keys=True, separators=(",", ":")).encode()
    )


def contract_key(
    substrate: str, workload: str, segment_ops: int, opts: dict
) -> str:
    body = json.dumps(
        [substrate, workload, int(segment_ops), opts],
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.sha256(body.encode()).hexdigest()[:16]


@dataclass
class PrefixHit:
    """The deepest fleet anchor matching a candidate's own bytes."""

    doc: dict  # the full CRC-verified checkpoint document
    offset: int  # bytes (jsonl) or rows (jtc) of the matched prefix
    sha256: str  # digest of the matched prefix
    path: Path  # the index entry served
    refusals: list[str] = field(default_factory=list)

    def provenance(self) -> dict:
        """The honest ``resumed_from_prefix`` field: enough to audit
        exactly which fleet anchor served this carry."""
        return {
            "offset": self.offset,
            "segment_idx": int(self.doc["segment_idx"]),
            "prefix_sha256": self.sha256,
            "substrate": self.doc.get("substrate", "jsonl"),
            "entry": str(self.path),
            "refused_deeper": list(self.refusals),
        }


class PrefixCheckpointIndex:
    """Publish/lookup fleet checkpoint anchors under one directory."""

    def __init__(self, root: str | Path):
        self.root = Path(root)

    # -- publish ----------------------------------------------------------

    def publish(self, doc: dict) -> Path | None:
        """File one checkpoint document under its content anchor.
        Returns the entry path, or None when the doc carries no usable
        anchor.  Idempotent: an existing entry for the same anchor is
        left alone (same anchor ⇒ same prefix ⇒ equivalent carry)."""
        substrate = doc.get("substrate", "jsonl")
        if substrate == "jtc":
            offset = doc.get("prefix_rows")
        else:
            offset = doc.get("source_bytes")
        digest = doc.get("source_sha256")
        if substrate == "jtc":
            digest = doc.get("prefix_sha256", digest)
        if not offset or not digest or "state" not in doc:
            return None
        ck = contract_key(
            substrate, doc["workload"], doc["segment_ops"],
            doc.get("opts", {}),
        )
        d = self.root / ck
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"{int(offset):020d}-{digest}.json"
        if path.exists():
            return path
        body = dict(doc)
        body["crc32"] = _entry_crc(body)
        tmp = d / f".{path.name}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(body, fh, separators=(",", ":"))
        os.replace(tmp, path)
        REGISTRY.counter("prefix_index.publishes").inc()
        return path

    # -- lookup -----------------------------------------------------------

    def _candidates(
        self, substrate: str, workload: str, segment_ops: int,
        opts: dict, max_offset: int,
    ) -> list[tuple[int, str, Path]]:
        d = self.root / contract_key(substrate, workload, segment_ops, opts)
        if not d.is_dir():
            return []
        out = []
        for p in d.iterdir():
            m = _ENTRY_RE.match(p.name)
            if not m:
                continue
            off = int(m.group(1))
            if 0 < off <= max_offset:
                out.append((off, m.group(2), p))
        out.sort()
        return out

    def _read_entry(self, path: Path) -> dict:
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            raise PrefixIndexError(f"{path}: unreadable/torn: {e}") from e
        if not isinstance(doc, dict) or doc.get("crc32") != _entry_crc(doc):
            raise PrefixIndexError(
                f"{path}: CRC mismatch (torn or tampered entry)"
            )
        return doc

    def _serve_deepest(
        self, matches: list[tuple[int, str, Path]]
    ) -> PrefixHit | None:
        """Deepest CRC-valid match; a torn body falls back one match
        shallower, loudly, and never serves a stale carry."""
        refusals: list[str] = []
        for off, dig, p in reversed(matches):
            try:
                doc = self._read_entry(p)
            except PrefixIndexError as e:
                refusals.append(str(e))
                logger.error("prefix index: REFUSED entry: %s", e)
                REGISTRY.counter("prefix_index.refused").inc()
                continue
            REGISTRY.counter("prefix_index.hits").inc()
            return PrefixHit(
                doc=doc, offset=off, sha256=dig, path=p,
                refusals=refusals,
            )
        REGISTRY.counter("prefix_index.misses").inc()
        return None

    def lookup(
        self,
        src: str | Path,
        *,
        workload: str,
        segment_ops: int,
        opts: dict,
    ) -> PrefixHit | None:
        """Deepest ``jsonl`` anchor whose ``(offset, sha256)`` matches
        ``src``'s own bytes — one ascending hash pass, every indexed
        offset ≤ the file size probed against the running digest."""
        src = Path(src)
        try:
            size = src.stat().st_size
        except OSError:
            return None
        cands = self._candidates("jsonl", workload, segment_ops, opts, size)
        if not cands:
            return None
        matches: list[tuple[int, str, Path]] = []
        h = hashlib.sha256()
        pos = 0
        with open(src, "rb") as fh:
            for off, dig, p in cands:
                while pos < off:
                    chunk = fh.read(min(_CHUNK, off - pos))
                    if not chunk:
                        break
                    h.update(chunk)
                    pos += len(chunk)
                if pos != off:
                    break  # file shorter than every remaining offset
                if h.hexdigest() == dig:
                    matches.append((off, dig, p))
        return self._serve_deepest(matches)

    def lookup_rows(
        self,
        rows: np.ndarray,
        *,
        workload: str,
        segment_ops: int,
        opts: dict,
    ) -> PrefixHit | None:
        """Deepest ``jtc`` row-prefix anchor matching ``rows``'s own
        bytes.  Offsets are row counts; the digest covers the first N
        rows' contiguous bytes.  An anchor additionally requires the
        candidate's next row (if any) to carry an op index at or past
        the parent's segment boundary — op-index gaps at the boundary
        would otherwise let extra late rows slip into the already-
        carried window."""
        n = len(rows)
        cands = self._candidates("jtc", workload, segment_ops, opts, n)
        if not cands:
            return None
        matches: list[tuple[int, str, Path]] = []
        h = hashlib.sha256()
        pos = 0
        for off, dig, p in cands:
            if pos < off:
                h.update(np.ascontiguousarray(rows[pos:off]).tobytes())
                pos = off
            if h.hexdigest() != dig:
                continue
            matches.append((off, dig, p))
        # boundary-exactness guard, applied deepest-first at serve time
        def _boundary_ok(hit: tuple[int, str, Path]) -> bool:
            off = hit[0]
            if off >= n:
                return True
            try:
                doc = self._read_entry(hit[2])
            except PrefixIndexError:
                return True  # _serve_deepest will refuse it loudly
            boundary = (int(doc["segment_idx"]) + 1) * int(segment_ops)
            return int(rows[off, 0]) >= boundary

        return self._serve_deepest([m for m in matches if _boundary_ok(m)])

    # -- accounting -------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        entries = 0
        nbytes = 0
        contracts = 0
        if self.root.is_dir():
            for d in self.root.iterdir():
                if not d.is_dir():
                    continue
                contracts += 1
                for p in d.iterdir():
                    if _ENTRY_RE.match(p.name):
                        entries += 1
                        try:
                            nbytes += p.stat().st_size
                        except OSError:
                            pass
        return {
            "root": str(self.root),
            "contracts": contracts,
            "entries": entries,
            "bytes": nbytes,
        }
