"""Import jepsen ``history.edn`` files, and write histories as EDN.

The port's own copy of the JAX package's ``history/edn.py``: the same
reader, op mapper and writer, so that both packages read an EDN history
into the same ops and ``synth --format edn`` writes the same bytes.

jepsen store directories hold the history as EDN, a sequence of op maps
like

    {:type :invoke, :f :enqueue, :value 302, :process 3, :time 817102,
     :index 12}

(older jepsen) or tagged records ``#jepsen.history.Op{...}`` (jepsen
0.3.x).  The reader is small and dependency-free and covers the grammar
such histories use: maps, vectors/lists, sets, keywords, symbols,
strings, numbers, ``nil``/booleans, comments, ``#_`` discard, and tagged
literals (the tag is dropped and the value kept, which is right for
record-as-map tags).

The op mapper raises on an unknown client ``:f`` (a wrong guess would
mis-classify ops), maps the ``:nemesis`` process to the nemesis
pseudo-process, and keeps a nemesis ``:f`` it has no name for as a log
row.

An EDN source takes part in the ``.jtc`` substrate like a JSONL one: its
``history.jtc`` is stamped with the EDN file's basename and bytes
(``history/columnar.py``), so a JSONL twin's substrate never serves for
the EDN file or the other way round, and either package serves the
other's.  The native packer never reads EDN.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

from jepsen_tpu_torch.history.ops import (
    NEMESIS_PROCESS,
    Op,
    _F_BY_NAME,
    _TYPE_BY_NAME,
)

_WS = set(" \t\r\n,")
_DELIM = set("()[]{}\"';")


class EdnError(ValueError):
    pass


class Keyword(str):
    """An EDN keyword (``:foo`` → ``Keyword("foo")``) — a str subclass so
    consumers can treat it as its name."""

    __slots__ = ()


def _skip_ws(s: str, i: int) -> int:
    n = len(s)
    while i < n:
        c = s[i]
        if c in _WS:
            i += 1
        elif c == ";":  # comment to end of line
            while i < n and s[i] != "\n":
                i += 1
        elif s.startswith("#_", i):  # discard: skip the next form
            v, i = _read(s, i + 2)
            del v
        else:
            break
    return i


def _read_string(s: str, i: int) -> tuple[str, int]:
    out = []
    i += 1  # opening quote
    n = len(s)
    while i < n:
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            i += 1
            if i >= n:
                break
            esc = s[i]
            if esc == "u" and i + 4 < n:  # \uXXXX (EDN string grammar)
                try:
                    out.append(chr(int(s[i + 1 : i + 5], 16)))
                    i += 5
                    continue
                except ValueError:
                    pass  # not hex: fall through, keep the char bare
            out.append(
                {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\"}.get(
                    esc, esc
                )
            )
        else:
            out.append(c)
        i += 1
    raise EdnError("unterminated string")


def _read_token(s: str, i: int) -> tuple[str, int]:
    j = i
    n = len(s)
    while j < n and s[j] not in _WS and s[j] not in _DELIM and not (
        s[j] == "#" and j > i
    ):
        j += 1
    return s[i:j], j


def _token_value(tok: str) -> Any:
    if tok == "nil":
        return None
    if tok == "true":
        return True
    if tok == "false":
        return False
    # numbers (jepsen histories use ints and the odd float; trailing N/M
    # mark big ints/decimals)
    body = tok[:-1] if tok and tok[-1] in "NM" and len(tok) > 1 else tok
    try:
        return int(body)
    except ValueError:
        pass
    try:
        return float(body)
    except ValueError:
        pass
    return tok  # a symbol; kept as its name


def _read_seq(s: str, i: int, closer: str) -> tuple[list, int]:
    out = []
    while True:
        i = _skip_ws(s, i)
        if i >= len(s):
            raise EdnError(f"unterminated sequence (wanted {closer!r})")
        if s[i] == closer:
            return out, i + 1
        v, i = _read(s, i)
        out.append(v)


def _read(s: str, i: int) -> tuple[Any, int]:
    i = _skip_ws(s, i)
    if i >= len(s):
        raise EdnError("unexpected end of input")
    c = s[i]
    if c == "{":
        items, i = _read_seq(s, i + 1, "}")
        if len(items) % 2:
            raise EdnError("map with odd number of forms")
        return dict(zip(items[::2], items[1::2])), i
    if c == "[":
        return _read_seq(s, i + 1, "]")
    if c == "(":
        return _read_seq(s, i + 1, ")")
    if c == '"':
        return _read_string(s, i)
    if c == ":":
        tok, i = _read_token(s, i + 1)
        return Keyword(tok), i
    if c == "\\":  # character literal
        tok, i = _read_token(s, i + 1)
        named = {"newline": "\n", "space": " ", "tab": "\t", "return": "\r"}
        return named.get(tok, tok[:1]), i
    if c == "#":
        if s.startswith("#{", i):
            items, i = _read_seq(s, i + 2, "}")
            try:
                return set(items), i
            except TypeError:  # unhashable members: keep the list
                return items, i
        # tagged literal: #some.tag/Name <form> — drop the tag
        tag, i = _read_token(s, i + 1)
        del tag
        return _read(s, i)
    tok, i = _read_token(s, i)
    if not tok:
        raise EdnError(f"cannot read at position {i}: {s[i:i+10]!r}")
    return _token_value(tok), i


def parse_edn_forms(text: str) -> list[Any]:
    """Every top-level form in ``text`` (a history file is either one
    vector of op maps or a bare sequence of them)."""
    out = []
    i = 0
    while True:
        i = _skip_ws(text, i)
        if i >= len(text):
            return out
        v, i = _read(text, i)
        out.append(v)


def _to_plain(v: Any) -> Any:
    """Keywords → plain strings (op values like ``:exhausted`` errors)."""
    if isinstance(v, Keyword):
        return str(v)
    if isinstance(v, list):
        return [_to_plain(x) for x in v]
    return v


def op_from_edn(m: dict) -> Op:
    """One jepsen op map → :class:`Op`."""
    # Keyword is a str subclass, so plain string keys look maps up fine
    get = m.get
    type_name = str(get("type") or "")
    f_name = str(get("f") or "").replace("-", "_")
    if type_name not in _TYPE_BY_NAME:
        raise EdnError(f"unknown op :type {get('type')!r}")
    proc = get("process")
    if isinstance(proc, Keyword):
        # only :nemesis names the pseudo-process; any other keyword is a
        # history this reader does not understand, not a nemesis op
        if str(proc) != "nemesis":
            raise EdnError(f"unknown keyword :process :{proc}")
        proc = NEMESIS_PROCESS
    elif proc is None:
        proc = NEMESIS_PROCESS  # jepsen's nemesis rows may omit :process
    elif isinstance(proc, bool) or not isinstance(proc, int):
        # the parser yields ints for integer tokens; anything else
        # (float, symbol/string) is a history this reader must refuse —
        # int() coercion would silently mis-attribute the op
        raise EdnError(f"non-integer op :process {proc!r}")
    value = _to_plain(get("value"))
    if f_name not in _F_BY_NAME:
        if int(proc) == NEMESIS_PROCESS:
            # jepsen's richer nemeses record f's like :start-partition /
            # :kill; every checker masks nemesis ops out anyway, so keep
            # them as log rows (f name folded into the value) rather than
            # refusing the whole file
            value = f"{get('f')} {value}" if value is not None else str(
                get("f")
            )
            f_name = "log"
        else:
            # a client op we cannot classify: silently dropping it would
            # quietly weaken every checker consuming the history
            raise EdnError(f"unknown op :f {get('f')!r}")
    time = get("time")
    index = get("index")
    return Op(
        type=_TYPE_BY_NAME[type_name],
        f=_F_BY_NAME[f_name],
        process=int(proc),
        value=value,
        time=int(time) if isinstance(time, int) else -1,
        index=int(index) if isinstance(index, int) else -1,
        error=_to_plain(get("error")),
    )


def read_history_edn(path: str | Path) -> list[Op]:
    """Parse a jepsen ``history.edn`` into ops.

    Accepts both layouts: one top-level vector of op maps, or one op map
    per line (the streaming layout).  Ops jepsen records that this
    framework has no ``:f`` for raise — silently dropping ops would
    quietly weaken every checker that consumes the history.
    """
    forms = parse_edn_forms(Path(path).read_text())
    if len(forms) == 1 and isinstance(forms[0], list):
        forms = forms[0]
    ops = []
    for form in forms:
        if not isinstance(form, dict):
            raise EdnError(f"expected an op map, got {type(form).__name__}")
        ops.append(op_from_edn(form))
    # jepsen histories are index-ordered already; re-index defensively if
    # absent (all -1) so packing gets sequential rows
    if ops and all(op.index == -1 for op in ops):
        for i, op in enumerate(ops):
            op.index = i
    return ops


# ---------------------------------------------------------------------------
# Export: our histories as jepsen-style EDN (so jepsen-ecosystem tooling —
# Elle's CLI, jepsen.history utilities — can consume runs recorded here)
# ---------------------------------------------------------------------------


def _edn_value(v: Any) -> str:
    if v is None:
        return "nil"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        # control chars must be escaped or a multi-line error string (e.g.
        # a client-crash backtrace) breaks write_history_edn's documented
        # one-op-per-line streaming layout for line-oriented consumers
        body = (
            v.replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
            .replace("\r", "\\r")
            .replace("\t", "\\t")
        )
        return f'"{body}"'
    if isinstance(v, (list, tuple)):
        return "[" + " ".join(_edn_value(x) for x in v) + "]"
    raise TypeError(f"cannot EDN-encode {type(v).__name__}")


def _edn_micro_op(m: Any) -> str:
    """``["append", k, v]`` → ``[:append k v]`` — jepsen/elle's own
    micro-op shape (the kind is a keyword there, not a string)."""
    if (
        isinstance(m, (list, tuple))
        and len(m) == 3
        and isinstance(m[0], str)
    ):
        return (
            f"[:{m[0]} {_edn_value(m[1])} {_edn_value(m[2])}]"
        )
    return _edn_value(m)


def op_to_edn(op: Op) -> str:
    parts = [
        f":index {op.index}",
        f":type :{op.type.name.lower()}",
        f":f :{op.f.name.lower().replace('_', '-')}",
        (
            ":process :nemesis"
            if op.process == NEMESIS_PROCESS
            else f":process {op.process}"
        ),
        f":time {op.time}",
    ]
    if op.value is not None:
        if op.f.name == "TXN" and isinstance(op.value, (list, tuple)):
            mops = " ".join(_edn_micro_op(m) for m in op.value)
            parts.append(f":value [{mops}]")
        else:
            parts.append(f":value {_edn_value(op.value)}")
    if op.error is not None:
        parts.append(f":error {_edn_value(op.error)}")
    return "{" + ", ".join(parts) + "}"


def write_history_edn(path: str | Path, history) -> None:
    """One op map per line (jepsen's streaming layout)."""
    with open(path, "w") as fh:
        for op in history:
            fh.write(op_to_edn(op) + "\n")
