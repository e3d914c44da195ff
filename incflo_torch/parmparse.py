"""AMReX ParmParse-compatible inputs-file parser.

The reference drives everything from a plain-text "inputs" file with
`key = value [value ...]` lines plus CLI overrides (reference
src/setup/init.cpp, AMReX ParmParse).  This module reproduces that
config surface so the reference's benchmark decks run unmodified.

Grammar accepted (superset of what the decks use):
  * `prefix.key = v1 v2 ...` ; later assignments override earlier ones.
  * `#` starts a comment (also the decks' `#....#` banner art).
  * values may be quoted strings, bools (true/false), ints or floats.
"""

from __future__ import annotations

import shlex
from typing import Dict, List, Optional, Sequence, Union

Scalar = Union[bool, int, float, str]


def _coerce(tok: str) -> Scalar:
    low = tok.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _parse_line(line: str) -> Optional[tuple]:
    # strip comments (respect quotes)
    lex = shlex.shlex(line, posix=False)
    lex.whitespace_split = True
    lex.commenters = "#"
    try:
        toks = list(lex)
    except ValueError:
        toks = line.split("#", 1)[0].split()
    if not toks:
        return None
    joined = " ".join(toks)
    if "=" not in joined:
        return None
    key, _, rhs = joined.partition("=")
    key = key.strip()
    vals = []
    for t in rhs.split():
        t = t.strip()
        if len(t) >= 2 and t[0] == t[-1] and t[0] in "\"'":
            t = t[1:-1]
            vals.append(t)
        else:
            vals.append(_coerce(t))
    return key, vals


class ParmParse:
    """A parsed inputs table with AMReX-style prefixed queries.

    `ParmParse(table, "incflo")` scopes queries to `incflo.*` keys, like
    the reference's `ParmParse pp("incflo")` (src/setup/init.cpp:34).
    """

    def __init__(self, table: Dict[str, List[Scalar]], prefix: str = ""):
        self._table = table
        self._prefix = prefix

    # -- construction -----------------------------------------------------
    @classmethod
    def from_text(cls, text: str, argv: Sequence[str] = ()) -> "ParmParse":
        table: Dict[str, List[Scalar]] = {}
        for line in text.splitlines():
            kv = _parse_line(line)
            if kv:
                table[kv[0]] = kv[1]
        # CLI overrides: tokens of the form key=v1 or "key = v1 v2"
        for arg in argv:
            kv = _parse_line(arg)
            if kv:
                table[kv[0]] = kv[1]
        return cls(table)

    @classmethod
    def from_file(cls, path: str, argv: Sequence[str] = ()) -> "ParmParse":
        with open(path) as f:
            return cls.from_text(f.read(), argv)

    def scoped(self, prefix: str) -> "ParmParse":
        return ParmParse(self._table, prefix)

    # -- queries -----------------------------------------------------------
    def _key(self, name: str) -> str:
        return f"{self._prefix}.{name}" if self._prefix else name

    def contains(self, name: str) -> bool:
        return self._key(name) in self._table

    def query(self, name: str, default: Scalar) -> Scalar:
        vals = self._table.get(self._key(name))
        if vals is None or not vals:
            return default
        v = vals[0]
        if isinstance(default, bool):
            if isinstance(v, bool):
                return v
            if isinstance(v, int):
                return bool(v)
            if isinstance(v, str):
                return v.lower() == "true"
            return bool(v)
        if isinstance(default, float) and isinstance(v, int):
            return float(v)
        return v

    def get(self, name: str) -> Scalar:
        vals = self._table.get(self._key(name))
        if vals is None:
            raise KeyError(f"ParmParse: required key '{self._key(name)}' not found")
        return vals[0]

    def queryarr(self, name: str, default: Sequence[Scalar], n: Optional[int] = None
                 ) -> List[Scalar]:
        vals = self._table.get(self._key(name))
        if vals is None:
            out = list(default)
        else:
            out = list(vals)
        if n is not None:
            if len(out) < n:
                out = out + [out[-1] if out else 0.0] * (n - len(out))
            out = out[:n]
        return [float(v) if isinstance(v, int) else v for v in out] \
            if (default and isinstance(default[0], float)) else out

    def getarr(self, name: str, n: Optional[int] = None) -> List[Scalar]:
        vals = self._table.get(self._key(name))
        if vals is None:
            raise KeyError(f"ParmParse: required key '{self._key(name)}' not found")
        out = list(vals)
        if n is not None:
            out = out[:n]
        return out

    def dump(self) -> str:
        """Full config dump (the reference writes this into incflo_job_info,
        src/utilities/io.cpp:228-313)."""
        return "\n".join(
            f"{k} = {' '.join(str(v) for v in vs)}" for k, vs in sorted(self._table.items())
        )
