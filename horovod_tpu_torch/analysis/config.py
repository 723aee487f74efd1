"""``[tool.hvdtpu-torch-lint]`` configuration from pyproject.toml.

The defaults below are the port's configuration: the repo's
pyproject.toml carries no such table, so the lint surface is the
``horovod_tpu_torch`` package and ``chip_smoke.py``, less the package's
git-ignored build directory.

Python 3.11 ships ``tomllib``; this repo supports 3.10, and the linter
must not grow a TOML dependency the container doesn't have — so when
``tomllib`` is unavailable we fall back to a tiny parser that handles
exactly the subset our own config block uses (string and string-list
values under one ``[table]`` header).  Anything fancier in that block
is a configuration error, reported as such.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import List, Optional

TABLE = "tool.hvdtpu-torch-lint"


@dataclass
class LintConfig:
    paths: List[str] = field(default_factory=lambda: [
        "horovod_tpu_torch", "chip_smoke.py"
    ])
    baseline: Optional[str] = "horovod_tpu_torch/analysis/baseline.json"
    # the git-ignored build outputs (kernel libraries, scratch trees)
    exclude: List[str] = field(default_factory=lambda: [
        "horovod_tpu_torch/_build"
    ])
    # Per-file analysis cache (content-hash keyed module findings +
    # taint summaries).  ``cache = ""`` in pyproject disables it.
    cache: Optional[str] = ".hvdtpu-torch-lint-cache.json"


def find_pyproject(start: str) -> Optional[str]:
    d = os.path.abspath(start)
    while True:
        cand = os.path.join(d, "pyproject.toml")
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def load_config(root: str) -> LintConfig:
    path = find_pyproject(root)
    cfg = LintConfig()
    if path is None:
        return cfg
    table = _read_table(path, TABLE)
    if table is None:
        return cfg
    if "paths" in table:
        cfg.paths = list(table["paths"])
    if "baseline" in table:
        cfg.baseline = table["baseline"] or None
    if "exclude" in table:
        cfg.exclude = list(table["exclude"])
    if "cache" in table:
        cfg.cache = table["cache"] or None
    return cfg


def _read_table(path: str, name: str) -> Optional[dict]:
    try:
        import tomllib  # noqa: PLC0415

        with open(path, "rb") as f:
            doc = tomllib.load(f)
        node = doc
        for part in _split_table_name(name):
            if not isinstance(node, dict) or part not in node:
                return None
            node = node[part]
        return node if isinstance(node, dict) else None
    except ModuleNotFoundError:
        return _read_table_fallback(path, name)


def _split_table_name(name: str) -> List[str]:
    # tool.hvdtpu-torch-lint -> ["tool", "hvdtpu-torch-lint"] (quoted
    # keys ignored:
    # our table name has none)
    return name.split(".")


_KV_RE = re.compile(r"^\s*([A-Za-z0-9_-]+)\s*=\s*(.+?)\s*$")


def _read_table_fallback(path: str, name: str) -> Optional[dict]:
    """TOML-subset reader: one [header] with string / string-list
    values; quoted with double quotes; lists may span lines."""
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    in_table = False
    out: dict = {}
    buf = ""
    key: Optional[str] = None
    for raw in lines:
        line = raw.strip()
        if line.startswith("["):
            if key is not None:
                raise ValueError(
                    f"{path}: unterminated list for {key!r} in [{name}]"
                )
            in_table = line == f"[{name}]"
            continue
        if not in_table or not line or line.startswith("#"):
            continue
        line = _strip_comment(line)
        if not line:
            continue
        if key is not None:  # continuing a multi-line list
            buf += " " + line
            if _balanced(buf):
                out[key] = _parse_value(buf, path, key)
                key, buf = None, ""
            continue
        m = _KV_RE.match(line)
        if not m:
            raise ValueError(f"{path}: unparseable line in [{name}]: "
                             f"{raw!r}")
        k, v = m.group(1), m.group(2)
        if v.startswith("[") and not _balanced(v):
            key, buf = k, v
        else:
            out[k] = _parse_value(v, path, k)
    return out or None


def _balanced(s: str) -> bool:
    return s.count("[") == s.count("]")


def _strip_comment(v: str) -> str:
    """Drop a trailing `# ...` that sits outside double quotes."""
    in_str = False
    for i, ch in enumerate(v):
        if ch == '"':
            in_str = not in_str
        elif ch == "#" and not in_str:
            return v[:i].rstrip()
    return v


def _parse_value(v: str, path: str, key: str):
    v = v.strip()
    if v.startswith("["):
        inner = v[1:-1] if v.endswith("]") else v[1:]
        items = [p.strip() for p in inner.split(",")]
        return [_unquote(p, path, key) for p in items if p]
    return _unquote(v, path, key)


def _unquote(v: str, path: str, key: str) -> str:
    v = v.strip()
    if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
        return v[1:-1]
    raise ValueError(
        f"{path}: [{TABLE}] {key} = {v!r}: only double-quoted strings "
        f"and lists of them are supported"
    )
