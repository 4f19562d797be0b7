"""MLT006 — config-key resolution against config.py's ``*_DEFAULTS``.

The port keeps its configuration as plain module-level dicts in
``mlrun_tpu_torch/config.py`` (``SERVING_LLM_DEFAULTS``, ``RUN_DEFAULTS``,
``SERVICE_DEFAULTS``, ...) and reads it three ways:

- ``run_config("key")`` — ``RUN_DEFAULTS[key]`` under its env override;
- ``service_config("a.b.c")`` — ``SERVICE_DEFAULTS`` at a dotted key;
- subscripts and ``.get`` chains on a dict imported from the config
  (``SERVING_LLM_DEFAULTS["kv_tier"]``, ``OBSERVABILITY_DEFAULTS["slo"]
  .get("window_s")``), under any import alias.

A typo'd key is not a syntax error and not an import error: it raises a
``KeyError`` (or, through ``.get(...)``, silently reads the fallback)
only when that exact code path runs. This checker resolves every literal
key against the key trees parsed straight out of config.py's AST — no
import, no env resolution.

Walking stops at a leaf value (further subscripts are on the VALUE), at
a block that config.py leaves empty for the caller to fill (``{}``), and
at anything dynamic (a non-literal key). Store context
(``X_DEFAULTS["k"] = ...``) is not validated — tests and callers create
keys legitimately — and neither are ``tests/`` and config.py itself.
"""

from __future__ import annotations

import ast
import os

from .core import PACKAGE, Checker, Finding

CODE = "MLT006"

#: (module, dotted chain such as ``"SERVICE_DEFAULTS.httpdb.port"``) ->
#: rationale for a key the defaults trees cannot see (e.g. one created at
#: runtime by its caller)
ALLOWLIST: dict[tuple[str, str], str] = {
}

#: the reader functions and the dict each resolves against
_READERS = {"run_config": "RUN_DEFAULTS",
            "service_config": "SERVICE_DEFAULTS"}

_LEAF = object()


def _key_trees(config_path: str) -> dict[str, dict]:
    """{NAME_DEFAULTS: nested key tree} for every module-level
    ``*_DEFAULTS`` dict. Values are sub-dicts or _LEAF — only the key
    shape matters, so non-literal values (BinOps, calls) are fine; an
    empty dict is a block its caller fills, so it is a leaf too."""
    try:
        with open(config_path, encoding="utf-8") as fp:
            tree = ast.parse(fp.read())
    except (OSError, SyntaxError):
        return {}

    def build(node):
        if not isinstance(node, ast.Dict) or not node.keys:
            return _LEAF
        out = {}
        for key, value in zip(node.keys, node.values):
            if isinstance(key, ast.Constant) and isinstance(key.value,
                                                            str):
                out[key.value] = build(value)
        return out

    trees: dict[str, dict] = {}
    for node in tree.body:
        target = None
        if isinstance(node, ast.AnnAssign):
            target = node.target
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        if isinstance(target, ast.Name) \
                and target.id.endswith("_DEFAULTS") \
                and isinstance(node.value, ast.Dict):
            trees[target.id] = build(node.value)
            if trees[target.id] is _LEAF:
                trees[target.id] = {}
    return trees


def _absolute_module(rel: str, node: ast.ImportFrom) -> str:
    """The dotted module an ``ImportFrom`` in file ``rel`` names."""
    if node.level == 0:
        return node.module or ""
    package = rel[:-len(".py")].split("/")[:-1]
    if node.level > 1:
        package = package[:len(package) - (node.level - 1)]
    return ".".join(package + ([node.module] if node.module else []))


def _text(root: str, keys: list[str]) -> str:
    return root + "".join(f"[{key!r}]" for key in keys)


class ConfigKeyChecker(Checker):
    code = CODE
    name = "config-keys"

    def begin(self, root: str) -> None:
        self._root = root
        self._trees = _key_trees(os.path.join(root, PACKAGE, "config.py"))

    def visit(self, tree, source: str, path: str) -> list[Finding]:
        if not self._trees:
            return []
        rel = os.path.relpath(path, self._root).replace(os.sep, "/")
        if rel.startswith("tests/") or rel.endswith("config.py"):
            return []
        names = self._bindings(tree, rel)
        if not any(names):
            return []
        findings: list[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and _literal(node.slice) is not None:
                base = self._chain(node.value, names)
                if base is not None:
                    findings.extend(self._check(
                        base[0], base[1], [_literal(node.slice)], node,
                        path, rel, via=""))
            elif isinstance(node, ast.Call) and node.args \
                    and _literal(node.args[0]) is not None:
                key = _literal(node.args[0])
                func = node.func
                if isinstance(func, ast.Attribute) and func.attr == "get":
                    base = self._chain(func.value, names)
                    if base is not None:
                        findings.extend(self._check(
                            base[0], base[1], [key], node, path, rel,
                            via=" (via .get)"))
                    continue
                reader = self._reader(func, names)
                if reader is not None:
                    findings.extend(self._check(
                        _READERS[reader], [], _reader_keys(reader, key),
                        node, path, rel, via=f" (via {reader}({key!r}))"))
        return findings

    def _bindings(self, tree, rel: str):
        """(local name -> DEFAULTS dict, local name -> reader function,
        local names of the config module) for this file's imports."""
        dicts: dict[str, str] = {}
        readers: dict[str, str] = {}
        modules: set[str] = set()
        config_module = f"{PACKAGE}.config"
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                absolute = _absolute_module(rel, node)
                for alias in node.names:
                    local = alias.asname or alias.name
                    if absolute == config_module:
                        if alias.name in self._trees:
                            dicts[local] = alias.name
                        elif alias.name in _READERS:
                            readers[local] = alias.name
                    elif absolute == PACKAGE and alias.name == "config":
                        modules.add(local)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == config_module and alias.asname:
                        modules.add(alias.asname)
        return dicts, readers, modules

    def _reader(self, func, names) -> str | None:
        _dicts, readers, modules = names
        if isinstance(func, ast.Name):
            return readers.get(func.id)
        if isinstance(func, ast.Attribute) and func.attr in _READERS \
                and isinstance(func.value, ast.Name) \
                and func.value.id in modules:
            return func.attr
        return None

    def _chain(self, node, names) -> tuple[str, list[str]] | None:
        """(DEFAULTS dict, literal keys) that ``node`` reads, or None
        when it is not rooted at the config or something is dynamic."""
        dicts, _readers, modules = names
        keys: list[str] = []
        while True:
            if isinstance(node, ast.Subscript):
                key = _literal(node.slice)
                if key is None:
                    return None
                keys.append(key)
                node = node.value
            elif isinstance(node, ast.Call) and node.args \
                    and _literal(node.args[0]) is not None:
                key = _literal(node.args[0])
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "get":
                    keys.append(key)
                    node = node.func.value
                    continue
                reader = self._reader(node.func, names)
                if reader is None:
                    return None
                return (_READERS[reader],
                        _reader_keys(reader, key) + keys[::-1])
            elif isinstance(node, ast.Name) and node.id in dicts:
                return dicts[node.id], keys[::-1]
            elif isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in modules \
                    and node.attr in self._trees:
                return node.attr, keys[::-1]
            else:
                return None

    def _check(self, root: str, base: list[str], keys: list[str], node,
               path: str, rel: str, via: str) -> list[Finding]:
        """Walk ``base`` (already reported where it breaks) and then
        ``keys``; a finding at the first key of ``keys`` that is not
        there."""
        at = self._trees.get(root)
        for key in base:
            if not isinstance(at, dict) or key not in at:
                return []
            at = at[key]
        for idx, key in enumerate(keys):
            if not isinstance(at, dict):
                return []  # a leaf value or an open block
            if key not in at:
                walked = base + keys[:idx]
                chain = ".".join([root] + walked + [key])
                if (rel, chain) in ALLOWLIST:
                    return []
                return [Finding(
                    CODE, path, node.lineno,
                    f"{_text(root, walked + [key])}{via} does not "
                    f"resolve: {_text(root, walked)} has no key "
                    f"{key!r}",
                    f"fix the key or add it to {root} in config.py"
                    + (" — a typo'd get() silently reads the fallback"
                       if via == " (via .get)" else ""))]
            at = at[key]
        return []


def _reader_keys(reader: str, key: str) -> list[str]:
    """The keys a reader call walks: ``service_config`` takes a dotted
    path, ``run_config`` one top-level key."""
    return key.split(".") if reader == "service_config" else [key]


def _literal(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
