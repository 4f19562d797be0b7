"""MLT004 — blocking calls under an engine lock.

The engine's stop() race and the adapter bank lock's hardening were
both the same shape: a thread holding a hot lock reached something that
can block indefinitely (a join, a device sync, an un-timed queue get),
and every other thread in the engine convoyed behind it. This checker
builds intra-module may-block summaries and flags any may-block call
lexically inside a ``with <lock>:`` body.

What counts as may-block (direct):

- ``time.sleep`` / bare ``sleep(...)``
- ``.result()`` / ``.join()`` / ``.wait()`` / ``.acquire()`` with no
  timeout bound
- ``requests.*`` / ``urlopen`` (network)
- ``.get(...)`` / ``.put(...)`` on a queue-named receiver without
  ``timeout=`` / ``block=False``
- torch device syncs: ``torch.cuda.synchronize()``, ``.synchronize()``
  on a stream or an event, ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()`` (each waits for every kernel queued before it), and
  ``.to("cpu")`` / ``.to(device="cpu")``
- file/socket I/O: ``open(...)``, ``.recv/.send/.accept/.connect``

Summaries propagate one module deep: a call to a same-module function
or ``self.`` method that may block is flagged too, with the chain in
the message. Seeded on the modules whose locks are the proven hazard
(engine scheduler, adapter bank lock, fleet ring lock) — widen
``CHECKED_MODULES`` as new lock-holding subsystems land.

Nested ``def`` bodies inside a with-block are NOT flagged (defining a
closure under a lock is free; calling it is what blocks) — the call
site is what gets charged.
"""

from __future__ import annotations

import ast
import os

from .core import Checker, Finding, qualname_parts, walk_functions, walk_own

CODE = "MLT004"

#: module (repo-relative) -> the lock this module is seeded for
CHECKED_MODULES = {
    "mlrun_tpu_torch/serving/llm_batch.py":
        "engine scheduler lock (self._lock) — the stop()-race lock",
    "mlrun_tpu_torch/serving/paged.py":
        "paged engine: shares the scheduler-lock discipline",
    "mlrun_tpu_torch/serving/adapters.py":
        "AdapterRegistry bank lock — the bank-lock hardening target",
    "mlrun_tpu_torch/serving/fleet.py":
        "fleet ring lock — dispatch must never stall behind it",
    "mlrun_tpu_torch/serving/prefix.py":
        "radix-index lock on the admission path",
}

#: (module, function qualname) -> rationale for a may-block call that
#: is provably bounded or intentional under its lock. Prefer
#: restructuring (move the call outside the lock);
#: this table is for sites where the blocking bound is real but
#: invisible to the AST.
ALLOWLIST: dict[tuple[str, str], str] = {
    ("mlrun_tpu_torch/serving/llm_batch.py",
     "ContinuousBatchingEngine._enqueue"):
        "self._queue is unbounded (queue.Queue()); put() cannot block "
        "— the lock exists to order the put against the expiry "
        "sweep's atomic drain/re-put",
    ("mlrun_tpu_torch/serving/llm_batch.py",
     "ContinuousBatchingEngine._expire_queued"):
        "re-putting drained items back onto the unbounded queue; "
        "put() cannot block and the drain/re-put must be atomic "
        "under the scheduler lock",
}

_LOCK_NAME_HINTS = ("lock",)
_LOCK_NAME_EXCLUDE = ("cond", "unlock")

_NETWORK_ROOTS = {"requests", "urllib", "httpx"}
_QUEUE_HINTS = ("queue", "_q")
_UNTIMED_METHODS = {"result", "join", "wait"}  # acquire: own branch
#: tensor methods that copy to the host, so wait for the device's queue
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SOCKET_METHODS = {"recv", "send", "sendall", "accept", "connect"}


def _has_timeout(node: ast.Call) -> bool:
    if any(kw.arg == "timeout" and not _is_none(kw.value)
           for kw in node.keywords):
        return True
    # positional timeout on result()/join()/wait(): first arg —
    # unless it is literally None, which is the unbounded spelling
    return bool(node.args) and not _is_none(node.args[0])


def _acquire_bounded(node: ast.Call) -> bool:
    """lock.acquire(): signature is (blocking=True, timeout=-1) — the
    FIRST positional is ``blocking``, not a timeout. Bounded iff
    non-blocking or a real timeout is given."""
    args = node.args
    if args and isinstance(args[0], ast.Constant) \
            and args[0].value is False:
        return True  # acquire(False) — non-blocking try-lock
    if any(kw.arg == "blocking" and isinstance(kw.value, ast.Constant)
           and kw.value.value is False for kw in node.keywords):
        return True
    if any(kw.arg == "timeout" and not _is_none(kw.value)
           for kw in node.keywords):
        return True
    # acquire(True, 5.0): second positional is the timeout
    return len(args) >= 2 and not _is_none(args[1])


def _is_none(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _to_cpu(node: ast.Call) -> bool:
    """``.to("cpu")`` / ``.to(device="cpu")``: a copy to the host."""
    values = node.args[:1] + [kw.value for kw in node.keywords
                              if kw.arg == "device"]
    return any(isinstance(v, ast.Constant) and v.value == "cpu"
               for v in values)


def _blocks_directly(node: ast.Call) -> str | None:
    """Return a human description when the call itself may block."""
    func = node.func
    parts = qualname_parts(func)
    # time.sleep / sleep
    if parts in (["time", "sleep"], ["sleep"]):
        return "sleep()"
    if parts and parts[0] in _NETWORK_ROOTS:
        return f"network call {'.'.join(parts)}"
    if parts in (["urlopen"],):
        return "urlopen()"
    if parts == ["open"]:
        return "open() file I/O"
    if parts == ["torch", "cuda", "synchronize"]:
        return "device sync torch.cuda.synchronize()"
    if isinstance(func, ast.Attribute):
        attr = func.attr
        if attr == "synchronize":
            return "device sync .synchronize()"
        if attr in _HOST_SYNC_METHODS:
            return f"device sync .{attr}()"
        if attr == "to" and _to_cpu(node):
            return "device sync .to('cpu')"
        if attr == "acquire":
            if not _acquire_bounded(node):
                return ".acquire() with no timeout"
        elif attr in _UNTIMED_METHODS and not _has_timeout(node):
            return f".{attr}() with no timeout"
        if attr in _SOCKET_METHODS:
            return f"socket .{attr}()"
        if attr in ("get", "put"):
            recv = func.value
            recv_parts = qualname_parts(recv) or []
            recv_text = "_".join(recv_parts).lower()
            if any(h in recv_text for h in _QUEUE_HINTS):
                timed = any(kw.arg == "timeout" for kw in node.keywords)
                nonblock = any(
                    kw.arg == "block"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is False
                    for kw in node.keywords)
                if not timed and not nonblock:
                    return f"un-timed queue .{attr}()"
    return None


def _is_lock_expr(node) -> bool:
    parts = qualname_parts(node)
    if not parts:
        return False
    last = parts[-1].lower()
    if any(ex in last for ex in _LOCK_NAME_EXCLUDE):
        return False
    return any(hint in last for hint in _LOCK_NAME_HINTS)


class _ModuleIndex:
    """Intra-module call graph + may-block summaries."""

    def __init__(self, tree):
        # qualname -> FunctionDef; also method name -> [qualnames] for
        # self.X resolution across classes (approximate: any class's
        # method of that name)
        self.functions: dict[str, ast.AST] = {}
        self.by_method: dict[str, list[str]] = {}
        for func, qual in walk_functions(tree):
            self.functions[qual] = func
            self.by_method.setdefault(func.name, []).append(qual)
        self._blocks: dict[str, str | None] = {}

    def _callees(self, func) -> list[str]:
        out = []
        for node in walk_own(func):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id in self.by_method:
                out.extend(self.by_method[f.id])
            elif (isinstance(f, ast.Attribute)
                  and isinstance(f.value, ast.Name)
                  and f.value.id == "self"
                  and f.attr in self.by_method):
                out.extend(self.by_method[f.attr])
        return out

    def may_block(self, qual: str, _seen=None) -> str | None:
        """None, or a 'via' chain description ending at a blocking
        leaf."""
        if qual in self._blocks:
            return self._blocks[qual]
        seen = _seen or set()
        if qual in seen:
            return None
        seen.add(qual)
        func = self.functions.get(qual)
        if func is None:
            return None
        self._blocks[qual] = None  # cycle guard for memo
        for node in walk_own(func):
            if isinstance(node, ast.Call):
                desc = _blocks_directly(node)
                if desc:
                    self._blocks[qual] = \
                        f"{desc} at line {node.lineno}"
                    return self._blocks[qual]
        for callee in self._callees(func):
            via = self.may_block(callee, seen)
            if via:
                self._blocks[qual] = f"{callee} -> {via}"
                return self._blocks[qual]
        return None


class BlockingUnderLockChecker(Checker):
    code = CODE
    name = "blocking-under-lock"

    def begin(self, root: str) -> None:
        self._root = root

    def visit(self, tree, source: str, path: str) -> list[Finding]:
        rel = os.path.relpath(path, self._root).replace(os.sep, "/")
        if rel not in CHECKED_MODULES:
            return []
        index = _ModuleIndex(tree)
        findings: list[Finding] = []
        for func, qual in walk_functions(tree):
            for node in walk_own(func):
                if not isinstance(node, ast.With):
                    continue
                if not any(_is_lock_expr(item.context_expr)
                           for item in node.items):
                    continue
                for call, desc in self._blocking_in(node, index):
                    key = (rel, qual)
                    if key in ALLOWLIST:
                        continue
                    findings.append(Finding(
                        CODE, path, call.lineno,
                        f"may-block under lock in {qual}: {desc} "
                        f"({CHECKED_MODULES[rel]})",
                        "move the call outside the lock, bound it "
                        "with a timeout, or add an ALLOWLIST entry "
                        "with the bound's rationale"))
        return findings

    def _blocking_in(self, with_node: ast.With, index: _ModuleIndex):
        """Yield (call, description) for may-block calls lexically
        inside the with body (nested defs excluded)."""
        for stmt in with_node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # defining a closure under the lock is free
            for node in walk_own(stmt):
                if not isinstance(node, ast.Call):
                    continue
                desc = _blocks_directly(node)
                if desc:
                    yield node, desc
                    continue
                f = node.func
                targets = []
                if isinstance(f, ast.Name) and f.id in index.by_method:
                    targets = index.by_method[f.id]
                elif (isinstance(f, ast.Attribute)
                      and isinstance(f.value, ast.Name)
                      and f.value.id == "self"
                      and f.attr in index.by_method):
                    targets = index.by_method[f.attr]
                for target in targets:
                    via = index.may_block(target)
                    if via:
                        yield node, f"call into {target} which may " \
                                    f"block ({via})"
                        break
