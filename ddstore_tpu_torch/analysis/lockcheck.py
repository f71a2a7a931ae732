"""Per-function lock-state tracking + the concurrency detectors.

Consumes the ``DDS_*`` annotations extracted by :mod:`cppmodel` as
ground truth and walks every function body with a scoped lock-state
machine (``lock_guard``/``unique_lock``/``shared_lock``/``scoped_lock``
RAII scopes, manual ``.lock()``/``.unlock()``, vectors of
``unique_lock``). Detector classes:

``guard``
    an annotated field touched without its guard held (and without a
    ``DDS_REQUIRES`` covering it); constructors/destructors exempt.
``blocking-under-lock``
    a blocking call (connect/poll/recv/sleep_for/Wait/getenv/...) while
    a ``DDS_NO_BLOCKING`` mutex is held.
``excludes``
    a ``DDS_EXCLUDES`` function acquiring one of its excluded mutexes
    ("never hold a data-lane mutex during Ping", mechanized).
``requires``
    a call to a ``DDS_REQUIRES`` method without the required mutex held.
``lock-order``
    a cycle in the global acquisition-order graph (edges = observed
    lexical nesting + declared ``DDS_ACQUIRED_BEFORE``).
``dtor-order``
    a ``DDS_DESTROYED_BEFORE`` member declared on the wrong side of its
    target (destruction runs in reverse declaration order), or a
    ``std::thread``(-vector) member that no function of its class ever
    joins.

Lambda semantics: a lambda body is analyzed as part of its enclosing
function but with an EMPTY lock state (it usually runs later, on
another thread), except lambdas passed directly to a condition
variable's ``wait``/``wait_for``/``wait_until``, which run under the
caller's lock and inherit it. Scope-bound helper lambdas that only run
under the enclosing lock (the transport's ``fail()`` closures) show up
as findings and are pinned in ``baseline.json`` with that reason.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .cppmodel import DDS_MACROS, FunctionInfo, Model
from .findings import Finding

#: Calls that may block (or are this repo's known blocking wrappers).
#: getenv is here deliberately: "no getenv under async_mu_ on the hot
#: path" is a pinned invariant.
BLOCKING_CALLS = {
    # syscalls / libc
    "connect", "poll", "accept", "select", "recv", "recvmsg",
    "recvfrom", "send", "sendmsg", "sendto", "readv", "writev",
    "read", "write", "getaddrinfo", "getenv", "usleep", "nanosleep",
    "sleep", "process_vm_readv", "posix_fallocate",
    # io_uring: enter blocks when wait_nr > 0 (and may block on a full
    # SQ even without); wait_cqe is liburing vocabulary — unused here
    # (raw syscalls) but policed so a future wrapper can't slip in.
    "io_uring_enter", "io_uring_wait_cqe",
    # std::this_thread
    "sleep_for", "sleep_until",
    # repo-known blocking wrappers
    "FullSend", "FullRecv", "SendIov", "SendVec", "RecvScatter",
    "EnsureConnected", "DialWithTimeout", "ControlRoundTrip",
    "FaultSleepMs", "EnvLong", "EnvInt", "Wait", "join", "Barrier",
    "Ping", "ReadVOn", "ReadVOnRetry", "TryReadV",
    # io_uring-era blocking wrappers (uring_transport.cc)
    "SubmitAndWait", "UringReadVLocked", "ReadBatch", "EnvLongU",
}

#: condition_variable methods: the lock is (atomically) released while
#: waiting, so they are neither "blocking under the lock" nor a release
#: for guard purposes (the predicate runs with the lock re-held).
_CV_WAITS = ("wait", "wait_for", "wait_until")

_LOCK_DECLS = ("lock_guard", "scoped_lock", "unique_lock", "shared_lock")

_IDENT = re.compile(r"[A-Za-z_]\w*$")


@dataclass
class _Acq:
    mutex: str          # canonical id
    scope_depth: int
    var: Optional[str]  # unique/shared_lock variable name, if any
    released: bool = False


class _Frame:
    """Lock state for one function (or lambda) frame."""

    def __init__(self, held: Optional[List[_Acq]] = None) -> None:
        self.acqs: List[_Acq] = list(held or [])
        self.depth = 0


def _known_class_in(model: Model, type_text: str,
                    ctx: Optional[str]) -> Optional[str]:
    """Short name of a known class mentioned in a declaration's type
    text (context-local nested classes win)."""
    words = re.findall(r"[A-Za-z_]\w*", type_text)
    shorts = {c.name for c in model.classes.values()}
    if ctx:
        chain = model._context_chain(ctx)
        nested = set()
        for c in chain:
            for q, ci in model.classes.items():
                if q.startswith(c.qual + "::"):
                    nested.add(ci.name)
        for w in words:
            if w in nested:
                return w
    for w in words:
        if w in shorts and w not in ("std",):
            return w
    return None


def _var_types(model: Model, fn: FunctionInfo) -> Dict[str, str]:
    """Best-effort map of variable name -> known class short name, from
    the parameter list, local declarations, and the context class's
    member types."""
    out: Dict[str, str] = {}
    # members of the context class (and its enclosures)
    if fn.cls:
        for c in model._context_chain(fn.cls):
            for mname, decl in c.member_types.items():
                k = _known_class_in(model, decl, fn.cls)
                if k and mname not in out:
                    out[mname] = k
    # parameters + locals: scan token pairs `Type [&*] name`
    toks = fn.params + fn.body
    texts = [t.text for t in toks]
    for i, x in enumerate(texts):
        if not _IDENT.match(x):
            continue
        k = None
        # `Conn& c` / `Peer* p` / `PingConn pc` / `const Conn& c`
        if i + 2 < len(texts) and texts[i + 1] in ("&", "*") and \
                _IDENT.match(texts[i + 2]):
            k = (x, texts[i + 2])
        elif i + 1 < len(texts) and _IDENT.match(texts[i + 1]) and \
                texts[i + 1] not in ("const", "override"):
            k = (x, texts[i + 1])
        if k:
            cls = _known_class_in(model, k[0], fn.cls) \
                if k[0] not in ("return", "new", "delete") else None
            if cls and k[0] == cls and k[1] not in out:
                out[k[1]] = cls
        # `make_shared<AsyncState>(...)` assigned: `auto st = ...`
    joined = " ".join(texts)
    for m in re.finditer(
            r"(?:auto|std\s*::\s*shared_ptr\s*<[^>]*>)\s*&?\s*"
            r"([A-Za-z_]\w*)\s*=\s*std\s*::\s*make_shared\s*<\s*"
            r"([A-Za-z_]\w*)\s*>", joined):
        cls = _known_class_in(model, m.group(2), fn.cls)
        if cls:
            out[m.group(1)] = cls
    # `std::shared_ptr<AsyncState> st;` declarations
    for m in re.finditer(
            r"std\s*::\s*shared_ptr\s*<\s*([A-Za-z_]\w*)\s*>\s*&?\s*"
            r"([A-Za-z_]\w*)", joined):
        cls = _known_class_in(model, m.group(1), fn.cls)
        if cls and m.group(2) not in out:
            out[m.group(2)] = cls
    # range-for over a typed container: `for (auto& c : p.conns)`
    # resolves c via the element type of the container's declaration
    # (two passes so a base typed in pass one types its elements here).
    for _ in range(2):
        for m in re.finditer(
                r"for\s*\(\s*(?:const\s+)?auto\s*&\s*([A-Za-z_]\w*)\s*"
                r":\s*([A-Za-z_]\w*)(?:\s*(?:\.|->)\s*([A-Za-z_]\w*))?"
                r"\s*\)", joined):
            var, base, member = m.group(1), m.group(2), m.group(3)
            if var in out:
                continue
            decl = None
            if member:
                base_cls = out.get(base)
                if base_cls:
                    ci = model.class_by_short(base_cls)
                    if ci:
                        decl = ci.member_types.get(member)
            else:
                if fn.cls:
                    for c in model._context_chain(fn.cls):
                        if base in c.member_types:
                            decl = c.member_types[base]
                            break
            if decl:
                cls = _known_class_in(model, decl, fn.cls)
                if cls:
                    out[var] = cls
    return out


def _lock_target(model: Model, arg_texts: List[str], fn: FunctionInfo,
                 var_types: Dict[str, str]) -> Optional[str]:
    """Canonical mutex id of a lock-construction argument expression
    (``mu_``, ``st->mu``, ``p.cma_mu``, ``*x`` ...)."""
    # strip leading `*` / `&`
    a = [x for x in arg_texts if x not in ("*", "&")]
    if not a:
        return None
    if len(a) == 1:
        return model.resolve_mutex(a[0], fn.cls)
    # base . / -> field chains: resolve base var, take LAST field
    if a[-2] in (".", "->") and _IDENT.match(a[-1]):
        fld = a[-1]
        base = None
        for x in a[:-2]:
            if _IDENT.match(x):
                base = x  # last identifier in the base expression
        if base and base in var_types:
            cls = model.class_by_short(var_types[base])
            if cls and fld in cls.mutexes:
                return f"{cls.qual}::{fld}"
        # fall back to unique field-name match
        hits = [c for c in model.classes.values() if fld in c.mutexes]
        if len(hits) == 1:
            return f"{hits[0].qual}::{fld}"
    return None


def check_functions(model: Model) -> Tuple[List[Finding],
                                           List[Tuple[str, str, str]]]:
    """Run the per-function detectors. Returns (findings,
    observed_edges) where an edge is (held_mutex, acquired_mutex,
    site).

    Besides the purely lexical edges (locks nested inside one function
    body), a ONE-LEVEL call-graph propagation pass runs afterwards: a
    helper that takes a lock propagates that acquisition edge to its
    direct callers — ``g() { lock(A); Helper(); }`` with
    ``Helper() { lock(B); }`` records the A→B edge at g's call site,
    which purely lexical analysis misses entirely. Acquisitions a
    helper makes under its ``DDS_REQUIRES`` context are covered the
    same way (the required mutexes are modeled as held inside the
    helper, so its base-frame edges exist; the propagation adds the
    CALLER-held edges on top). Resolution is deliberately
    conservative — a typed receiver or a same-class bare call only, no
    virtual dispatch guessing — so a propagated edge is as trustworthy
    as a lexical one. One level, not transitive closure: summaries
    hold each function's OWN acquisitions only."""
    findings: List[Finding] = []
    edges: List[Tuple[str, str, str]] = []
    seen: Set[str] = set()

    def emit(cat: str, file: str, line: int, symbol: str,
             message: str) -> None:
        f = Finding(cat, file, line, symbol, message)
        if f.key() not in seen:
            seen.add(f.key())
            findings.append(f)

    # (cls-or-None, name) -> union of mutexes the function(s) acquire
    # in their own (non-lambda) frames; overloads merge conservatively.
    summaries: Dict[Tuple[Optional[str], str], Set[str]] = {}
    # call sites with locks held: (caller, callee_cls, callee, held, line)
    calls: List[Tuple[FunctionInfo, Optional[str], str,
                      "frozenset[str]", int]] = []
    for fn in model.functions:
        acquired = _check_one(model, fn, emit, edges, calls)
        summaries.setdefault((fn.cls, fn.name), set()).update(acquired)
    for caller, cls, callee, held, line in calls:
        acq = summaries.get((cls, callee))
        if not acq:
            continue
        for a in held:
            for b in acq:
                edges.append((a, b,
                              f"{caller.file}:{line} ({caller.qual} -> "
                              f"{callee}, one-level propagation)"))
    return findings, edges


def _requires_of(model: Model, fn: FunctionInfo) -> List[str]:
    if not fn.cls:
        return []
    out = []
    for c in model._context_chain(fn.cls):
        for expr in c.requires.get(fn.name, []):
            mid = model.resolve_mutex(expr, fn.cls)
            if mid:
                out.append(mid)
    return out


def _excludes_of(model: Model, fn: FunctionInfo) -> List[str]:
    if not fn.cls:
        return []
    out = []
    for c in model._context_chain(fn.cls):
        for expr in c.excludes.get(fn.name, []):
            mid = model.resolve_mutex(expr, fn.cls)
            if mid:
                out.append(mid)
    return out


def _guard_of(model: Model, cls_short: str, field: str,
              ctx: Optional[str]) -> Optional[str]:
    ci = model.class_by_short(cls_short)
    if not ci or field not in ci.guarded:
        return None
    return model.resolve_mutex(ci.guarded[field], ctx or cls_short)


def _check_one(model: Model, fn: FunctionInfo, emit, edges,
               calls=None) -> Set[str]:
    var_types = _var_types(model, fn)
    required = _requires_of(model, fn)
    excluded = set(_excludes_of(model, fn))
    base = [_Acq(m, 0, None) for m in required]
    frames: List[_Frame] = [_Frame(base)]
    # Mutexes this function acquires in its OWN (non-lambda) frames —
    # the one-level call-graph summary check_functions propagates to
    # call sites. DDS_REQUIRES mutexes are excluded: the caller holds
    # those already, they are not acquisitions of this function.
    acquired_summary: Set[str] = set()
    toks = fn.body
    texts = [t.text for t in toks]
    n = len(toks)
    # vectors of unique_lock (UpdatePeer's all-lane swap)
    lockvec_vars: Set[str] = set()
    call_stack: List[Optional[str]] = []
    lambda_stack: List[Tuple[int, int]] = []  # (frame_idx, depth_at_entry)

    def held() -> List[_Acq]:
        return [a for a in frames[-1].acqs if not a.released]

    def held_ids() -> Set[str]:
        return {a.mutex for a in held()}

    def acquire(mid: str, var: Optional[str], line: int) -> None:
        fr = frames[-1]
        for a in held():
            # a.mutex == mid records a self-edge: re-acquiring a held
            # (non-recursive) mutex is a self-deadlock, surfaced by the
            # order graph's self-loop check.
            edges.append((a.mutex, mid,
                          f"{fn.file}:{line} ({fn.qual})"))
        if mid in excluded:
            emit("excludes", fn.file, line,
                 f"{fn.qual}@{mid}",
                 f"{fn.qual} is DDS_EXCLUDES({_short(mid)}) but "
                 f"acquires it")
        if len(frames) == 1:  # not inside a deferred-execution lambda
            acquired_summary.add(mid)
        fr.acqs.append(_Acq(mid, fr.depth, var))

    i = 0
    while i < n:
        t = toks[i]
        x = t.text
        fr = frames[-1]

        # ---- scope tracking -------------------------------------------------
        if x == "{":
            fr.depth += 1
            i += 1
            continue
        if x == "}":
            fr.depth -= 1
            fr.acqs = [a for a in fr.acqs if a.scope_depth <= fr.depth]
            if lambda_stack and fr.depth < lambda_stack[-1][1]:
                lambda_stack.pop()
                frames.pop()
            i += 1
            continue

        # ---- lambda entry ---------------------------------------------------
        if x == "[" and _is_lambda_start(texts, i):
            j = _match(texts, i, "[", "]")
            # optional params
            k = j + 1
            if k < n and texts[k] == "(":
                k = _match(texts, k, "(", ")") + 1
            # skip specifiers (mutable, ->, type tokens) up to `{`
            while k < n and texts[k] != "{":
                # `;`/`)`/`,` before `{` -> not a lambda body after all
                if texts[k] in (";", ")", ","):
                    break
                k += 1
            if k < n and texts[k] == "{":
                inherits = bool(call_stack) and call_stack[-1] in _CV_WAITS
                nf = _Frame(held() if inherits else [])
                nf.depth = 0
                frames.append(nf)
                lambda_stack.append((len(frames) - 1, 1))
                nf.depth = 0
                # consume up to and including the `{`
                frames[-1].depth = 1
                i = k + 1
                continue
            i = j + 1
            continue

        # ---- call-context tracking ------------------------------------------
        if x == "(":
            prev = texts[i - 1] if i else ""
            call_stack.append(prev if _IDENT.match(prev) else None)
            i += 1
            continue
        if x == ")":
            if call_stack:
                call_stack.pop()
            i += 1
            continue

        # ---- lock declarations ----------------------------------------------
        if x in _LOCK_DECLS:
            decl = _parse_lock_decl(texts, i)
            if decl:
                var, args, end = decl
                if args is None:
                    # deferred-construction vector etc.: nothing held yet
                    i = end
                    continue
                mid = _lock_target(model, args, fn, var_types)
                if mid:
                    acquire(mid, var, toks[min(end, n - 1)].line)
                i = end
                continue
            # `std::vector<std::unique_lock<...>> locks;`
            vec = _parse_lockvec_decl(texts, i)
            if vec:
                lockvec_vars.add(vec)
            i += 1
            continue

        # ---- emplace_back on a lock vector ----------------------------------
        if x == "emplace_back" and i >= 2 and texts[i - 1] == "." and \
                texts[i - 2] in lockvec_vars:
            args, end = _call_args(texts, i + 1)
            mid = _lock_target(model, args, fn, var_types)
            if mid:
                acquire(mid, None, t.line)
            i = end
            continue

        # ---- manual lock()/unlock() on tracked vars or mutexes --------------
        if x in ("lock", "unlock") and i >= 2 and \
                texts[i - 1] in (".", "->") and \
                i + 1 < n and texts[i + 1] == "(":
            basev = texts[i - 2]
            handled = False
            for a in frames[-1].acqs:
                if a.var == basev:
                    a.released = x == "unlock"
                    handled = True
            if not handled and x == "lock":
                mid = _lock_target(model, [basev], fn, var_types)
                if mid:
                    acquire(mid, basev, t.line)
            i += 2
            continue

        # ---- calls: blocking / requires checks ------------------------------
        if _IDENT.match(x) and i + 1 < n and texts[i + 1] == "(":
            is_member_call = i >= 1 and texts[i - 1] in (".", "->")
            if is_member_call and x in _CV_WAITS:
                i += 1
                continue
            if x in BLOCKING_CALLS and x not in _LOCK_DECLS:
                for a in held():
                    if model.mutex_no_blocking(a.mutex):
                        emit("blocking-under-lock", fn.file, t.line,
                             f"{fn.qual}@{_short(a.mutex)}@{x}",
                             f"{fn.qual} calls blocking `{x}` while "
                             f"holding {_short(a.mutex)} "
                             f"(DDS_NO_BLOCKING)")
            # requires-check: method with DDS_REQUIRES called bare or
            # via a typed receiver
            req_cls = None
            if is_member_call:
                basev = _base_var(texts, i - 2)
                if basev in var_types:
                    req_cls = var_types[basev]
            else:
                req_cls = fn.cls
            # One-level call-graph propagation: record the call site
            # with the locks held RIGHT NOW; check_functions joins it
            # against the callee's acquisition summary afterwards.
            # Same conservative resolution as the requires check (a
            # typed receiver or a same-class bare call).
            if calls is not None and req_cls:
                hid = held_ids()
                if hid:
                    calls.append((fn, req_cls, x, frozenset(hid),
                                  t.line))
            if req_cls:
                for c in model._context_chain(req_cls):
                    for expr in c.requires.get(x, []):
                        mid = model.resolve_mutex(expr, req_cls)
                        if mid and mid not in held_ids():
                            emit("requires", fn.file, t.line,
                                 f"{fn.qual}@{x}@{_short(mid)}",
                                 f"{fn.qual} calls {c.name}::{x} "
                                 f"(DDS_REQUIRES({_short(mid)})) "
                                 f"without holding it")
                    if x in c.requires:
                        break

        # ---- guarded field access -------------------------------------------
        if _IDENT.match(x) and not fn.is_ctor_dtor:
            nxt = texts[i + 1] if i + 1 < n else ""
            prev = texts[i - 1] if i else ""
            if nxt not in ("::",) and prev != "::":
                owner: Optional[str] = None
                if prev in (".", "->"):
                    basev = _base_var(texts, i - 2)
                    if basev == "this":
                        owner = fn.cls
                    elif basev in var_types:
                        owner = var_types[basev]
                elif fn.cls and nxt != "(":
                    owner = fn.cls
                if owner:
                    gid = None
                    ocls = None
                    for c in (model._context_chain(owner)
                              if owner == fn.cls and prev not in
                              (".", "->") else
                              [model.class_by_short(owner)] if
                              model.class_by_short(owner) else []):
                        if x in c.guarded:
                            gid = model.resolve_mutex(c.guarded[x],
                                                      fn.cls or c.name)
                            ocls = c
                            break
                    if gid and ocls and gid not in held_ids():
                        emit("guard", fn.file, t.line,
                             f"{fn.qual}@{ocls.name}::{x}",
                             f"{fn.qual} touches {ocls.name}::{x} "
                             f"(DDS_GUARDED_BY({_short(gid)})) without "
                             f"holding it")
        i += 1
    return acquired_summary


def _short(mutex_id: str) -> str:
    parts = mutex_id.split("::")
    return "::".join(parts[-2:])


def _base_var(texts: List[str], k: int) -> str:
    """Identifier of the object expression ending at texts[k]
    (walking back over one `[...]` subscript or `(...)` group, so
    `peers_[i]->hosts` resolves to `peers_`)."""
    if k < 0:
        return ""
    if texts[k] in ("]", ")"):
        op, cl = ("[", "]") if texts[k] == "]" else ("(", ")")
        depth = 0
        while k >= 0:
            if texts[k] == cl:
                depth += 1
            elif texts[k] == op:
                depth -= 1
                if depth == 0:
                    k -= 1
                    break
            k -= 1
    return texts[k] if k >= 0 and _IDENT.match(texts[k] or "") else ""


def _is_lambda_start(texts: List[str], i: int) -> bool:
    prev = texts[i - 1] if i else ""
    if _IDENT.match(prev) or prev in (")", "]"):
        return False  # subscript
    return True


def _match(texts: List[str], i: int, op: str, cl: str) -> int:
    depth = 0
    for k in range(i, len(texts)):
        if texts[k] == op:
            depth += 1
        elif texts[k] == cl:
            depth -= 1
            if depth == 0:
                return k
    return len(texts) - 1


def _call_args(texts: List[str], open_idx: int):
    """Args tokens of the call whose `(` is at open_idx; returns
    (arg_texts, index_after_close)."""
    if open_idx >= len(texts) or texts[open_idx] != "(":
        return [], open_idx + 1
    close = _match(texts, open_idx, "(", ")")
    return texts[open_idx + 1:close], close + 1


def _parse_lock_decl(texts: List[str], i: int):
    """At texts[i] == lock_guard/unique_lock/...: parse
    `lock_guard<...> NAME(ARGS);` -> (name, args, idx_after). Returns
    (name, None, idx) for declarations without a mutex argument."""
    k = i + 1
    if k < len(texts) and texts[k] == "<":
        k = _match(texts, k, "<", ">") + 1
    if k < len(texts) and _IDENT.match(texts[k]):
        name = texts[k]
        if k + 1 < len(texts) and texts[k + 1] == "(":
            args, end = _call_args(texts, k + 1)
            # `std::adopt_lock` etc. ride along; drop trailing tag args
            args = [a for a in args
                    if a not in ("std", "adopt_lock", "defer_lock",
                                 "try_to_lock")]
            while args and args[-1] == ",":
                args.pop()
            # split on top-level comma: first arg is the mutex
            first: List[str] = []
            depth = 0
            for a in args:
                if a in ("(", "<", "["):
                    depth += 1
                elif a in (")", ">", "]"):
                    depth -= 1
                if a == "," and depth == 0:
                    break
                first.append(a)
            return (name, first, end)
        return (name, None, k + 1)
    return None


def _parse_lockvec_decl(texts: List[str], i: int) -> Optional[str]:
    """Detect `vector<std::unique_lock<...>> NAME` idiom; texts[i] is
    the unique_lock token. Walk back over the `std ::` qualifier for
    `vector <` and forward for the name."""
    j = i - 1
    while j >= 0 and texts[j] in ("::", "std"):
        j -= 1
    if j >= 1 and texts[j] == "<" and texts[j - 1] == "vector":
        k = _match(texts, j, "<", ">") + 1
        if k < len(texts) and _IDENT.match(texts[k]):
            return texts[k]
    return None


# -- lock-order graph ---------------------------------------------------------

def check_lock_order(model: Model,
                     edges: List[Tuple[str, str, str]]) -> List[Finding]:
    """Cycle detection over declared + observed acquisition-order
    edges."""
    graph: Dict[str, Dict[str, str]] = {}

    def add(a: str, b: str, site: str) -> None:
        if a == b:
            graph.setdefault(a, {}).setdefault(b, site)
            return
        graph.setdefault(a, {}).setdefault(b, site)
        graph.setdefault(b, {})

    for c in model.classes.values():
        for m, targets in c.acquired_before.items():
            src = model.resolve_mutex(m, c.name)
            for t in targets:
                dst = model.resolve_mutex(t, c.name)
                if src and dst:
                    add(src, dst, f"{c.file} (DDS_ACQUIRED_BEFORE on "
                                  f"{c.name}::{m})")
    for a, b, site in edges:
        add(a, b, site)

    findings: List[Finding] = []
    # self-loops (recursive acquisition) are cycles too
    for a, nbrs in graph.items():
        if a in nbrs:
            findings.append(Finding(
                "lock-order", _file_of(model, a), 0,
                f"cycle:{_short(a)}",
                f"{_short(a)} acquired while already held "
                f"(self-deadlock for a non-recursive mutex) at "
                f"{nbrs[a]}"))
    # Tarjan SCC
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    onstack: Dict[str, bool] = {}
    stack: List[str] = []
    counter = [0]
    sccs: List[List[str]] = []

    def strongconnect(v: str) -> None:
        work = [(v, iter(graph.get(v, {})))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        onstack[v] = True
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    onstack[w] = True
                    work.append((w, iter(graph.get(w, {}))))
                    advanced = True
                    break
                elif onstack.get(w):
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    onstack[w] = False
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in list(graph):
        if v not in index:
            strongconnect(v)
    for scc in sccs:
        if len(scc) < 2:
            continue
        cyc = sorted(_short(m) for m in scc)
        sites = []
        sset = set(scc)
        for a in scc:
            for b, site in graph.get(a, {}).items():
                if b in sset:
                    sites.append(f"{_short(a)}->{_short(b)} at {site}")
        findings.append(Finding(
            "lock-order", _file_of(model, scc[0]), 0,
            "cycle:" + "->".join(cyc),
            "lock-acquisition-order cycle: " + "; ".join(sites)))
    return findings


def _joins_member(texts: List[str], tm: str) -> bool:
    """Does this function body join thread member `tm` — directly, via
    a std::move'd local, or via a range-for loop variable?"""
    joined = " ".join(texts)
    # locals that alias tm: `x = std::move(tm)` / `x(std::move(tm))`
    # and range-for loop vars `for (auto& x : tm)`
    aliases = {tm}
    for m in re.finditer(
            r"([A-Za-z_]\w*)\s*(?:=|\()\s*std\s*::\s*move\s*\(\s*" +
            re.escape(tm) + r"\s*\)", joined):
        aliases.add(m.group(1))
    for m in re.finditer(
            r"for\s*\(\s*(?:const\s+)?auto\s*&\s*([A-Za-z_]\w*)\s*:\s*" +
            re.escape(tm) + r"\s*\)", joined):
        aliases.add(m.group(1))
    for i, x in enumerate(texts):
        if x == "join" and i >= 2 and texts[i - 1] in (".", "->"):
            if _base_var(texts, i - 2) in aliases:
                return True
    return False


def _file_of(model: Model, mutex_id: str) -> str:
    qual = mutex_id.rsplit("::", 1)[0]
    c = model.classes.get(qual)
    return c.file if c else "<unknown>"


# -- destructor / teardown-order checks ---------------------------------------

def check_dtor_order(model: Model) -> List[Finding]:
    findings: List[Finding] = []
    for c in model.classes.values():
        for member, target in c.destroyed_before.items():
            if member not in c.decl_order or target not in c.decl_order:
                findings.append(Finding(
                    "dtor-order", c.file, 0,
                    f"{c.qual}@{member}",
                    f"DDS_DESTROYED_BEFORE({target}) on "
                    f"{c.qual}::{member}: member or target not found "
                    f"in declaration order"))
                continue
            if c.decl_order.index(member) < c.decl_order.index(target):
                findings.append(Finding(
                    "dtor-order", c.file, 0,
                    f"{c.qual}@{member}",
                    f"{c.qual}::{member} is DDS_DESTROYED_BEFORE("
                    f"{target}) but is declared BEFORE it — members "
                    f"are destroyed in reverse declaration order, so "
                    f"it must be declared after {target}"))
        # every std::thread member must be joined by some function of
        # the class — directly (`tm.join()`), after a move into a local
        # (`t = std::move(tm); ... t.join()`, HealthMonitor-style), or
        # via a range-for over a thread vector (`for (auto& t : tm)
        # t.join()`). Merely MENTIONING the member in a function that
        # joins a DIFFERENT thread does not count (a deleted join loop
        # must not stay green because the dtor still clear()s the
        # vector).
        for tm in c.thread_members:
            joined = False
            for fn in model.functions:
                if fn.cls != c.name or joined:
                    continue
                texts = [t.text for t in fn.body]
                joined = _joins_member(texts, tm)
            if not joined:
                findings.append(Finding(
                    "dtor-order", c.file, 0,
                    f"{c.qual}@{tm}",
                    f"thread member {c.qual}::{tm} is never joined by "
                    f"any function of {c.name} (destructor would "
                    f"terminate)"))
    return findings
