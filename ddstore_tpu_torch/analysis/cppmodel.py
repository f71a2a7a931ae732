"""Lightweight C++ source model for the repo-native analyzer.

No libclang, no compiler: a comment/string-aware lexer plus a
brace-tracking scope walker, tuned to this codebase's idioms (Google
style, no templates-of-templates at definition sites, annotations from
``native/thread_annotations.h``). The headers' ``DDS_*`` annotations are
the ground truth the lock checker consumes; this module extracts them
together with class structure (mutex members, guarded fields, member
types, declaration order) and every function body as a token stream.

Deliberately approximate where approximation is safe: unresolvable
member accesses (iterator ``it->second`` chains, ``auto`` vars) are
skipped rather than guessed, so imprecision costs coverage, never false
positives.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DDS_MACROS = ("DDS_GUARDED_BY", "DDS_REQUIRES", "DDS_EXCLUDES",
              "DDS_ACQUIRED_BEFORE", "DDS_NO_BLOCKING",
              "DDS_DESTROYED_BEFORE")

_TOKEN_RE = re.compile(
    r"[A-Za-z_][A-Za-z0-9_]*"          # identifier
    r"|\d[\dxXa-fA-F'.uUlLfe+-]*"      # number (loose)
    r"|::|->|<<=|>>=|<=|>=|==|!=|&&|\|\||\+\+|--|\+=|-=|\*=|/=|\|=|&="
    r"|[{}()\[\];,<>=&|!~^*/%+.?:-]"   # single-char punct
)


@dataclass
class Token:
    text: str
    line: int


def _scan_source(text: str) -> Tuple[str, List[Tuple[int, str]]]:
    """ONE comment/preprocessor/string state machine for both views of
    a C++ source: returns (stripped text, [(line, string literal)]).
    In the stripped text, comments, preprocessor lines, and string/char
    literal CONTENTS are blanked with spaces (quotes kept) — byte
    offsets and line numbers are preserved exactly. Literal values are
    captured before blanking, so the knob scanner and the lock checker
    always share one view of what is code."""
    out = list(text)
    # Blank preprocessor lines first (whole line; handles continuation).
    for m in re.finditer(r"^[ \t]*#[^\n]*(\\\n[^\n]*)*", text, re.M):
        for j in range(m.start(), m.end()):
            if out[j] != "\n":
                out[j] = " "
    text = "".join(out)
    n = len(text)
    i = 0
    line = 1
    state = "code"
    lits: List[Tuple[int, str]] = []
    cur: List[str] = []
    cur_line = 0
    while i < n:
        c = text[i]
        nxt = text[i + 1] if i + 1 < n else ""
        if c == "\n":
            line += 1
        if state == "code":
            if c == "/" and nxt == "/":
                state = "line"
                out[i] = out[i + 1] = " "
                i += 2
                continue
            if c == "/" and nxt == "*":
                state = "block"
                out[i] = out[i + 1] = " "
                i += 2
                continue
            if c == '"':
                state = "str"
                cur = []
                cur_line = line
                i += 1
                continue
            if c == "'":
                state = "chr"
                i += 1
                continue
            i += 1
            continue
        if state == "line":
            if c == "\n":
                state = "code"
            else:
                out[i] = " "
            i += 1
            continue
        if state == "block":
            if c == "*" and nxt == "/":
                out[i] = out[i + 1] = " "
                state = "code"
                i += 2
                continue
            if c != "\n":
                out[i] = " "
            i += 1
            continue
        if state in ("str", "chr"):
            quote = '"' if state == "str" else "'"
            if c == "\\":
                if state == "str":
                    cur.append(c)
                    if i + 1 < n:
                        cur.append(text[i + 1])
                out[i] = " "
                if i + 1 < n and text[i + 1] != "\n":
                    out[i + 1] = " "
                i += 2
                continue
            if c == quote:
                if state == "str":
                    lits.append((cur_line, "".join(cur)))
                state = "code"
            elif c != "\n":
                if state == "str":
                    cur.append(c)
                out[i] = " "
            i += 1
            continue
    return "".join(out), lits


def strip_comments(text: str) -> str:
    """Stripped-code view (see _scan_source)."""
    return _scan_source(text)[0]


def string_literals(text: str) -> List[Tuple[int, str]]:
    """(line, value) for every string literal in code (comments and
    preprocessor lines excluded); same state machine as
    strip_comments."""
    return _scan_source(text)[1]


def tokenize(stripped: str) -> List[Token]:
    toks = []
    line = 1
    pos = 0
    for m in _TOKEN_RE.finditer(stripped):
        line += stripped.count("\n", pos, m.start())
        pos = m.start()
        toks.append(Token(m.group(0), line))
    return toks


@dataclass
class ClassInfo:
    name: str                 # short name, e.g. "Conn"
    qual: str                 # scope path, e.g. "TcpTransport::Conn"
    file: str
    mutexes: List[str] = field(default_factory=list)
    #: field -> guard expression text (as written in the annotation)
    guarded: Dict[str, str] = field(default_factory=dict)
    no_blocking: List[str] = field(default_factory=list)
    #: mutex field -> [target exprs]
    acquired_before: Dict[str, List[str]] = field(default_factory=dict)
    #: member -> member it must be destroyed before (declared after)
    destroyed_before: Dict[str, str] = field(default_factory=dict)
    #: method -> [mutex exprs]
    requires: Dict[str, List[str]] = field(default_factory=dict)
    excludes: Dict[str, List[str]] = field(default_factory=dict)
    #: members of type std::thread / std::vector<std::thread>
    thread_members: List[str] = field(default_factory=list)
    #: member name -> declaration text (for member type resolution)
    member_types: Dict[str, str] = field(default_factory=dict)
    #: member declaration order (fields only, best effort)
    decl_order: List[str] = field(default_factory=list)


@dataclass
class FunctionInfo:
    name: str                 # unqualified
    qual: str                 # e.g. "TcpTransport::ReadVOn"
    cls: Optional[str]        # short class name context, if any
    file: str
    line: int
    body: List[Token]
    params: List[Token]
    is_ctor_dtor: bool = False


class Model:
    """Everything the detectors need, across all parsed files."""

    def __init__(self) -> None:
        self.classes: Dict[str, ClassInfo] = {}   # qual -> info
        self.functions: List[FunctionInfo] = []
        self.files: Dict[str, str] = {}           # path -> stripped text
        self.strings: Dict[str, List[Tuple[int, str]]] = {}

    # -- class lookup helpers ------------------------------------------------

    def class_by_short(self, short: str) -> Optional[ClassInfo]:
        hits = [c for c in self.classes.values() if c.name == short]
        return hits[0] if len(hits) == 1 else None

    def resolve_mutex(self, expr: str,
                      ctx: Optional[str]) -> Optional[str]:
        """Canonical mutex id ("Qual::field") for an annotation/lock
        expression, resolved against context class short name `ctx`
        first, then globally by unique match."""
        expr = expr.strip()
        if "::" in expr:
            cls_name, fld = expr.rsplit("::", 1)
            cls_name = cls_name.split("::")[-1]
            for c in self.classes.values():
                if c.name == cls_name and fld in c.mutexes:
                    return f"{c.qual}::{fld}"
            return None
        # bare name: context class chain first
        if ctx:
            chain = self._context_chain(ctx)
            for c in chain:
                if expr in c.mutexes:
                    return f"{c.qual}::{expr}"
        hits = [c for c in self.classes.values() if expr in c.mutexes]
        if len(hits) == 1:
            return f"{hits[0].qual}::{expr}"
        return None

    def _context_chain(self, short: str) -> List[ClassInfo]:
        """The class with this short name plus its enclosing classes
        (innermost first)."""
        out = []
        for c in self.classes.values():
            if c.name == short:
                out.append(c)
                parts = c.qual.split("::")[:-1]
                while parts:
                    q = "::".join(parts)
                    if q in self.classes:
                        out.append(self.classes[q])
                    parts.pop()
                break
        return out

    def mutex_no_blocking(self, mutex_id: str) -> bool:
        qual, fld = mutex_id.rsplit("::", 1)
        c = self.classes.get(qual)
        return bool(c) and fld in c.no_blocking


_CLASS_HEAD = ("class", "struct")
_SKIP_HEAD = ("enum", "union")


def parse_file(model: Model, path: str, display: str) -> None:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        raw = f.read()
    stripped, lits = _scan_source(raw)
    model.files[display] = stripped
    model.strings[display] = lits
    toks = tokenize(stripped)
    _walk(model, toks, display)


def _walk(model: Model, toks: List[Token], display: str) -> None:
    """One pass over the token stream: maintain a scope stack of
    ("ns"|"class"|"fn"|"expr", name) entries; collect class decls and
    function bodies."""
    i = 0
    n = len(toks)
    scopes: List[Tuple[str, str]] = []   # (kind, name)
    stmt: List[Token] = []               # tokens since last boundary

    def class_path() -> List[str]:
        return [name for kind, name in scopes if kind == "class"]

    while i < n:
        t = toks[i]
        if t.text == "{":
            kind, name = _classify_brace(stmt)
            if kind == "class":
                qual = "::".join(class_path() + [name])
                if qual not in model.classes:
                    model.classes[qual] = ClassInfo(name, qual, display)
                scopes.append(("class", name))
                stmt = []
                i += 1
                continue
            if kind == "fn":
                # find matching close brace, record body
                depth = 1
                j = i + 1
                while j < n and depth:
                    if toks[j].text == "{":
                        depth += 1
                    elif toks[j].text == "}":
                        depth -= 1
                    j += 1
                body = toks[i + 1:j - 1]
                fname, fcls, params = _fn_identity(stmt, class_path())
                if fname:
                    cshort = fcls
                    is_cd = bool(cshort) and (fname == cshort or
                                              fname == "~" + cshort)
                    model.functions.append(FunctionInfo(
                        fname,
                        "::".join(([] if not cshort else [cshort]) +
                                  [fname]),
                        cshort, display, t.line, body, params, is_cd))
                    # method-level annotations in the definition head
                    _fn_annotations(model, stmt, cshort, fname)
                stmt = []
                i = j
                continue
            # namespace / extern "C" / skip-scope / expr brace
            scopes.append((kind, name))
            stmt = [] if kind != "expr" else stmt
            i += 1
            continue
        if t.text == "}":
            if scopes and scopes[-1][0] == "expr":
                # initializer brace (`RouteClass r_ DDS_...(m){...}`):
                # the declaration continues to the `;` — keep the
                # statement head for _class_member.
                scopes.pop()
                i += 1
                continue
            if scopes:
                scopes.pop()
            stmt = []
            i += 1
            # swallow optional trailing `;`
            if i < n and toks[i].text == ";":
                i += 1
            continue
        if t.text == ";":
            if scopes and scopes[-1][0] == "class":
                _class_member(model, stmt,
                              "::".join(class_path()))
            stmt = []
            i += 1
            continue
        if t.text == ":" and stmt and stmt[-1].text in (
                "public", "private", "protected"):
            stmt.pop()  # access specifier, not part of a declaration
            i += 1
            continue
        stmt.append(t)
        i += 1


def _classify_brace(stmt: List[Token]) -> Tuple[str, str]:
    """What does this `{` open, judging by the statement tokens before
    it?"""
    texts = [t.text for t in stmt]
    if not texts:
        return ("expr", "")
    if "namespace" in texts or texts[0] == "extern":
        name = texts[-1] if texts[-1] != "namespace" else ""
        return ("ns", name)
    for kw in _SKIP_HEAD:
        if kw in texts:
            return ("expr", "")
    for kw in _CLASS_HEAD:
        if kw in texts:
            # `class X { ...` / `struct X : public Y {` — but NOT a
            # variable of struct type (`struct stat st;` never reaches
            # a brace). Name = identifier right after the keyword.
            k = texts.index(kw)
            if k + 1 < len(texts) and re.match(r"[A-Za-z_]\w*$",
                                               texts[k + 1]):
                return ("class", texts[k + 1])
            return ("expr", "")
    # function definition: a top-level (...) group whose opening paren
    # is preceded by a non-macro identifier, and the statement does not
    # look like an initializer (`= {`).
    if "=" in texts and texts.index("=") > 0 and "(" not in texts:
        return ("expr", "")
    name, _cls, _params = _fn_identity(stmt, [])
    if name:
        return ("fn", name)
    return ("expr", "")


def _fn_identity(stmt: List[Token], class_path: List[str]):
    """(name, class_short, params) if the statement head is a function
    definition, else (None, None, [])."""
    texts = [t.text for t in stmt]
    # locate the parameter list: the FIRST top-level paren group whose
    # preceding identifier is not an annotation macro and not a known
    # keyword; skip over trailing const/override/noexcept, annotation
    # macros, and ctor initializer lists. Parens inside template angle
    # brackets (`std::function<bool(int)>`) are NOT parameter lists —
    # track an angle depth (a `<` following an identifier opens one).
    depth = 0
    adepth = 0
    open_idx = -1
    for k, x in enumerate(texts):
        if x == "<" and k and (re.match(r"[A-Za-z_]\w*$", texts[k - 1])
                               or texts[k - 1] == ">"):
            adepth += 1
            continue
        if x == ">" and adepth > 0:
            adepth -= 1
            continue
        if adepth > 0:
            continue
        if x == "(":
            if depth == 0:
                prev = texts[k - 1] if k else ""
                if (re.match(r"[A-Za-z_]\w*$", prev)
                        and prev not in DDS_MACROS
                        and prev not in ("if", "for", "while", "switch",
                                         "return", "sizeof", "catch")):
                    open_idx = k
                    break
            depth += 1
        elif x == ")":
            depth -= 1
    if open_idx < 0:
        return (None, None, [])
    name = texts[open_idx - 1]
    # destructor?
    if open_idx >= 2 and texts[open_idx - 2] == "~":
        name = "~" + name
    cls = None
    k = open_idx - 2 - (1 if name.startswith("~") else 0)
    if k >= 1 and texts[k] == "::" and re.match(r"[A-Za-z_]\w*$",
                                                texts[k - 1]):
        cls = texts[k - 1]
    elif class_path:
        cls = class_path[-1]
    if name.startswith("~") and cls is None:
        cls = name[1:]
    # reject obvious non-definitions: control keywords as names
    if name in ("if", "for", "while", "switch", "catch"):
        return (None, None, [])
    # params: tokens inside the balanced group
    depth = 0
    params = []
    for t in stmt[open_idx:]:
        if t.text == "(":
            depth += 1
            if depth == 1:
                continue
        elif t.text == ")":
            depth -= 1
            if depth == 0:
                break
        params.append(t)
    return (name, cls, params)


def _macro_args(texts: List[str], k: int) -> List[str]:
    """Comma-split args of the macro call starting at texts[k] (the
    macro name)."""
    if k + 1 >= len(texts) or texts[k + 1] != "(":
        return []
    depth = 0
    args: List[str] = []
    cur: List[str] = []
    for x in texts[k + 1:]:
        if x == "(":
            depth += 1
            if depth == 1:
                continue
        elif x == ")":
            depth -= 1
            if depth == 0:
                break
        if x == "," and depth == 1:
            args.append("".join(cur))
            cur = []
        else:
            cur.append(x)
    if cur:
        args.append("".join(cur))
    return [a for a in (a.strip() for a in args) if a]


def _fn_annotations(model: Model, stmt: List[Token],
                    cls: Optional[str], fname: str) -> None:
    texts = [t.text for t in stmt]
    for k, x in enumerate(texts):
        if x in ("DDS_REQUIRES", "DDS_EXCLUDES") and cls:
            ci = model.class_by_short(cls)
            if ci is None:
                continue
            args = _macro_args(texts, k)
            if x == "DDS_REQUIRES":
                ci.requires.setdefault(fname, []).extend(args)
            else:
                ci.excludes.setdefault(fname, []).extend(args)


_MUTEX_TYPES = ("mutex", "shared_mutex", "recursive_mutex",
                "timed_mutex")


def _class_member(model: Model, stmt: List[Token], qual: str) -> None:
    """Process one `;`-terminated statement at class scope."""
    if not stmt or qual not in model.classes:
        return
    ci = model.classes[qual]
    texts = [t.text for t in stmt]
    # annotations present?
    macro_idx = [k for k, x in enumerate(texts) if x in DDS_MACROS]

    # Is it a method declaration? (a top-level paren group preceded by a
    # plain identifier that is not a macro) — methods carry
    # REQUIRES/EXCLUDES; fields carry the rest.
    name_m, _cls, _p = _fn_identity(stmt, [qual.split("::")[-1]])
    is_method = name_m is not None
    if is_method:
        for k in macro_idx:
            x = texts[k]
            args = _macro_args(texts, k)
            if x == "DDS_REQUIRES":
                ci.requires.setdefault(name_m, []).extend(args)
            elif x == "DDS_EXCLUDES":
                ci.excludes.setdefault(name_m, []).extend(args)
        return

    # field: name = last identifier before the first macro / `=` / end.
    stop = len(texts)
    for k in macro_idx:
        stop = min(stop, k)
    if "=" in texts:
        stop = min(stop, texts.index("="))
    fname = None
    for x in reversed(texts[:stop]):
        if re.match(r"[A-Za-z_]\w*$", x) and x not in (
                "const", "mutable", "static", "constexpr", "struct",
                "class", "volatile"):
            fname = x
            break
    if not fname:
        return
    decl_text = " ".join(texts[:stop])
    ci.member_types[fname] = decl_text
    ci.decl_order.append(fname)
    is_mutex = any(re.search(rf"(^|::|\s){mt}\s*$",
                             decl_text.rsplit(fname, 1)[0].strip())
                   for mt in _MUTEX_TYPES)
    if is_mutex:
        ci.mutexes.append(fname)
    if re.search(r"(^|\W)std\s*::\s*thread(\W|$)",
                 decl_text) or re.search(
                     r"vector\s*<\s*std\s*::\s*thread\s*>", decl_text):
        ci.thread_members.append(fname)
    for k in macro_idx:
        x = texts[k]
        args = _macro_args(texts, k)
        if x == "DDS_GUARDED_BY" and args:
            ci.guarded[fname] = args[0]
        elif x == "DDS_NO_BLOCKING":
            if fname in ci.mutexes:
                ci.no_blocking.append(fname)
        elif x == "DDS_ACQUIRED_BEFORE":
            ci.acquired_before.setdefault(fname, []).extend(args)
        elif x == "DDS_DESTROYED_BEFORE" and args:
            ci.destroyed_before[fname] = args[0]
