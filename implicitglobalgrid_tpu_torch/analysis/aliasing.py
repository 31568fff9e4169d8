"""Stream-aliasing analyzer (``stream-aliasing``), the twin of the JAX
package's ``analysis/aliasing.py``.

In JAX the hazard is a kernel's declared input/output aliasing against its
real in-place writes.  The port's kernels write fresh outputs, except a
pipelined mid pass, which writes into its ring pass's outputs
(``carry_in``) on a second CUDA stream (`models._fused`), and the slab
exchange, which reads the fields on the communication stream
(`ops.halo.begin_slab_exchange`).  There the contract is stream order and
the caching allocator: a launch under ``torch.cuda.stream(S)`` may touch a
tensor only after ``S`` waited for the work that produced it
(``S.wait_stream``/``S.wait_event``), and the tensor must be marked
``t.record_stream(S)``, or the allocator hands its memory to the next
allocation on its own stream while ``S`` still reads or writes it.  No
declaration states either, so this pass reads the package's ASTs:

* every ``with torch.cuda.stream(S):`` block needs a wait of ``S`` before
  it in its function (``unordered-stream-launch``), and a ``record_stream``
  on ``S`` for every tensor operand of a call inside it
  (``missing-record-stream``).  A call's operands are its ``Name``
  arguments (loop variables resolved to what they iterate), kept where
  the function shows them to hold tensors: a parameter it indexes or
  unpacks (a tuple of fields), or a local it got from a call of one of
  its callers' parameters (a launch callback's output);
* a kernel wrapper that takes ``carry_in`` must launch on the current
  stream (``torch.cuda.current_stream``), so that the caller's stream
  discipline covers the tensors it writes into (``carry-in-off-stream``).
"""

from __future__ import annotations

import ast

from .core import Context, Finding

ANALYZER = "stream-aliasing"


def _is_stream_ctx(expr) -> bool:
    return (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "stream" and isinstance(expr.func.value, ast.Attribute)
            and expr.func.value.attr == "cuda" and len(expr.args) == 1)


def _own_walk(fn):
    """The nodes of ``fn``'s body, not descending into nested functions
    (each is checked as a site of its own)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _names(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _params(fn) -> set:
    a = fn.args
    return {x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)} | {
        x.arg for x in (a.vararg, a.kwarg) if x is not None}


def _tensor_names(fn, outer_params: set) -> set:
    """Names ``fn`` shows to hold tensors (see the module docstring)."""
    params = _params(fn)
    out = set()
    for n in _own_walk(fn):
        if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name) \
                and n.value.id in params:
            out.add(n.value.id)
        elif isinstance(n, ast.Starred) and isinstance(n.value, ast.Name) \
                and n.value.id in params:
            out.add(n.value.id)
        elif isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                and isinstance(n.value.func, ast.Name) \
                and n.value.func.id in outer_params | params:
            for t in n.targets:
                out |= _names(t)
    return out


def _loop_sources(fn) -> dict:
    """``{loop variable: names of what it iterates}`` in ``fn``."""
    out: dict = {}
    for n in _own_walk(fn):
        if isinstance(n, (ast.For, ast.comprehension)):
            for v in _names(n.target):
                out.setdefault(v, set()).update(_names(n.iter))
    return out


def _resolve(name: str, loops: dict, seen=None) -> set:
    seen = seen or set()
    if name in seen:
        return set()
    seen.add(name)
    if name not in loops:
        return {name}
    out = set()
    for src in loops[name]:
        out |= _resolve(src, loops, seen)
    return out


def _stream_site_findings(rel, fn, qual, outer_params) -> list[Finding]:
    out = []
    loops = _loop_sources(fn)
    tensors = _tensor_names(fn, outer_params)
    for w in _own_walk(fn):
        if not isinstance(w, ast.With):
            continue
        for item in w.items:
            if not _is_stream_ctx(item.context_expr):
                continue
            stream = ast.unparse(item.context_expr.args[0])
            waited, recorded = False, set()
            for c in _own_walk(fn):
                if not (isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)):
                    continue
                owner = ast.unparse(c.func.value)
                if c.func.attr in ("wait_stream", "wait_event") and owner == stream \
                        and c.lineno < w.lineno:
                    waited = True
                if c.func.attr == "record_stream" and c.args \
                        and ast.unparse(c.args[0]) == stream:
                    for n in _names(c.func.value):
                        recorded |= _resolve(n, loops)
            operands = set()
            for c in (n for stmt in w.body for n in ast.walk(stmt)):
                if isinstance(c, ast.Call):
                    for a in (*c.args, *(k.value for k in c.keywords)):
                        a = a.value if isinstance(a, ast.Starred) else a
                        if isinstance(a, ast.Name):
                            operands |= _resolve(a.id, loops)
            operands &= tensors
            if not waited:
                out.append(Finding(
                    analyzer=ANALYZER, code="unordered-stream-launch", severity="ERROR",
                    message=(f"work under torch.cuda.stream({stream}) with no "
                             f"{stream}.wait_stream/wait_event before it: it may run before "
                             f"the work that produced its inputs."),
                    path=rel, line=w.lineno, symbol=qual, anchor=stream,
                    fix_hint=f"{stream}.wait_stream(<the producing stream>) first."))
            for name in sorted(operands - recorded):
                out.append(Finding(
                    analyzer=ANALYZER, code="missing-record-stream", severity="ERROR",
                    message=(f"`{name}` is used under torch.cuda.stream({stream}) without "
                             f"record_stream({stream}): the caching allocator may hand its "
                             f"memory to another tensor while {stream} still reads or "
                             f"writes it."),
                    path=rel, line=w.lineno, symbol=qual, anchor=f"{stream}:{name}",
                    fix_hint=f"for t in {name}: t.record_stream({stream})"))
    return out


def _carry_in_findings(rel, fn, qual) -> list[Finding]:
    if "carry_in" not in _params(fn):
        return []
    launches = any(isinstance(n, ast.Attribute) and n.attr == "data_ptr"
                   for n in _own_walk(fn))
    on_current = any(isinstance(n, ast.Attribute) and n.attr == "current_stream"
                     for n in _own_walk(fn))
    if not launches or on_current:
        return []
    return [Finding(
        analyzer=ANALYZER, code="carry-in-off-stream", severity="ERROR",
        message=("a kernel wrapper that writes into carry_in launches on a stream other "
                 "than the current one: the caller's waits and record_stream calls do not "
                 "cover it."),
        path=rel, line=fn.lineno, symbol=qual, anchor="carry_in",
        fix_hint="launch on torch.cuda.current_stream(device).cuda_stream.")]


def stream_findings(ctx: Context) -> list[Finding]:
    out = []

    def visit(rel, node, stack, outer_params):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = ".".join((*stack, child.name))
                out.extend(_stream_site_findings(rel, child, qual, outer_params))
                out.extend(_carry_in_findings(rel, child, qual))
                visit(rel, child, (*stack, child.name), outer_params | _params(child))
            else:
                visit(rel, child, stack, outer_params)

    for rel, (_src, tree) in ctx.module_asts().items():
        visit(rel, tree, (), set())
    return out


def run(ctx: Context) -> list[Finding]:
    return stream_findings(ctx)
