"""Dy2static control-flow conversion (port of
``paddle_tpu/jit/dy2static.py``; reference: jit/dy2static/ --
program_translator.py:305 with ifelse_transformer.py / loop_transformer.py
/ logical_transformer.py among its ~20 AST transformers).

The reference rewrites imperative Python into ProgramDesc control-flow ops
(cond / while); the JAX package into ``lax.cond`` / ``lax.while_loop``.
Here the target is one ``torch.compile`` graph: a tensor-predicate ``if``
/ ``while`` must become ``torch.cond`` / ``while_loop``, or the compiler
meets data-dependent Python control flow and (with ``fullgraph=True``)
fails. The AST half is the JAX package's, copied as it is:

- :func:`convert_to_static` parses the function source, rewrites

  * ``if <pred>: A else: B``      -> ``convert_ifelse(pred, tfn, ffn, vars)``
  * ``while <pred>: BODY``        -> ``convert_while(cond_fn, body_fn, vars)``
  * ``a and b`` / ``a or b``      -> lazy ``convert_logical_and/or``
  * ``not a``                     -> ``convert_logical_not``

  using autograph-style nested functions whose arguments/returns are the
  branch-assigned variables (no nonlocal mutation inside a branch).
- The runtime converters dispatch on the predicate: a Python/numpy bool or
  a tensor outside a compiled program keeps plain Python semantics (zero
  overhead, branches may diverge in structure); a tensor while compiling
  lowers to ``torch.cond`` / ``torch._higher_order_ops.while_loop``, whose
  contracts are ``lax.cond``'s: both branches return the same structure,
  shapes and dtypes; a loop body keeps its variables' shapes and dtypes.
- Patterns that cannot lower (``break``/``continue``/``return`` inside a
  tensor-predicate branch or loop) are left as Python and surface as a LOUD
  error naming the function and the rewrite (:func:`control_flow_guidance`,
  raised by ``jit.to_static``).
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["convert_to_static", "convert_ifelse", "convert_while",
           "convert_logical_and", "convert_logical_or",
           "convert_logical_not", "control_flow_guidance", "Undefined"]


# --------------------------------------------------------------------------
# runtime converters
# --------------------------------------------------------------------------

def _is_dynamic(pred) -> bool:
    """True when the predicate is a tensor of a program being compiled --
    the only case that must lower to graph control flow."""
    return isinstance(pred, torch.Tensor) and torch.compiler.is_compiling()


def _as_pred(x) -> torch.Tensor:
    return x.to(torch.bool).reshape(())


def _unaliased(fn: Callable) -> Callable:
    """``fn`` returning a copy of each operand it returns as it is: the
    branches and bodies of ``torch.cond`` / ``while_loop`` may not alias
    their inputs (a variable no branch assigns comes back unchanged)."""
    def wrapped(*args):
        return tuple(o.clone() if isinstance(o, torch.Tensor)
                     and any(o is a for a in args) else o
                     for o in fn(*args))
    return wrapped


def convert_ifelse(pred, true_fn: Callable, false_fn: Callable,
                   args: Tuple = ()):
    """``if``/``else`` with branch-assigned vars passed through ``args``
    and returned as a tuple. Tensor predicate while compiling ->
    ``torch.cond`` (both branches traced, structures must match; the
    branch-assigned vars are its operands); otherwise a plain call."""
    if not _is_dynamic(pred):
        return true_fn(*args) if bool(pred) else false_fn(*args)
    return tuple(torch.cond(_as_pred(pred), _unaliased(true_fn),
                            _unaliased(false_fn), tuple(args)))


class Undefined:
    """A local that no branch/loop iteration has assigned yet (autograph's
    'Undefined' pattern): VALUE-like use fails loudly with the variable
    name, while attribute probes stay inert (hasattr checks must see a
    plain AttributeError, not a crash)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _die(self, *a, **k):
        raise UnboundLocalError(
            f"local variable {self.name!r} referenced before assignment "
            f"(a dy2static-converted branch/loop did not bind it on the "
            f"path taken)")

    def __repr__(self):
        return f"<undefined local {self.name!r}>"

    __bool__ = __iter__ = __len__ = __call__ = _die
    __add__ = __radd__ = __sub__ = __rsub__ = _die
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _die
    __neg__ = __float__ = __int__ = __getitem__ = _die
    __lt__ = __le__ = __gt__ = __ge__ = _die
    __eq__ = __ne__ = _die          # v == 2 must not silently be False
    __hash__ = object.__hash__      # (defining __eq__ clears __hash__)


def convert_while(cond_fn: Callable, body_fn: Callable, init: Tuple):
    """``while`` with loop-carried vars. Concrete condition -> plain Python
    iteration (checked once per iteration; may turn into a tensor of the
    compiled program mid-loop, in which case ``while_loop`` takes over FROM
    THE CURRENT state); tensor condition while compiling -> ``while_loop``
    (the body must keep shapes and dtypes)."""
    vars_ = tuple(init)
    c = cond_fn(*vars_)
    while not _is_dynamic(c):
        if not bool(c):
            return vars_
        vars_ = tuple(body_fn(*vars_))
        c = cond_fn(*vars_)
    from torch._higher_order_ops import while_loop

    return tuple(while_loop(lambda *vs: _as_pred(cond_fn(*vs)),
                            _unaliased(body_fn), vars_))


def convert_logical_and(lhs_fn: Callable, rhs_fn: Callable):
    l = lhs_fn()
    if not _is_dynamic(l):
        return l if not bool(l) else rhs_fn()
    r = rhs_fn()
    return torch.logical_and(l.to(torch.bool), torch.as_tensor(r).to(
        device=l.device, dtype=torch.bool))


def convert_logical_or(lhs_fn: Callable, rhs_fn: Callable):
    l = lhs_fn()
    if not _is_dynamic(l):
        return l if bool(l) else rhs_fn()
    r = rhs_fn()
    return torch.logical_or(l.to(torch.bool), torch.as_tensor(r).to(
        device=l.device, dtype=torch.bool))


def convert_logical_not(x):
    if not _is_dynamic(x):
        return not bool(x)
    return torch.logical_not(x.to(torch.bool))


def control_flow_guidance() -> str:
    return (
        "Supported rewrites: (1) keep the `if`/`while` free of "
        "break/continue/return so dy2static can lower it to "
        "torch.cond/while_loop; (2) use paddle.where / torch.where for "
        "per-element selection; (3) hoist the data-dependent decision out "
        "of the compiled function; (4) mark the function @not_to_static to "
        "run it eagerly.")


# --------------------------------------------------------------------------
# AST transformation
# --------------------------------------------------------------------------

_RT = "_paddle_jst"          # runtime module alias injected into globals


class _AssignedNames(ast.NodeVisitor):
    """Names bound by a statement list (stopping at nested scopes)."""

    def __init__(self):
        self.names: List[str] = []

    def _add(self, name):
        if name not in self.names:
            self.names.append(name)

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self._add(node.id)

    def visit_FunctionDef(self, node):
        self._add(node.name)      # binds the name; don't descend

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass

    def visit_ListComp(self, node):  # comprehensions have their own scope
        pass

    visit_SetComp = visit_DictComp = visit_GeneratorExp = visit_ListComp


def _assigned(stmts) -> List[str]:
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    return v.names


class _HasEscape(ast.NodeVisitor):
    """break/continue/return/yield at this control-flow level (not inside a
    nested loop for break/continue, never inside a nested function)."""

    def __init__(self):
        self.found = False

    def visit_Return(self, node):
        self.found = True

    def visit_Yield(self, node):
        self.found = True

    visit_YieldFrom = visit_Yield

    def visit_Break(self, node):
        self.found = True

    def visit_Continue(self, node):
        self.found = True

    def visit_While(self, node):      # nested loop owns its break/continue
        for s in node.body + node.orelse:
            _ret = _ReturnOnly()
            _ret.visit(s)
            self.found = self.found or _ret.found

    visit_For = visit_While

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_Lambda = visit_FunctionDef


class _ReturnOnly(ast.NodeVisitor):
    def __init__(self):
        self.found = False

    def visit_Return(self, node):
        self.found = True

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_Lambda = visit_FunctionDef


def _has_escape(stmts) -> bool:
    v = _HasEscape()
    for s in stmts:
        v.visit(s)
    return v.found


def _uses_global_nonlocal(stmts) -> bool:
    for s in stmts:
        for n in ast.walk(s):
            if isinstance(n, (ast.Global, ast.Nonlocal)):
                return True
    return False


class _ControlFlowTransformer(ast.NodeTransformer):
    """Statement-level rewrite with a sequential maybe-bound name table (a
    name assigned anywhere earlier in document order counts as bound — the
    autograph approximation; truly-unbound names fail at the call site the
    same way they would have in the original code)."""

    def __init__(self):
        self._uid = 0
        self.bound: List[str] = []
        self.changed = False

    def _fresh(self, kind):
        self._uid += 1
        return f"__pt_{kind}_{self._uid}"

    def _bind(self, names):
        for n in names:
            if n not in self.bound:
                self.bound.append(n)

    # -- scope roots -------------------------------------------------------
    def visit_FunctionDef(self, node, _outer=True):
        args = node.args
        names = [a.arg for a in (args.posonlyargs + args.args
                                 + args.kwonlyargs)]
        if args.vararg:
            names.append(args.vararg.arg)
        if args.kwarg:
            names.append(args.kwarg.arg)
        self._bind(names)
        node.body = self._visit_block(node.body)
        return node

    def _visit_block(self, stmts):
        out = []
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                # nested scopes are left untouched: transforming them with
                # the OUTER maybe-bound table could turn a valid closure
                # read into an unbound argument
                self._bind([s.name])
                out.append(s)
                continue
            r = self.visit(s)
            self._bind(_assigned([s]))
            if isinstance(r, list):
                out.extend(r)
            elif r is not None:
                out.append(r)
        return out

    # -- expression rewrites ----------------------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = ("convert_logical_and" if isinstance(node.op, ast.And)
              else "convert_logical_or")
        expr = node.values[-1]
        for prev in reversed(node.values[:-1]):
            expr = ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id=_RT, ctx=ast.Load()), attr=fn,
                    ctx=ast.Load()),
                args=[ast.Lambda(args=_empty_args(), body=prev),
                      ast.Lambda(args=_empty_args(), body=expr)],
                keywords=[])
        self.changed = True
        return expr

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            self.changed = True
            return ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id=_RT, ctx=ast.Load()),
                    attr="convert_logical_not", ctx=ast.Load()),
                args=[node.operand], keywords=[])
        return node

    # -- statement rewrites -----------------------------------------------
    def visit_If(self, node):
        node.test = self.visit(node.test)
        if (_has_escape(node.body) or _has_escape(node.orelse)
                or _uses_global_nonlocal(node.body + node.orelse)):
            # unconvertible: leave as Python (concrete predicates still
            # work; tensor ones get the loud guidance error from jit)
            node.body = self._visit_block(node.body)
            node.orelse = self._visit_block(node.orelse)
            return node
        bound_before = list(self.bound)   # snapshot: names live BEFORE the
        body = self._visit_block(list(node.body))     # if, not branch-born
        orelse = self._visit_block(list(node.orelse))
        outs = _assigned(node.body + node.orelse)
        passed = [n for n in outs if n in bound_before]
        born = [n for n in outs if n not in bound_before]
        # branch-born names start as Undefined INSIDE each branch fn (never
        # as torch.cond operands): a branch that assigns returns the value, a
        # branch that doesn't returns the placeholder — concrete paths keep
        # Python semantics, traced asymmetry fails the cond structure check
        tname, fname = self._fresh("true"), self._fresh("false")
        tdef = _make_branch_fn(tname, passed,
                               [_undef_assign(n) for n in born] + body, outs)
        fdef = _make_branch_fn(fname, passed,
                               [_undef_assign(n) for n in born] + orelse,
                               outs)
        call = ast.Call(
            func=ast.Attribute(value=ast.Name(id=_RT, ctx=ast.Load()),
                               attr="convert_ifelse", ctx=ast.Load()),
            args=[node.test,
                  ast.Name(id=tname, ctx=ast.Load()),
                  ast.Name(id=fname, ctx=ast.Load()),
                  ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                                  for n in passed], ctx=ast.Load())],
            keywords=[])
        assign = _tuple_assign(outs, call)
        self._bind(outs)
        self.changed = True
        return [tdef, fdef, assign]

    def visit_While(self, node):
        node.test = self.visit(node.test)
        if (node.orelse or _has_escape(node.body)
                or _uses_global_nonlocal(node.body)):
            node.body = self._visit_block(node.body)
            node.orelse = self._visit_block(node.orelse)
            return node
        bound_before = list(self.bound)
        body = self._visit_block(list(node.body))
        carried = _assigned(node.body)
        if not carried:
            # nothing assigned: a tensor predicate would never progress;
            # leave as Python (concrete predicates work unchanged)
            node.body = body
            return node
        # loop-born names (first assigned in the body) start as Undefined
        # placeholders so they are carried and visible after the loop —
        # matching Python, where they exist iff an iteration ran
        pre = [_undef_assign(n) for n in carried if n not in bound_before]
        cname, bname = self._fresh("cond"), self._fresh("body")
        cdef = _make_branch_fn(cname, carried, [], [], ret_expr=node.test)
        bdef = _make_branch_fn(bname, carried, body, carried)
        call = ast.Call(
            func=ast.Attribute(value=ast.Name(id=_RT, ctx=ast.Load()),
                               attr="convert_while", ctx=ast.Load()),
            args=[ast.Name(id=cname, ctx=ast.Load()),
                  ast.Name(id=bname, ctx=ast.Load()),
                  ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                                  for n in carried], ctx=ast.Load())],
            keywords=[])
        assign = _tuple_assign(carried, call)
        self._bind(carried)
        self.changed = True
        return pre + [cdef, bdef, assign]

    def visit_FunctionDef_nested(self, node):
        return node


def _undef_assign(name: str):
    """``name = _RT.Undefined('name')`` — placeholder for a branch/loop-
    born local."""
    return ast.Assign(
        targets=[ast.Name(id=name, ctx=ast.Store())],
        value=ast.Call(
            func=ast.Attribute(value=ast.Name(id=_RT, ctx=ast.Load()),
                               attr="Undefined", ctx=ast.Load()),
            args=[ast.Constant(value=name)], keywords=[]))


def _empty_args():
    return ast.arguments(posonlyargs=[], args=[], vararg=None,
                         kwonlyargs=[], kw_defaults=[], kwarg=None,
                         defaults=[])


def _make_branch_fn(name: str, params: List[str], body: List[ast.stmt],
                    outs: List[str], ret_expr: Optional[ast.expr] = None):
    """def name(p1, ..., pN): BODY; return (o1, ..., oM)"""
    ret_val = (ret_expr if ret_expr is not None else
               ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                               for n in outs], ctx=ast.Load()))
    fn_body = list(body) + [ast.Return(value=ret_val)]
    args = ast.arguments(
        posonlyargs=[],
        args=[ast.arg(arg=p) for p in params],
        vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None, defaults=[])
    return ast.FunctionDef(name=name, args=args, body=fn_body,
                           decorator_list=[], returns=None,
                           type_params=[])


def _tuple_assign(names: List[str], value: ast.expr):
    # always a tuple target — the converters return tuples even for one var
    tgt = ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Store())
                          for n in names], ctx=ast.Store())
    return ast.Assign(targets=[tgt], value=value)


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def convert_to_static(fn: Callable) -> Callable:
    """Source-rewrite ``fn``'s control flow for jit tracing. Returns the
    transformed function, or ``fn`` unchanged when transformation is not
    possible (no source, closures, parse failure) — tracing then relies on
    the loud-error path for tensor predicates."""
    if getattr(fn, "_not_to_static", False):
        return fn
    inner = getattr(fn, "__func__", fn)       # unwrap bound methods
    if getattr(inner, "__closure__", None):
        return fn                             # cells can't be rebuilt
    try:
        src = textwrap.dedent(inspect.getsource(inner))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return fn
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn
    fdef.decorator_list = []                  # strip @to_static etc.
    tr = _ControlFlowTransformer()
    try:
        tr.visit_FunctionDef(fdef)
    except Exception:
        return fn
    if not tr.changed:
        return fn
    ast.fix_missing_locations(tree)
    import linecache
    import sys

    # the rewritten function runs in its module's own globals (a copy
    # would hide later rebinds from it, and the compiler resolves a
    # function's globals through its module), which gain the runtime alias
    glb = inner.__globals__
    glb[_RT] = sys.modules[__name__]
    ns: Dict[str, Any] = {}
    filename = f"<dy2static {inner.__name__}>"
    try:
        new_src = ast.unparse(tree)
        code = compile(tree, filename=filename, mode="exec")
        exec(code, glb, ns)
    except Exception:
        return fn
    new_fn = ns[fdef.name]
    functools.update_wrapper(new_fn, inner)
    new_fn.__wrapped_original__ = fn
    new_fn.__dy2static_source__ = new_src
    # tracebacks and inspect.getsource resolve through linecache
    linecache.cache[filename] = (
        len(new_src), None, [l + "\n" for l in new_src.splitlines()],
        filename)
    if hasattr(fn, "__self__"):               # rebind methods
        import types

        return types.MethodType(new_fn, fn.__self__)
    return new_fn
