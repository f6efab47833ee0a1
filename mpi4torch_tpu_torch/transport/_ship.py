"""Function shipping for the process transport.

Port of ``mpi4torch_tpu/transport/_ship.py`` (standard library only).
``run_ranks`` takes an arbitrary Python callable — usually a closure
defined inside a test or a matrix cell, capturing ``COMM_WORLD``,
modules, per-cell parameters.  Plain pickle refuses those (functions
pickle by module reference), so this module implements the minimal
by-VALUE fallback the transport needs:

* importable functions/classes still travel by reference (fast path —
  ``reducer_override`` returns ``NotImplemented``);
* non-referenceable functions (closures, locals, lambdas) travel as
  ``marshal``-ed code + defaults + closure cell values + the subset of
  their globals their code (recursively) names;
* modules travel by name and are re-imported in the worker.

This is deliberately NOT a general cloudpickle: both ends are the same
interpreter on the same checkout (the pool spawns workers with
``sys.executable``), so ``marshal`` bytecode compatibility holds by
construction, and anything the mini-pickler cannot ship raises loudly
at the parent instead of mysteriously in the child.
"""

from __future__ import annotations

import importlib
import io
import marshal
import pickle
import types
from typing import Any

__all__ = ["dumps", "loads"]


def _import_module(name: str):
    return importlib.import_module(name)


def _make_cell(value):
    cell = types.CellType()   # empty; filled to support self-reference
    cell.cell_contents = value
    return cell


def _make_function(code_bytes: bytes, name: str, defaults, kwdefaults,
                   closure_values, globals_items):
    code = marshal.loads(code_bytes)
    glb = {"__builtins__": __builtins__}
    glb.update(globals_items)
    closure = tuple(_make_cell(v) for v in closure_values) \
        if closure_values is not None else None
    fn = types.FunctionType(code, glb, name, defaults, closure)
    if kwdefaults:
        fn.__kwdefaults__ = dict(kwdefaults)
    return fn


def _referenceable(obj) -> bool:
    """Would plain pickle's by-reference lookup find this object?"""
    mod = getattr(obj, "__module__", None)
    qual = getattr(obj, "__qualname__", None)
    if mod is None or qual is None or "<locals>" in qual \
            or mod == "__main__":
        return False
    try:
        m = importlib.import_module(mod)
        found = m
        for part in qual.split("."):
            found = getattr(found, part)
        return found is obj
    except Exception:
        return False


def _code_names(code) -> set:
    """Every global name ``code`` (recursively through nested code
    objects — comprehensions, inner defs) might read."""
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _code_names(const)
    return names


class _ShipPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, types.ModuleType):
            return (_import_module, (obj.__name__,))
        if isinstance(obj, types.FunctionType):
            if _referenceable(obj):
                return NotImplemented     # plain by-reference pickling
            code = obj.__code__
            closure_values = None
            if obj.__closure__ is not None:
                closure_values = tuple(c.cell_contents
                                       for c in obj.__closure__)
            wanted = _code_names(code)
            globals_items = {k: v for k, v in obj.__globals__.items()
                             if k in wanted}
            return (_make_function,
                    (marshal.dumps(code), obj.__name__, obj.__defaults__,
                     obj.__kwdefaults__, closure_values, globals_items))
        return NotImplemented


def dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _ShipPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def loads(data: bytes) -> Any:
    return pickle.loads(data)
