"""Scope: hierarchical name -> value store (reference ``scope.h:39``).

Values are torch tensors on the executing place's device (host numpy
arrays are accepted and moved by the Executor).  Only block boundaries
touch the scope: feeds, fetches and persistable state; intermediates
live in the Executor's per-run environment.  A ragged feed's LoD (row
splits, host metadata) is kept beside its value (``set_lod`` /
``find_lod``).
"""

from __future__ import annotations

__all__ = ["Scope", "global_scope", "scope_guard"]

import contextlib
import threading


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self._lod = {}
        self.parent = parent
        self.kids = []

    def new_scope(self):
        kid = Scope(parent=self)
        self.kids.append(kid)
        return kid

    def var(self, name):
        """Find-or-create (reference Scope::Var)."""
        s = self.find_scope(name)
        if s is not None:
            return s._vars[name]
        self._vars[name] = None
        return None

    def find_scope(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return s
            s = s.parent
        return None

    def find_var(self, name):
        s = self.find_scope(name)
        return None if s is None else s._vars[name]

    def has_var(self, name):
        return self.find_scope(name) is not None

    def set_var(self, name, value):
        s = self.find_scope(name)
        (s or self)._vars[name] = value

    def erase(self, names):
        for n in names:
            self._vars.pop(n, None)
            self._lod.pop(n, None)

    def local_var_names(self):
        return list(self._vars)

    def items(self):
        return list(self._vars.items())

    # -- LoD metadata ------------------------------------------------------
    def set_lod(self, name, lod):
        """Store ``name``'s LoD here; ``None`` clears it here and in every
        parent scope (a dense feed drops a stale ragged one)."""
        if lod is None:
            s = self
            while s is not None:
                s._lod.pop(name, None)
                s = s.parent
        else:
            self._lod[name] = lod

    def find_lod(self, name):
        """``name``'s LoD from this scope or the nearest parent, else
        None."""
        s = self
        while s is not None:
            if name in s._lod:
                return s._lod[name]
            s = s.parent
        return None


_global_scope = Scope()
_current_scope = _global_scope
# the scopes each thread has entered: a thread inside a ``scope_guard``
# reads its own guard's scope, whatever another thread enters meanwhile
# (in-process serving replicas each run their predictor's programs under
# a guard of its own scope, from their own threads); a thread inside no
# guard reads the process-wide current scope, as before
_guards = threading.local()


def global_scope():
    stack = getattr(_guards, "stack", None)
    return stack[-1] if stack else _current_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _current_scope
    stack = getattr(_guards, "stack", None)
    if stack is None:
        stack = _guards.stack = []
    stack.append(scope)
    prev, _current_scope = _current_scope, scope
    try:
        yield
    finally:
        _current_scope = prev
        stack.pop()
