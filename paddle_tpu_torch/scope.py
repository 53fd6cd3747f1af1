"""Scope: hierarchical name -> value store (reference ``scope.h:39``).

Values are torch tensors on the executing place's device (host numpy
arrays are accepted and moved by the Executor).  Only block boundaries
touch the scope: feeds, fetches and persistable state; intermediates
live in the Executor's per-run environment.
"""

from __future__ import annotations

__all__ = ["Scope", "global_scope", "scope_guard"]

import contextlib


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
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

    def local_var_names(self):
        return list(self._vars)

    def items(self):
        return list(self._vars.items())


_global_scope = Scope()
_current_scope = _global_scope


def global_scope():
    return _current_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _current_scope
    prev, _current_scope = _current_scope, scope
    try:
        yield
    finally:
        _current_scope = prev
