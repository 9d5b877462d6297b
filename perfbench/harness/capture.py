"""Copies of what the timed path produces, and patches that are undone.

`Capture.wrap(in_key, out_key, fn)` gives fn back as a function that, while
`on` is set (for the calls the seed sampled), keeps detached copies of the
sampled rows of fn's first argument and of its result. `Patches` swaps
attributes of the program's modules and objects for such wrappers and puts
them back afterwards.
"""

import collections

import torch

COUNTERS = ("launches", "wgmma_launches")


class Capture:
    def __init__(self):
        self.on = False
        self.rows = None  # the sampled rows of the current call; None: all
        self.data = collections.defaultdict(list)

    def take(self, key, t):
        if self.on and key is not None:
            t = t.detach()
            self.data[key].append((t if self.rows is None else t[self.rows]).clone())

    def wrap(self, in_key, out_key, fn):
        def wrapped(*args, **kwargs):
            if self.on:
                self.take(in_key, args[0])
            out = fn(*args, **kwargs)
            self.take(out_key, out)
            return out

        return wrapped

    def cat(self) -> dict:
        return {k: torch.cat(v) for k, v in self.data.items()}


class Patches:
    def __init__(self):
        self._undo = []

    def set(self, obj, name, value):
        """obj.name = value, remembering what to put back (an instance attribute
        that shadowed nothing is deleted again)."""
        had = name in vars(obj) if hasattr(obj, "__dict__") else True
        self._undo.append((obj, name, had, getattr(obj, name) if had else None))
        setattr(obj, name, value)

    def wrap(self, obj, name, make):
        """obj.name = make(obj.name). A kernel wrapper's launch counters
        (`launches`, `wgmma_launches`, which it bumps through its own module
        name) move to the replacement and back."""
        old = getattr(obj, name)
        new = make(old)
        if new is not old:
            for attr in COUNTERS:
                if hasattr(old, attr):
                    setattr(new, attr, getattr(old, attr))
        self.set(obj, name, new)

    def item(self, d: dict, key, make):
        """d[key] = make(d[key])."""
        self._undo.append((d, key, None, d[key]))
        d[key] = make(d[key])

    def undo(self):
        while self._undo:
            obj, name, had, old = self._undo.pop()
            if isinstance(obj, dict):
                obj[name] = old
            elif had:
                for attr in COUNTERS:
                    if hasattr(old, attr) and hasattr(getattr(obj, name), attr):
                        setattr(old, attr, getattr(getattr(obj, name), attr))
                setattr(obj, name, old)
            else:
                delattr(obj, name)
