"""Common parent for scene-description classes.

Behavioral parity with reference ``optrace/tracer/base_class.py:9-114``:
``desc``/``long_desc`` labels, attribute locking (read-only objects raise on
mutation), deep ``copy()``, and a compact state representation used for
change detection (the reference's ``crepr``).

In this package these objects are *host-side scene description only* — the
traced computation consumes pytrees produced from them, so locking doubles
as a guarantee that a compiled scene cannot drift from its description.
"""

import copy as _copy

import numpy as np

from .property_checker import PropertyChecker as pc


class BaseClass:

    def __init__(self, desc: str = "", long_desc: str = "") -> None:
        self._lock = False
        self._new_lock = False
        pc.check_type("desc", desc, str)
        pc.check_type("long_desc", long_desc, str)
        self.desc = desc
        self.long_desc = long_desc

    # ------------------------------------------------------------------
    def get_desc(self, fallback: str = "") -> str:
        """Short description, falling back to long description or a default."""
        if self.desc:
            return self.desc
        if self.long_desc:
            return self.long_desc
        return fallback if fallback else type(self).__name__

    def get_long_desc(self, fallback: str = "") -> str:
        if self.long_desc:
            return self.long_desc
        if self.desc:
            return self.desc
        return fallback if fallback else type(self).__name__

    # ------------------------------------------------------------------
    def copy(self) -> "BaseClass":
        """Deep copy that stays mutable (locks are preserved as-is)."""
        return _copy.deepcopy(self)

    def lock(self) -> None:
        """Make the object read-only (and forbid new attributes)."""
        object.__setattr__(self, "_lock", True)
        object.__setattr__(self, "_new_lock", True)

    def _unlock(self) -> None:
        object.__setattr__(self, "_lock", False)

    # ------------------------------------------------------------------
    def crepr(self):
        """Compact, hashable state representation for change detection.

        Mirrors the role of reference ``base_class.py:27-58``: scene change
        detection between traces / GUI replots. Arrays contribute
        (shape, bytes-hash); nested BaseClass objects recurse; callables
        contribute their id.
        """
        out = [type(self).__name__]
        for key in sorted(self.__dict__):
            if key.startswith("_lock") or key.startswith("_new_lock"):
                continue
            val = self.__dict__[key]
            out.append((key, self._crepr_value(val)))
        return tuple(out)

    @staticmethod
    def _crepr_value(val):
        if isinstance(val, BaseClass):
            return val.crepr()
        if isinstance(val, np.ndarray):
            return (val.shape, str(val.dtype), hash(val.tobytes()))
        if isinstance(val, (list, tuple)):
            return tuple(BaseClass._crepr_value(v) for v in val)
        if isinstance(val, dict):
            return tuple((k, BaseClass._crepr_value(v)) for k, v in sorted(val.items()))
        if callable(val):
            return ("callable", id(val))
        try:
            hash(val)
            return val
        except TypeError:
            return repr(val)

    # ------------------------------------------------------------------
    def __setattr__(self, key, val) -> None:
        lock = self.__dict__.get("_lock", False)
        new_lock = self.__dict__.get("_new_lock", False)
        if lock and not key.startswith("_"):
            raise RuntimeError(f"Object '{self.get_desc()}' is read-only (locked). "
                               f"Cannot set property '{key}'. Use copy() for a mutable version.")
        if new_lock and key not in self.__dict__ and not hasattr(type(self), key):
            raise AttributeError(f"Unknown property '{key}' for type {type(self).__name__}.")
        object.__setattr__(self, key, val)

    def __str__(self) -> str:
        return f"{type(self).__name__}('{self.get_desc()}') at {hex(id(self))}"

    def __repr__(self) -> str:
        return self.__str__()
