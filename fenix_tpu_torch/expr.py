"""Declarative, JSON-serializable predicate expressions.

Port of ``fenix_tpu/expr.py`` (its host half, copied: the tree, the JSON
wire form, the Arrow lowering and the host ``mask()``). Device-side
evaluation is not ported yet: filters on the exact-search path take the
host mask, which the executor folds into ``aux_add`` on the device.

The reference ships filters as **pickled** ``pyarrow.compute.Expression``
objects (upstream fenix/flight.py:266, io/index/index.py:89) —
arbitrary code execution on both ends. This module replaces that with a
small expression tree that:

- serializes to/from plain JSON (safe on the wire),
- lowers to ``pyarrow.compute`` kernels for host-side evaluation,
- (in ``fenix_tpu``) lowers to device ops for pushdown below the
  distance kernel; here :meth:`Expr.device_mask` raises.

Usage::

    from fenix_tpu_torch import expr
    f = (expr.field("id") < 100) & expr.field("tag").isin([1, 2, 3])
    f.to_json()                    # wire form
    f.mask(table)                  # numpy bool mask (host, Arrow kernels)
"""

from __future__ import annotations

import json
from typing import Any, Mapping, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

_COMPARISONS = {"==", "!=", "<", "<=", ">", ">="}
_BOOLEAN = {"and", "or", "not"}
_PC_COMPARE = {
    "==": pc.equal,
    "!=": pc.not_equal,
    "<": pc.less,
    "<=": pc.less_equal,
    ">": pc.greater,
    ">=": pc.greater_equal,
}
# arithmetic over columns (reference users had full pc.Expression
# algebra via pickle; these cover the common numeric predicates like
# (a - b).abs() < eps or a % 10 == 3)
_PC_ARITH = {
    "+": pc.add,
    "-": pc.subtract,
    "*": pc.multiply,
    "abs": pc.abs,
}
# "/" and "%" are handled per lowering path: "/" is TRUE division
# everywhere (pc.divide would integer-divide int columns and raise on
# zero, diverging from device division), "%" is Python-mod.
# string predicates (host/Arrow only — string columns are not
# device-resident; the executor pushes filters from the HOST mask)
_PC_STRING = {
    "contains": pc.match_substring,
    "starts_with": pc.starts_with,
    "ends_with": pc.ends_with,
}


class Expr:
    """Immutable predicate node. Build with :func:`field` and :func:`lit`."""

    def __init__(self, op: str, args: tuple[Any, ...]) -> None:
        self.op = op
        self.args = args

    # -- construction -----------------------------------------------------

    def _binop(self, op: str, other: Any) -> "Expr":
        return Expr(op, (self, _wrap(other)))

    def __eq__(self, other: Any) -> "Expr":  # type: ignore[override]
        return self._binop("==", other)

    def __ne__(self, other: Any) -> "Expr":  # type: ignore[override]
        return self._binop("!=", other)

    def __lt__(self, other: Any) -> "Expr":
        return self._binop("<", other)

    def __le__(self, other: Any) -> "Expr":
        return self._binop("<=", other)

    def __gt__(self, other: Any) -> "Expr":
        return self._binop(">", other)

    def __ge__(self, other: Any) -> "Expr":
        return self._binop(">=", other)

    def __and__(self, other: "Expr") -> "Expr":
        return Expr("and", (self, other))

    def __or__(self, other: "Expr") -> "Expr":
        return Expr("or", (self, other))

    def __invert__(self) -> "Expr":
        return Expr("not", (self,))

    def isin(self, values: Sequence[Any]) -> "Expr":
        return Expr("isin", (self, list(values)))

    def is_null(self) -> "Expr":
        return Expr("is_null", (self,))

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, other: Any) -> "Expr":
        return self._binop("+", other)

    def __radd__(self, other: Any) -> "Expr":
        return _wrap(other)._binop("+", self)

    def __sub__(self, other: Any) -> "Expr":
        return self._binop("-", other)

    def __rsub__(self, other: Any) -> "Expr":
        return _wrap(other)._binop("-", self)

    def __mul__(self, other: Any) -> "Expr":
        return self._binop("*", other)

    def __rmul__(self, other: Any) -> "Expr":
        return _wrap(other)._binop("*", self)

    def __truediv__(self, other: Any) -> "Expr":
        return self._binop("/", other)

    def __rtruediv__(self, other: Any) -> "Expr":
        return _wrap(other)._binop("/", self)

    def __mod__(self, other: Any) -> "Expr":
        return self._binop("%", other)

    def __rmod__(self, other: Any) -> "Expr":
        return _wrap(other)._binop("%", self)

    def abs(self) -> "Expr":
        return Expr("abs", (self,))

    def between(self, low: Any, high: Any) -> "Expr":
        """Inclusive range: ``low <= self <= high``."""
        return (self >= low) & (self <= high)

    # -- string predicates (host-evaluated) ----------------------------------

    def contains(self, pattern: str) -> "Expr":
        return Expr("contains", (self, pattern))

    def starts_with(self, prefix: str) -> "Expr":
        return Expr("starts_with", (self, prefix))

    def ends_with(self, suffix: str) -> "Expr":
        return Expr("ends_with", (self, suffix))

    def __hash__(self) -> int:
        return hash(self.to_json())

    def __repr__(self) -> str:
        return f"Expr({self.to_dict()!r})"

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        def enc(a: Any) -> Any:
            if isinstance(a, Expr):
                return a.to_dict()
            if isinstance(a, (list, tuple)):
                return [enc(x) for x in a]
            if isinstance(a, (np.integer,)):
                return int(a)
            if isinstance(a, (np.floating,)):
                return float(a)
            return a

        return {"op": self.op, "args": [enc(a) for a in self.args]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), separators=(",", ":"))

    @staticmethod
    def from_dict(obj: Mapping[str, Any]) -> "Expr":
        def dec(a: Any) -> Any:
            if isinstance(a, Mapping) and "op" in a and "args" in a:
                return Expr.from_dict(a)
            return a

        op = obj["op"]
        args = tuple(dec(a) for a in obj["args"])
        return Expr(op, args)

    @staticmethod
    def from_json(text: str) -> "Expr":
        return Expr.from_dict(json.loads(text))

    # -- lowering: pyarrow.compute Expression (for dataset-style filter) --

    def to_arrow(self) -> pc.Expression:
        def low(a: Any) -> Any:
            if isinstance(a, Expr):
                return a.to_arrow()
            return a

        if self.op == "field":
            return pc.field(self.args[0])
        if self.op == "lit":
            return pc.scalar(self.args[0])
        if self.op in _COMPARISONS:
            lhs, rhs = (low(a) for a in self.args)
            return {
                "==": lambda a, b: a == b,
                "!=": lambda a, b: a != b,
                "<": lambda a, b: a < b,
                "<=": lambda a, b: a <= b,
                ">": lambda a, b: a > b,
                ">=": lambda a, b: a >= b,
            }[self.op](lhs, rhs)
        if self.op == "and":
            return low(self.args[0]) & low(self.args[1])
        if self.op == "or":
            return low(self.args[0]) | low(self.args[1])
        if self.op == "not":
            return ~low(self.args[0])
        if self.op == "isin":
            return low(self.args[0]).isin(self.args[1])
        if self.op == "is_null":
            return low(self.args[0]).is_null()
        if self.op in _PC_ARITH:
            return _PC_ARITH[self.op](*(low(a) for a in self.args))
        if self.op == "/":
            lhs, rhs = (low(a) for a in self.args)
            return pc.divide(lhs.cast(pa.float64()), rhs.cast(pa.float64()))
        if self.op == "%":
            raise NotImplementedError(
                "modulo has no pyarrow Expression lowering; evaluate via mask()"
            )
        if self.op in _PC_STRING:
            return _PC_STRING[self.op](low(self.args[0]), self.args[1])
        raise ValueError(f"unknown op: {self.op}")

    # -- evaluation: host (Arrow C++ kernels) → numpy bool mask -----------

    def mask(self, table: pa.Table) -> np.ndarray:
        """Evaluate to a row mask with Arrow compute kernels.

        Produces a mask (not a filtered table) so device-resident columns
        stay row-aligned with the host table — the mask is what gets
        pushed below the distance kernel.
        """
        out = self._eval_host(table)
        if isinstance(out, (pa.Array, pa.ChunkedArray)):
            if isinstance(out, pa.ChunkedArray):
                out = out.combine_chunks()
            return out.to_numpy(zero_copy_only=False).astype(bool)
        raise TypeError(f"predicate did not evaluate to an array: {type(out)}")

    def _eval_host(self, table: pa.Table) -> Any:
        def ev(a: Any) -> Any:
            if isinstance(a, Expr):
                return a._eval_host(table)
            return a

        if self.op == "field":
            return table.column(self.args[0])
        if self.op == "lit":
            return pa.scalar(self.args[0])
        if self.op in _COMPARISONS:
            return _PC_COMPARE[self.op](ev(self.args[0]), ev(self.args[1]))
        if self.op == "and":
            return pc.and_kleene(ev(self.args[0]), ev(self.args[1]))
        if self.op == "or":
            return pc.or_kleene(ev(self.args[0]), ev(self.args[1]))
        if self.op == "not":
            return pc.invert(ev(self.args[0]))
        if self.op == "isin":
            return pc.is_in(ev(self.args[0]), value_set=pa.array(self.args[1]))
        if self.op == "is_null":
            return pc.is_null(ev(self.args[0]))
        if self.op in _PC_ARITH:
            return _PC_ARITH[self.op](*(ev(a) for a in self.args))
        if self.op == "/":
            lhs, rhs = (ev(a) for a in self.args)
            return pc.divide(
                pc.cast(lhs, pa.float64()), pc.cast(rhs, pa.float64())
            )
        if self.op == "%":
            # Python-mod semantics (matches the device modulo); Arrow
            # has no modulo kernel
            def as_np(x: Any) -> Any:
                if isinstance(x, pa.ChunkedArray):
                    x = x.combine_chunks()
                if isinstance(x, pa.Array):
                    return x.to_numpy(zero_copy_only=False)
                if isinstance(x, pa.Scalar):
                    return x.as_py()
                return x

            a, b = (as_np(ev(arg)) for arg in self.args)
            return pa.array(np.mod(a, b))
        if self.op in _PC_STRING:
            return _PC_STRING[self.op](ev(self.args[0]), self.args[1])
        raise ValueError(f"unknown op: {self.op}")

    # -- evaluation: device ------------------------------------------------

    def device_mask(self, columns: Mapping[str, Any], slots: Sequence[Any] = ()) -> Any:
        raise NotImplementedError(
            "device-side filter evaluation (ROADMAP queue 1: device-side expr); "
            "use mask() on the host table"
        )


def field(name: str) -> Expr:
    return Expr("field", (name,))


def lit(value: Any) -> Expr:
    return Expr("lit", (value,))


def _wrap(value: Any) -> Expr:
    return value if isinstance(value, Expr) else lit(value)


def dumps(expression: Expr | None) -> str | None:
    return None if expression is None else expression.to_json()


def loads(text: str | None) -> Expr | None:
    return None if text is None else Expr.from_json(text)
