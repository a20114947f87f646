"""Declarative, JSON-serializable predicate expressions.

Port of ``fenix_tpu/expr.py``: the tree, the JSON wire form, the Arrow
lowering and the host ``mask()`` are copied; the device half
(``device_evaluable``, ``split_literals``, ``fields``, ``device_mask``)
evaluates over torch tensors on the card, as the JAX package's does over
``jax.numpy`` arrays.

The reference ships filters as **pickled** ``pyarrow.compute.Expression``
objects (upstream fenix/flight.py:266, io/index/index.py:89) —
arbitrary code execution on both ends. This module replaces that with a
small expression tree that:

- serializes to/from plain JSON (safe on the wire),
- lowers to ``pyarrow.compute`` kernels for host-side evaluation,
- lowers to device ops for pushdown below the distance kernel
  (:meth:`Expr.device_mask`).

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
import torch

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

    # -- evaluation: device (torch) → bool mask ----------------------------

    def device_evaluable(self, schema: pa.Schema) -> bool:
        """Whether this predicate can be evaluated on the device with
        host-parity results (the JAX package's rule, copied).

        True when every op has a device lowering and every referenced
        column is bool / integer / float32 (float64 columns would round
        through the device's f32 and could flip boundary comparisons),
        and every numeric literal is exactly representable on the device
        (int32 range; f32-exact floats). ``/`` is excluded — true
        division runs in f64 on the host and f32 on the device. String
        predicates and ``is_null`` stay on the host path.
        """

        def lit_ok(v: Any) -> bool:
            if isinstance(v, bool):
                return True
            if isinstance(v, (int, np.integer)):
                return -(2**31) <= int(v) < 2**31
            if isinstance(v, (float, np.floating)):
                return float(np.float32(v)) == float(v)
            return False

        def ok(e: Any) -> bool:
            if not isinstance(e, Expr):
                return lit_ok(e)
            if e.op == "field":
                name = e.args[0]
                if name not in schema.names:
                    return False  # host path raises the proper error
                t = schema.field(name).type
                return pa.types.is_boolean(t) or pa.types.is_integer(t) or pa.types.is_float32(t)
            if e.op == "lit":
                return lit_ok(e.args[0])
            if e.op == "isin":
                return ok(e.args[0]) and all(lit_ok(v) for v in e.args[1])
            if e.op in _COMPARISONS or e.op in _BOOLEAN or e.op in ("+", "-", "*", "%", "abs"):
                return all(ok(a) for a in e.args)
            return False

        return ok(self)

    def split_literals(self) -> "tuple[Expr, list]":
        """Return ``(skeleton, literals)`` where numeric literals are
        replaced by ``slot`` placeholders (``np.int32`` / ``np.float32``
        values). The skeleton keys the memoized device evaluation, so
        requests differing only in literal values share it. ``isin``
        value sets stay inline. The literal's type is part of the
        skeleton (an int and a float slot promote differently)."""
        lits: list = []

        def walk(e: Any) -> Any:
            if not isinstance(e, Expr):
                return e
            if e.op == "lit":
                v = e.args[0]
                if isinstance(v, bool):
                    return e
                if isinstance(v, (int, np.integer)):
                    lits.append(np.int32(v))
                    return Expr("slot", (len(lits) - 1, "i"))
                if isinstance(v, (float, np.floating)):
                    lits.append(np.float32(v))
                    return Expr("slot", (len(lits) - 1, "f"))
                return e
            if e.op == "isin":
                return e
            return Expr(e.op, tuple(walk(a) for a in e.args))

        return walk(self), lits

    def fields(self) -> set[str]:
        """All column names referenced by this predicate."""
        out: set[str] = set()

        def walk(e: Any) -> None:
            if isinstance(e, Expr):
                if e.op == "field":
                    out.add(e.args[0])
                for a in e.args:
                    walk(a)

        walk(self)
        return out

    def device_mask(self, columns: Mapping[str, Any], slots: Sequence[Any] = ()) -> Any:
        """Evaluate over ``{name: torch.Tensor}`` device columns.

        The types follow the JAX package's device path: integer columns
        arrive as int32 (``session.DeviceCache.scalar``) and ``slots``
        (the values :meth:`split_literals` took out) as 0-dim int32 /
        float32 tensors, so an int column against a float literal
        compares in float32 and ``+ - *`` wrap in int32; ``%`` takes the
        divisor's sign (``torch.remainder``, Python's rule); ``isin`` is a
        broadcast equality against the values cast to the column's type.
        """
        return self._eval_device(columns, slots)

    def _eval_device(self, columns: Mapping[str, Any], slots: Sequence[Any] = ()) -> Any:
        def ev(a: Any) -> Any:
            if isinstance(a, Expr):
                return a._eval_device(columns, slots)
            return a

        if self.op == "field":
            return columns[self.args[0]]
        if self.op == "lit":
            return self.args[0]
        if self.op == "slot":
            return slots[self.args[0]]
        if self.op in _COMPARISONS:
            return _TORCH_COMPARE[self.op](*_tensor_first(ev(self.args[0]), ev(self.args[1])))
        if self.op == "and":
            return torch.logical_and(*_tensor_first(ev(self.args[0]), ev(self.args[1])))
        if self.op == "or":
            return torch.logical_or(*_tensor_first(ev(self.args[0]), ev(self.args[1])))
        if self.op == "not":
            return torch.logical_not(ev(self.args[0]))
        if self.op == "isin":
            col = ev(self.args[0])
            values = torch.tensor(self.args[1], dtype=col.dtype, device=col.device)
            return (col[:, None] == values[None, :]).any(dim=-1)
        if self.op == "abs":
            return torch.abs(ev(self.args[0]))
        if self.op in _TORCH_ARITH:
            return _TORCH_ARITH[self.op](*_tensor_first(ev(self.args[0]), ev(self.args[1])))
        raise ValueError(f"op {self.op} not supported on device")


_TORCH_COMPARE = {
    "==": torch.eq,
    "!=": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}
_TORCH_ARITH = {
    "+": torch.add,
    "-": torch.sub,
    "*": torch.mul,
    "/": torch.true_divide,
    "%": torch.remainder,
}


def _tensor_first(a: Any, b: Any) -> tuple[Any, Any]:
    """Operands of a binary op, a Python scalar in the first place made a
    0-dim CPU tensor (the torch functions take a Python scalar only as the
    second operand; a 0-dim CPU tensor mixes with tensors of any device
    and, being of the same kind, keeps the other operand's type)."""
    if isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        return a, b
    return torch.as_tensor(a), b


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
