"""Minimal marshmallow-compatible validation fallback.

`server.schemas` prefers real marshmallow (reference parity). This module
implements the EXACT subset those schemas use — Str/Int/Bool/Float/Email/
List/Dict/Nested fields, Length/OneOf/Range validators, required /
load_default / partial / Meta.unknown=EXCLUDE semantics — so the control
plane keeps validating request bodies (and keeps returning the same 400s)
in environments where marshmallow is not installed. It is NOT a general
marshmallow replacement; anything outside that subset raises loudly.

Matched marshmallow behaviors relied on by the resources/tests:
- missing required field  -> {"field": ["Missing data for required field."]}
- load_default used when the key is absent (callables are called)
- a field whose load_default is None implicitly allows null payloads
- unknown keys are EXCLUDEd
- Schema(partial=True) demotes required fields (collaboration PATCH)
"""
from __future__ import annotations

import re
from typing import Any, Callable

EXCLUDE = "exclude"

_MISSING = object()


class ValidationError(Exception):
    def __init__(self, messages: Any):
        super().__init__(str(messages))
        self.messages = messages


class validate:  # noqa: N801 - namespace mirrors `marshmallow.validate`
    class Length:
        def __init__(self, min: int | None = None, max: int | None = None):
            self.min, self.max = min, max

        def __call__(self, value: Any) -> None:
            n = len(value)
            if self.min is not None and n < self.min:
                raise ValidationError(f"Shorter than minimum length {self.min}.")
            if self.max is not None and n > self.max:
                raise ValidationError(f"Longer than maximum length {self.max}.")

    class Range:
        def __init__(self, min: Any = None, max: Any = None):
            self.min, self.max = min, max

        def __call__(self, value: Any) -> None:
            if self.min is not None and value < self.min:
                raise ValidationError(
                    f"Must be greater than or equal to {self.min}."
                )
            if self.max is not None and value > self.max:
                raise ValidationError(
                    f"Must be less than or equal to {self.max}."
                )

    class OneOf:
        def __init__(self, choices: Any):
            self.choices = list(choices)

        def __call__(self, value: Any) -> None:
            if value not in self.choices:
                raise ValidationError(
                    f"Must be one of: {', '.join(map(str, self.choices))}."
                )


class Field:
    def __init__(
        self,
        required: bool = False,
        load_default: Any = _MISSING,
        validate: Callable[[Any], Any] | None = None,
    ):
        self.required = required
        self.load_default = load_default
        self.validators = [validate] if validate is not None else []
        # marshmallow: load_default=None implicitly sets allow_none=True
        self.allow_none = load_default is None

    def deserialize(self, value: Any) -> Any:
        if value is None:
            if self.allow_none:
                return None
            raise ValidationError("Field may not be null.")
        value = self._coerce(value)
        for v in self.validators:
            v(value)
        return value

    def _coerce(self, value: Any) -> Any:  # pragma: no cover - abstract
        return value


class Str(Field):
    def _coerce(self, value: Any) -> str:
        if not isinstance(value, str):
            raise ValidationError("Not a valid string.")
        return value


class Email(Str):
    _RE = re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$")

    def _coerce(self, value: Any) -> str:
        value = super()._coerce(value)
        if not self._RE.match(value):
            raise ValidationError("Not a valid email address.")
        return value


class Int(Field):
    def _coerce(self, value: Any) -> int:
        if isinstance(value, bool):
            raise ValidationError("Not a valid integer.")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str):
            try:
                return int(value)
            except ValueError:
                pass
        raise ValidationError("Not a valid integer.")


class Float(Field):
    def _coerce(self, value: Any) -> float:
        if isinstance(value, bool):
            raise ValidationError("Not a valid number.")
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                pass
        raise ValidationError("Not a valid number.")


class Bool(Field):
    _TRUTHY = {"true", "True", "1", "on", "yes"}
    _FALSY = {"false", "False", "0", "off", "no"}

    def _coerce(self, value: Any) -> bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        if isinstance(value, str):
            if value in self._TRUTHY:
                return True
            if value in self._FALSY:
                return False
        raise ValidationError("Not a valid boolean.")


class List(Field):
    def __init__(self, inner: Field, **kw: Any):
        super().__init__(**kw)
        self.inner = inner

    def _coerce(self, value: Any) -> list:
        if not isinstance(value, list):
            raise ValidationError("Not a valid list.")
        return [self.inner.deserialize(v) for v in value]


class Dict(Field):
    def __init__(self, keys: Field | None = None, values: Field | None = None,
                 **kw: Any):
        super().__init__(**kw)
        self.keys, self.values = keys, values

    def _coerce(self, value: Any) -> dict:
        if not isinstance(value, dict):
            raise ValidationError("Not a valid mapping type.")
        out = {}
        for k, v in value.items():
            if self.keys is not None:
                k = self.keys.deserialize(k)
            if self.values is not None:
                v = self.values.deserialize(v)
            out[k] = v
        return out


class Nested(Field):
    def __init__(self, nested: Any, **kw: Any):
        super().__init__(**kw)
        self.nested = nested

    def _coerce(self, value: Any) -> Any:
        schema = self.nested() if isinstance(self.nested, type) else self.nested
        return schema.load(value)


class fields:  # noqa: N801 - namespace mirrors `marshmallow.fields`
    Str = Str
    Int = Int
    Bool = Bool
    Float = Float
    Email = Email
    List = List
    Dict = Dict
    Nested = Nested


class Schema:
    class Meta:
        unknown = EXCLUDE

    def __init__(self, partial: bool = False):
        self.partial = partial

    @classmethod
    def _declared_fields(cls) -> dict[str, Field]:
        out: dict[str, Field] = {}
        for klass in reversed(cls.__mro__):
            for name, value in vars(klass).items():
                if isinstance(value, Field):
                    out[name] = value
        return out

    def load(self, data: Any) -> dict[str, Any]:
        if not isinstance(data, dict):
            raise ValidationError({"_schema": ["Invalid input type."]})
        errors: dict[str, list[str]] = {}
        out: dict[str, Any] = {}
        for name, field in self._declared_fields().items():
            if name in data:
                try:
                    out[name] = field.deserialize(data[name])
                except ValidationError as e:
                    msgs = e.messages
                    errors[name] = msgs if isinstance(msgs, list) else [msgs]
            elif field.required and not self.partial:
                errors[name] = ["Missing data for required field."]
            elif field.load_default is not _MISSING:
                d = field.load_default
                out[name] = d() if callable(d) else d
        if errors:
            raise ValidationError(errors)
        return out
