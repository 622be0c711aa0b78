"""Typed parameter system.

PyTorch port: a copy of ``alink_tpu/common/params.py``
(numpy only; the port keeps its own copy so that it never imports the
JAX package).

TPU-native re-design of the reference's params stack:
  - ``Params``      <- org/apache/flink/ml/api/misc/param/Params.java:19-90
                       (a JSON-serializable string->value map with typed access)
  - ``ParamInfo``   <- ParamInfo/ParamInfoFactory (name, description, optional,
                       default, aliases, validator)
  - ``WithParams``  <- WithParams + the 433 ``Has*`` mixin interfaces
                       (e.g. params/shared/iter/HasMaxIterDefaultAs100.java:11-26).

Design notes (not a port):
  - ``Has*`` mixins are plain Python classes holding ``ParamInfo`` class
    attributes; a metaclass scans the MRO and generates fluent
    ``set_<name>/get_<name>`` methods (both snake_case and camelCase
    spellings are accepted as aliases, mirroring the reference's alias
    machinery).
  - Values are stored as plain Python objects and serialized with json;
    the reference stores JSON strings per key (Params.java:19-33) which we
    keep only at the (de)serialization boundary.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Dict, Iterable, Optional, Sequence


def _snake(name: str) -> str:
    s = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    s = re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s)
    return s.lower()


def _camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


class ParamValidator:
    """Validator contract (reference: params/validators/ParamValidator)."""

    def validate(self, value) -> bool:  # pragma: no cover - interface
        return True

    def describe(self) -> str:
        return ""


class RangeValidator(ParamValidator):
    """Closed/open range check (reference: params/validators/RangeValidator.java)."""

    def __init__(self, min_val=None, max_val=None, left_inclusive=True, right_inclusive=True):
        self.min_val, self.max_val = min_val, max_val
        self.left_inclusive, self.right_inclusive = left_inclusive, right_inclusive

    def validate(self, value) -> bool:
        if value is None:
            return True
        if self.min_val is not None:
            if self.left_inclusive and value < self.min_val:
                return False
            if not self.left_inclusive and value <= self.min_val:
                return False
        if self.max_val is not None:
            if self.right_inclusive and value > self.max_val:
                return False
            if not self.right_inclusive and value >= self.max_val:
                return False
        return True

    def describe(self) -> str:
        lo = "[" if self.left_inclusive else "("
        hi = "]" if self.right_inclusive else ")"
        return f"{lo}{self.min_val}, {self.max_val}{hi}"


class InValidator(ParamValidator):
    def __init__(self, allowed: Sequence[Any]):
        self.allowed = list(allowed)

    def validate(self, value) -> bool:
        return value is None or value in self.allowed

    def describe(self) -> str:
        return f"in {self.allowed}"


class MinValidator(RangeValidator):
    def __init__(self, min_val, inclusive=True):
        super().__init__(min_val=min_val, left_inclusive=inclusive)


class ParamInfo:
    """Descriptor for one typed parameter (reference ParamInfoFactory)."""

    __slots__ = ("name", "type", "description", "optional", "has_default",
                 "default", "aliases", "validator")

    def __init__(self, name: str, type_: type = object, description: str = "",
                 optional: bool = True, has_default: bool = False, default: Any = None,
                 aliases: Sequence[str] = (), validator: Optional[ParamValidator] = None):
        self.name = _snake(name)
        self.type = type_
        self.description = description
        self.optional = optional
        # mirror ParamInfoFactory: setting a default implies having one
        self.has_default = has_default or default is not None
        self.default = default
        base_aliases = {self.name, _camel(self.name), name}
        base_aliases.update(aliases)
        base_aliases.update(_camel(a) if "_" in a else _snake(a) for a in tuple(aliases))
        self.aliases = tuple(sorted(base_aliases))
        self.validator = validator

    def __repr__(self):
        return f"ParamInfo({self.name!r}, {getattr(self.type, '__name__', self.type)})"

    def check(self, value):
        if self.validator is not None and not self.validator.validate(value):
            raise ValueError(
                f"param {self.name}={value!r} fails validation {self.validator.describe()}")
        return value


class Params:
    """JSON-round-trippable parameter map with typed access.

    Mirrors the observable behavior of the reference ``Params``
    (get with default fallback / required-missing error, contains, remove,
    merge, clone, to/from json) without its string-per-key storage.
    """

    def __init__(self, init: Optional[Dict[str, Any]] = None):
        self._m: Dict[str, Any] = {}
        if init:
            for k, v in init.items():
                self._m[_snake(k)] = v

    # -- primitive access ------------------------------------------------
    def set(self, info, value) -> "Params":
        if isinstance(info, ParamInfo):
            info.check(value)
            self._m[info.name] = value
        else:
            self._m[_snake(str(info))] = value
        return self

    def get(self, info: "ParamInfo"):
        for a in info.aliases:
            key = _snake(a)
            if key in self._m:
                return self._m[key]
        if info.has_default:
            return info.default
        if info.optional:
            return None
        raise KeyError(f"required param '{info.name}' is not set and has no default")

    def contains(self, info) -> bool:
        if isinstance(info, ParamInfo):
            return any(_snake(a) in self._m for a in info.aliases)
        return _snake(str(info)) in self._m

    def remove(self, info) -> "Params":
        if isinstance(info, ParamInfo):
            for a in info.aliases:
                self._m.pop(_snake(a), None)
        else:
            self._m.pop(_snake(str(info)), None)
        return self

    def merge(self, other: Optional["Params"]) -> "Params":
        if other is not None:
            self._m.update(other._m)
        return self

    def clone(self) -> "Params":
        p = Params()
        p._m = dict(self._m)
        return p

    def keys(self):
        return self._m.keys()

    def items(self):
        return self._m.items()

    def size(self) -> int:
        return len(self._m)

    def is_empty(self) -> bool:
        return not self._m

    def clear(self):
        self._m.clear()

    # -- serialization ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(self._m, sort_keys=True, default=_json_default)

    @staticmethod
    def from_json(s: str) -> "Params":
        return Params(json.loads(s) if s else {})

    def __eq__(self, other):
        return isinstance(other, Params) and self._m == other._m

    def __repr__(self):
        return f"Params({self._m})"


def _json_default(o):
    try:
        import numpy as np
        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except ImportError:  # pragma: no cover
        pass
    return str(o)


class _WithParamsMeta(type):
    """Generates fluent setters/getters for every ParamInfo found in the MRO."""

    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        infos = {}
        # inherit param maps assigned post-hoc on bases (the _trainer /
        # `_PARAM_INFOS = SomeBatchOp._PARAM_INFOS` delegation patterns)
        for klass in reversed(cls.__mro__[1:]):
            base_infos = klass.__dict__.get("_PARAM_INFOS")
            if isinstance(base_infos, dict):
                infos.update(base_infos)
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, ParamInfo):
                    infos[v.name] = v
        declared = ns.get("_PARAM_INFOS")
        if isinstance(declared, dict):
            infos.update(declared)
        cls._PARAM_INFOS = infos
        for pname, info in infos.items():
            setter = f"set_{pname}"
            getter = f"get_{pname}"
            # regenerate inherited accessors so a subclass overriding a
            # ParamInfo (the Has*DefaultAsN pattern) binds its own info;
            # hand-written methods (no _param_info tag) always win.
            for attr, make in ((setter, mcls._make_setter), (getter, mcls._make_getter)):
                if attr in ns:
                    continue
                existing = getattr(cls, attr, None)
                existing_info = getattr(existing, "_param_info", None)
                if existing is None or (existing_info is not None
                                        and existing_info is not info):
                    setattr(cls, attr, make(info))
        return cls

    @staticmethod
    def _make_setter(info):
        def _set(self, value):
            self.params.set(info, value)
            return self
        _set.__name__ = f"set_{info.name}"
        _set.__doc__ = info.description
        _set._param_info = info
        return _set

    @staticmethod
    def _make_getter(info):
        def _get(self):
            return self.params.get(info)
        _get.__name__ = f"get_{info.name}"
        _get.__doc__ = info.description
        _get._param_info = info
        return _get


class WithParams(metaclass=_WithParamsMeta):
    """Base for anything carrying a Params bag with fluent accessors."""

    def __init__(self, params: Optional[Params] = None, **kwargs):
        self.params = params.clone() if params is not None else Params()
        unknown = []
        for k, v in kwargs.items():
            key = _snake(k)
            info = self._PARAM_INFOS.get(key)
            if info is not None:
                self.params.set(info, v)
            else:
                # accept aliases of any declared info
                for cand in self._PARAM_INFOS.values():
                    if key in (_snake(a) for a in cand.aliases):
                        self.params.set(cand, v)
                        break
                else:
                    unknown.append(k)
        if unknown:
            raise TypeError(f"{type(self).__name__}: unknown params {unknown}; "
                            f"known: {sorted(self._PARAM_INFOS)}")

    @classmethod
    def param_infos(cls) -> Dict[str, ParamInfo]:
        return dict(cls._PARAM_INFOS)

    def get_params(self) -> Params:
        return self.params
