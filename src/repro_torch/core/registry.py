"""Policy registry: spec-driven construction and introspection.

The paper's evaluation sweeps (Figs. 9-13) run the same policies under many
configurations; benchmarks, the serving prefix cache and the data-pipeline
shard cache all need to construct those policies uniformly. This module
replaces the old ``make_policy`` if-chain with:

* :class:`PolicySpec` — a frozen ``(name, params)`` value with round-trippable
  spec-string parsing: ``"wtlfu-av-slru?window_frac=0.05&early_pruning=0"``
  parses to a spec and ``PolicySpec.parse(spec.to_string()) == spec``.
* :class:`PolicyRegistry` — maps spec names to policy classes. Policies
  self-register with the :func:`register_policy` class decorator; per-policy
  parameter schemas are derived from the constructor signature, so
  ``build`` can type-coerce spec-string params and reject unknown ones.
* Family names: W-TinyLFU registers once under ``"wtlfu"`` with an alias
  resolver mapping ``wtlfu-<admission>[-<eviction>]`` spellings onto
  constructor params, and a variant enumerator so benchmarks list the full
  admission x eviction product instead of hard-coding it.

``available_policies()`` returns the canonical paper policy names (the old
``POLICY_NAMES``); ``available_policies(expand=True)`` additionally expands
family variants (all 21 W-TinyLFU admission/eviction combinations).
"""

from __future__ import annotations

import dataclasses
import inspect
import urllib.parse
from typing import Any, Callable, Iterable, Mapping

__all__ = [
    "ParamSchema",
    "PolicySpec",
    "PolicyRegistry",
    "REGISTRY",
    "register_policy",
    "available_policies",
]

_MISSING = object()

_SCALAR_TYPES = {"int": int, "float": float, "bool": bool, "str": str}


def parse_scalar(text: str) -> Any:
    """Best-effort literal parse of a spec-string value (int, float, str).

    Ints accept the ``0x``/``0o``/``0b`` prefixes (seeds read naturally as
    hex: ``wtlfu-av-random?seed=0x5EED``); they normalize to plain ints, so
    ``to_string`` re-renders them in decimal and the *value* round-trips.
    """
    try:
        return int(text)
    except ValueError:
        pass
    if text.lstrip("+-")[:2].lower() in ("0x", "0o", "0b"):
        try:
            return int(text, 0)
        except ValueError:
            pass
    try:
        return float(text)
    except ValueError:
        pass
    return text


def _canon_scalar(value: Any) -> Any:
    """Spec-string canonical form of a param value: the fixed point of
    ``parse_scalar`` ∘ ``_format_scalar``.

    ``PolicySpec.make`` runs every param through this so that
    ``parse(to_string()) == spec`` holds for *every* accepted value, not
    just the ones whose repr happens to survive re-parsing:

    * numeric-looking strings (``"123"``, ``"1e3"``, ``"0x10"``, ``"+5"``)
      are indistinguishable from numbers once rendered into a spec string,
      so they canonicalize to the number ``parse_scalar`` would return
      (the schema re-coerces to ``str`` at build time when the policy's
      parameter is declared ``str``);
    * NaN floats canonicalize to the string ``"nan"`` — a NaN *value*
      breaks ``==`` by definition (even ``parse(s) == parse(s)`` would
      fail), while the string form round-trips and still coerces to the
      float at build time.
    """
    if isinstance(value, bool):
        return value  # renders as 1/0; bool == int keeps equality exact
    if isinstance(value, float) and value != value:  # NaN
        return "nan"
    if isinstance(value, str):
        parsed = parse_scalar(value)
        if isinstance(parsed, str):
            return parsed
        return _canon_scalar(parsed)  # numeric-looking: store the number
    return value


def _format_scalar(value: Any) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, float) and value != value:  # NaN: repr round-trips
        return "nan"  # only as a string (canonical form; see _canon_scalar)
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        return urllib.parse.quote(value, safe="")
    raise ValueError(
        f"spec params must be int/float/bool/str scalars, got {type(value).__name__}; "
        "pass rich objects (traces, sketch kwargs) as build(**kwargs) instead"
    )


@dataclasses.dataclass(frozen=True)
class ParamSchema:
    """One constructor parameter of a registered policy."""

    name: str
    kind: type | None  # int/float/bool/str when statically known, else None
    default: Any = _MISSING

    @property
    def required(self) -> bool:
        return self.default is _MISSING

    def coerce(self, value: Any) -> Any:
        """Coerce a (possibly spec-string-parsed) value to this param's type."""
        if value is None or self.kind is None or isinstance(value, self.kind):
            return value
        if self.kind is bool:
            if isinstance(value, int):
                return bool(value)
            if isinstance(value, str) and value.lower() in ("true", "false", "1", "0"):
                return value.lower() in ("true", "1")
            raise ValueError(f"param {self.name!r}: cannot coerce {value!r} to bool")
        if self.kind is float and isinstance(value, int):
            return float(value)
        if self.kind in (int, float) and isinstance(value, str):
            return self.kind(value)
        if self.kind is int and isinstance(value, float) and value.is_integer():
            return int(value)
        if self.kind is str:
            return str(value)
        raise ValueError(
            f"param {self.name!r}: cannot coerce {value!r} to {self.kind.__name__}"
        )


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """A policy name plus typed construction params (capacity excluded).

    ``params`` is a sorted tuple of ``(name, value)`` pairs so specs are
    hashable and order-insensitive: ``PolicySpec.make("lru", a=1, b=2) ==
    PolicySpec.make("lru", b=2, a=1)``. Scalar values are stored in
    spec-string canonical form (see :func:`_canon_scalar`), which is what
    makes ``PolicySpec.parse(spec.to_string()) == spec`` an identity for
    every value the schema accepts.
    """

    name: str
    params: tuple[tuple[str, Any], ...] = ()

    @classmethod
    def make(cls, name: str, **params: Any) -> "PolicySpec":
        return cls(
            name,
            tuple(sorted((k, _canon_scalar(v)) for k, v in params.items())),
        )

    @property
    def params_dict(self) -> dict[str, Any]:
        return dict(self.params)

    @classmethod
    def parse(cls, text: "str | PolicySpec") -> "PolicySpec":
        """Parse ``"name"`` or ``"name?k=v&k2=v2"`` into a spec.

        Values are literal-parsed (int, then float, then string); the
        registry's schema applies the policy's declared types at build time
        (e.g. ``early_pruning=0`` becomes ``False``).
        """
        if isinstance(text, PolicySpec):
            return text
        if not isinstance(text, str):
            raise TypeError(f"expected spec string or PolicySpec, got {type(text)!r}")
        name, sep, query = text.partition("?")
        name = name.strip().lower()
        if not name:
            raise ValueError(f"empty policy name in spec {text!r}")
        params: dict[str, Any] = {}
        if sep:
            if not query:
                raise ValueError(f"empty param list in spec {text!r}")
            for item in query.split("&"):
                key, eq, raw = item.partition("=")
                if not key or not eq:
                    raise ValueError(f"malformed param {item!r} in spec {text!r}")
                if key in params:
                    raise ValueError(f"duplicate param {key!r} in spec {text!r}")
                params[key] = parse_scalar(urllib.parse.unquote(raw))
        return cls.make(name, **params)

    def with_params(self, **overrides: Any) -> "PolicySpec":
        """A copy with ``overrides`` merged over the existing params — how
        the benchmark sweeps derive per-data-plane variants of one spec
        (``spec.with_params(data_plane="scalar")``)."""
        merged = self.params_dict
        merged.update(overrides)
        return PolicySpec.make(self.name, **merged)

    def to_string(self) -> str:
        """Render a spec string such that ``parse(to_string()) == self``."""
        if not self.params:
            return self.name
        query = "&".join(f"{k}={_format_scalar(v)}" for k, v in self.params)
        return f"{self.name}?{query}"

    def __str__(self) -> str:
        return self.to_string()


def _schema_from_init(cls: type) -> dict[str, ParamSchema]:
    """Derive the param schema from ``cls.__init__`` (skipping capacity)."""
    sig = inspect.signature(cls.__init__)
    schema: dict[str, ParamSchema] = {}
    params = list(sig.parameters.values())[1:]  # drop self
    if params and params[0].name == "capacity":
        params = params[1:]
    for p in params:
        if p.kind in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD):
            continue
        kind = None
        ann = p.annotation
        if isinstance(ann, str):  # `from __future__ import annotations`
            kind = _SCALAR_TYPES.get(ann.split("|")[0].strip())
        elif ann in (int, float, bool, str):
            kind = ann
        if kind is None and isinstance(p.default, (bool, int, float, str)):
            kind = type(p.default)
        default = _MISSING if p.default is inspect.Parameter.empty else p.default
        schema[p.name] = ParamSchema(p.name, kind, default)
    return schema


@dataclasses.dataclass(frozen=True)
class PolicyEntry:
    """A registered policy: class, derived schema, and family hooks."""

    name: str
    cls: type
    schema: Mapping[str, ParamSchema]
    # Family support: map an aliased spec name (e.g. "wtlfu-av-slru") to the
    # constructor params it implies, or None if the alias is not ours.
    alias_fn: Callable[[str], dict | None] | None = None
    # Canonical enumerable spec names (defaults to (name,)).
    variants: tuple[str, ...] = ()
    # Full variant expansion for sweeps (defaults to `variants`).
    expand_fn: Callable[[], tuple[str, ...]] | None = None

    def canonical_names(self) -> tuple[str, ...]:
        return self.variants or (self.name,)

    def expanded_names(self) -> tuple[str, ...]:
        return self.expand_fn() if self.expand_fn is not None else self.canonical_names()


class PolicyRegistry:
    """Name -> policy class registry with spec-driven construction."""

    def __init__(self):
        self._entries: dict[str, PolicyEntry] = {}

    # -- registration ------------------------------------------------------
    def register(
        self,
        name: str,
        cls: type | None = None,
        *,
        alias_fn: Callable[[str], dict | None] | None = None,
        variants: Iterable[str] = (),
        expand_fn: Callable[[], tuple[str, ...]] | None = None,
    ):
        """Register ``cls`` under ``name``; usable as a class decorator."""

        def _register(cls: type) -> type:
            if name in self._entries:
                raise ValueError(f"policy {name!r} already registered")
            self._entries[name] = PolicyEntry(
                name=name,
                cls=cls,
                schema=_schema_from_init(cls),
                alias_fn=alias_fn,
                variants=tuple(variants),
                expand_fn=expand_fn,
            )
            return cls

        return _register(cls) if cls is not None else _register

    # -- introspection -----------------------------------------------------
    def __contains__(self, name: str) -> bool:
        try:
            self.resolve(name)
            return True
        except KeyError:
            return False

    def entries(self) -> tuple[PolicyEntry, ...]:
        return tuple(self._entries.values())

    def available(self, *, expand: bool = False) -> tuple[str, ...]:
        """Enumerable spec names: canonical per-policy names, or the full
        family expansion (all W-TinyLFU admission x eviction combos)."""
        out: list[str] = []
        for entry in self._entries.values():
            out.extend(entry.expanded_names() if expand else entry.canonical_names())
        return tuple(out)

    def resolve(self, name: str) -> tuple[PolicyEntry, dict[str, Any]]:
        """Map a spec name to (entry, name-implied params)."""
        name = name.lower()
        entry = self._entries.get(name)
        if entry is not None:
            return entry, {}
        for entry in self._entries.values():
            if entry.alias_fn is not None:
                implied = entry.alias_fn(name)
                if implied is not None:
                    return entry, implied
        known = ", ".join(sorted(self._entries))
        raise KeyError(f"unknown policy {name!r} (registered: {known})")

    def schema(self, name: str) -> dict[str, ParamSchema]:
        """Constructor param schema for a spec name (capacity excluded)."""
        entry, _ = self.resolve(name)
        return dict(entry.schema)

    # -- construction ------------------------------------------------------
    def build(self, spec: "PolicySpec | str", capacity: int, **kwargs: Any):
        """Instantiate the policy named by ``spec`` with ``capacity`` bytes.

        Param precedence: name-implied (family suffix) < spec params <
        ``kwargs`` (call-site objects such as ``trace=`` for belady).
        Spec params are type-coerced per the schema; unknown or
        name-conflicting params raise ``ValueError``.
        """
        spec = PolicySpec.parse(spec)
        try:
            entry, implied = self.resolve(spec.name)
        except KeyError as e:
            raise ValueError(str(e)) from e
        merged = dict(implied)
        for key, value in spec.params:
            if key in implied:
                raise ValueError(
                    f"param {key!r} is already implied by the policy name "
                    f"{spec.name!r} (={implied[key]!r})"
                )
            merged[key] = value
        merged.update(kwargs)
        final: dict[str, Any] = {}
        for key, value in merged.items():
            schema = entry.schema.get(key)
            if schema is None:
                raise ValueError(
                    f"unknown param {key!r} for policy {spec.name!r} "
                    f"(accepts: {', '.join(sorted(entry.schema)) or 'none'})"
                )
            final[key] = schema.coerce(value)
        return entry.cls(capacity, **final)


#: Process-wide default registry; policy modules register into it on import.
REGISTRY = PolicyRegistry()


def register_policy(name: str, **kw):
    """Class decorator registering a policy into the default registry."""
    return REGISTRY.register(name, **kw)


def available_policies(*, expand: bool = False) -> tuple[str, ...]:
    """Spec names enumerable from the default registry (see
    :meth:`PolicyRegistry.available`)."""
    return REGISTRY.available(expand=expand)
