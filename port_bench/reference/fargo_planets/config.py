"""YAML configuration with typed, unit-aware getters.

Re-creates the behavior of the reference config layer (src/config.h:16-78,
src/config.cpp): case-insensitive keys, typed ``get`` with defaults,
physical-unit conversion on dimensioned values ("1 au", "0.334 solMass"),
boolean flag parsing, visited/unknown-key tracking with a hard error on
unknown keys (typo protection, src/main.cpp:110), and the per-planet nbody
config list.
"""

from __future__ import annotations

from typing import Any

from . import units as u


_TRUE_WORDS = {"yes", "y", "true", "t", "on", "1"}
_FALSE_WORDS = {"no", "n", "false", "f", "off", "0"}


def parse_flag(value) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)):
        return bool(value)
    s = str(value).strip().lower()
    if s in _TRUE_WORDS:
        return True
    if s in _FALSE_WORDS:
        return False
    raise ValueError(f"cannot interpret {value!r} as a boolean flag")


class Config:
    """Case-insensitive view over a YAML mapping with typed getters."""

    def __init__(self, data: dict | None = None, units: u.Units | None = None):
        self._raw: dict[str, Any] = {}
        self._orig_case: dict[str, str] = {}
        self._visited: set[str] = set()
        # key -> value-or-default actually used, for WriteDefaultValues
        # (reference src/config.cpp write_default)
        self._consulted: dict[str, Any] = {}
        self._children: list[tuple[str, "Config"]] = []
        self.units = units or u.Units()
        if data:
            for k, v in data.items():
                kl = str(k).lower()
                self._raw[kl] = v
                self._orig_case[kl] = str(k)

    # -- construction -------------------------------------------------------


    @classmethod
    def from_dict(cls, data: dict) -> "Config":
        return cls(dict(data))

    def set_units(self, units: u.Units):
        self.units = units

    # -- basic access --------------------------------------------------------
    def contains(self, key: str) -> bool:
        return key.lower() in self._raw

    __contains__ = contains

    def _fetch(self, key: str):
        kl = key.lower()
        self._visited.add(kl)
        return self._raw[kl]

    def get(self, key: str, default=None, *, dim: u.Dim | None = None,
            type: type | None = None):
        """Typed getter with optional unit conversion.

        If ``dim`` is given and the stored (or default) value is a string
        carrying a unit, it is converted to code units of that dimension.
        Bare numbers pass through unchanged (they are already in code units).
        """
        if self.contains(key):
            val = self._fetch(key)
        else:
            val = default
        self._consulted.setdefault(key, val)
        if val is None:
            return None
        return _coerce(val, default, dim, type, self.units)

    def get_flag(self, key: str, default=False) -> bool:
        if self.contains(key):
            out = parse_flag(self._fetch(key))
        elif isinstance(default, str):
            out = parse_flag(default)
        else:
            out = bool(default)
        self._consulted.setdefault(key, "yes" if out else "no")
        return out

    def get_lowercase(self, key: str, default: str = "") -> str:
        if self.contains(key):
            out = str(self._fetch(key)).strip().lower()
        else:
            out = str(default).strip().lower()
        self._consulted.setdefault(key, out)
        return out

    def get_raw(self, key: str, default=None):
        if self.contains(key):
            return self._fetch(key)
        return default

    def get_list(self, key: str) -> list:
        if self.contains(key):
            val = self._fetch(key)
            if isinstance(val, list):
                return val
            raise ValueError(f"config key {key!r} is not a list")
        return []

    def get_subconfigs(self, key: str) -> list["Config"]:
        """List of sub-mappings (e.g. the 'nbody' planet list); the
        children participate in unknown-key checking."""
        subs = [Config(d, units=self.units) for d in self.get_list(key)]
        self._children.extend((f"{key}[{i}]", c) for i, c in enumerate(subs))
        return subs

    def consulted_values(self) -> dict:
        """Every key the run consulted mapped to the value (or default)
        it actually used — the WriteDefaultValues dump."""
        return dict(sorted(self._consulted.items()))

    # -- key bookkeeping ------------------------------------------------------
    def unknown_keys(self) -> list[str]:
        return [self._orig_case[k] for k in sorted(self._raw)
                if k not in self._visited]

    def exit_on_unknown_key(self):
        unknown = self.unknown_keys()
        for name, child in self._children:
            unknown += [f"{name}.{k}" for k in child.unknown_keys()]
        if unknown:
            raise KeyError(
                "Unknown config keys (possible typos): " + ", ".join(unknown))

    def keys(self):
        return [self._orig_case[k] for k in self._raw]


def _coerce(val, default, dim, typ, units: u.Units):
    # explicit type requested
    if typ is bool:
        return parse_flag(val)
    if typ is str:
        return str(val)
    if isinstance(val, str) and dim is not None:
        num, unit = u.split_value_unit(val)
        if unit:
            code = units.convert_to_code(num, unit, dim)
        else:
            code = num
        return _cast_like(code, default, typ)
    if isinstance(val, str):
        # numeric strings like '0.5'
        if typ is int:
            return int(float(val))
        if typ is float:
            return float(val)
        # infer from default
        if isinstance(default, bool):
            return parse_flag(val)
        if isinstance(default, int):
            return int(float(val))
        if isinstance(default, float):
            return float(val)
        return val
    if typ is not None:
        return typ(val)
    if isinstance(default, float) and isinstance(val, int):
        return float(val)
    return val


def _cast_like(num: float, default, typ):
    if typ is int or (typ is None and isinstance(default, int)
                      and not isinstance(default, bool)):
        return int(num)
    return float(num)
