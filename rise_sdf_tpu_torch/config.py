"""YAML configs (counterpart of ``rise_sdf_tpu/config.py``).

The same surface and the same answers as the JAX package's loader:
``ConfigNode`` (a dict with attribute access; a value ``???`` is
mandatory, and reading it raises), the resolvers ``calc_exp_lr_decay_rate``,
``add``, ``sub``, ``mul``, ``div``, ``idiv`` and ``basename``, ``${a.b}``
interpolation (a reference that is the whole string keeps its value's
type; references nest; a cycle raises), ``parse_cli_overrides`` (each
``a.b.c=value`` parsed as a YAML scalar, keys the config lacks merged
in), ``load_config(*files, cli_args=, extra=)`` (files, then the
dotlist, then ``extra``, deep-merged in that order, then resolved),
``config_to_primitive`` and ``dump_config``.  The YAML is read and
written by ``utils/yamlio.py``: the port imports no ``yaml``.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Callable, Dict, List, Optional

from .utils import yamlio

__all__ = ["ConfigNode", "load_config", "parse_cli_overrides",
           "register_resolver", "config_to_primitive", "dump_config",
           "resolve"]

_RESOLVERS: Dict[str, Callable[..., Any]] = {}


def register_resolver(name: str, fn: Callable[..., Any]) -> None:
    _RESOLVERS[name] = fn


def _num(x: Any) -> Any:
    if isinstance(x, (int, float)):
        return x
    s = str(x)
    try:
        return int(s)
    except ValueError:
        return float(s)


register_resolver("calc_exp_lr_decay_rate",
                  lambda factor, n: float(factor) ** (1.0 / float(n)))
register_resolver("add", lambda a, b: _num(a) + _num(b))
register_resolver("sub", lambda a, b: _num(a) - _num(b))
register_resolver("mul", lambda a, b: _num(a) * _num(b))
register_resolver("div", lambda a, b: _num(a) / _num(b))
register_resolver("idiv", lambda a, b: int(_num(a) // _num(b)))
register_resolver("basename", lambda p: os.path.basename(str(p)))

MISSING = "???"


class ConfigNode(dict):
    """A dict with attribute access whose dict and list values are
    wrapped in turn.  A value ``???`` is a mandatory one left unset:
    reading it by attribute or ``get`` raises ``ValueError``."""

    def __init__(self, data: Optional[dict] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, ConfigNode):
            return value
        if isinstance(value, dict):
            return ConfigNode(value)
        if isinstance(value, list):
            return [ConfigNode._wrap(v) for v in value]
        return value

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, ConfigNode._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            value = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        if isinstance(value, str) and value == MISSING:
            raise ValueError(f"Missing mandatory config value: {key}")
        return value

    def get(self, key, default: Any = None) -> Any:
        value = super().get(key, default)
        if isinstance(value, str) and value == MISSING:
            raise ValueError(f"Missing mandatory config value: {key}")
        return value

    def merge(self, other: dict) -> "ConfigNode":
        """Deep-merge ``other`` into this node (``other`` wins)."""
        for k, v in other.items():
            if k in self and isinstance(self[k], ConfigNode) \
                    and isinstance(v, dict):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def set_dotted(self, dotted_key: str, value: Any) -> None:
        parts = dotted_key.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], ConfigNode):
                node[p] = ConfigNode()
            node = node[p]
        node[parts[-1]] = value

    def get_dotted(self, dotted_key: str) -> Any:
        node: Any = self
        for p in dotted_key.split("."):
            node = node[int(p)] if isinstance(node, list) else node[p]
        return node

    def to_primitive(self) -> dict:
        return {k: _to_primitive(v) for k, v in self.items()}

    def copy(self) -> "ConfigNode":  # type: ignore[override]
        return ConfigNode(copy.deepcopy(self.to_primitive()))


def _to_primitive(v: Any) -> Any:
    if isinstance(v, ConfigNode):
        return v.to_primitive()
    if isinstance(v, list):
        return [_to_primitive(x) for x in v]
    return v


def config_to_primitive(cfg: Any) -> Any:
    """Plain dicts and lists all the way down."""
    return _to_primitive(cfg)


# --------------------------------------------------------------------------- #
# Interpolation
# --------------------------------------------------------------------------- #

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _resolve_string(s: str, root: ConfigNode, stack: tuple) -> Any:
    """Every ``${...}`` of ``s``, innermost first; a reference that is
    the whole string keeps its value's type."""
    while True:
        m = _INTERP_RE.search(s)
        if m is None:
            return s
        val = _resolve_expr(m.group(1), root, stack)
        if m.span() == (0, len(s)):
            return val
        s = s[:m.start()] + str(val) + s[m.end():]


def _resolve_expr(expr: str, root: ConfigNode, stack: tuple) -> Any:
    if expr in stack:
        raise ValueError(f"Interpolation cycle detected at '{expr}'")
    stack = stack + (expr,)
    if ":" in expr:
        name, _, argstr = expr.partition(":")
        if name not in _RESOLVERS:
            raise KeyError(f"Unknown config resolver '{name}'")
        args = [_resolve_string(a, root, stack) for a in _split_args(argstr)]
        return _RESOLVERS[name](*args)
    return _resolve_value(root.get_dotted(expr), root, stack)


def _split_args(argstr: str) -> List[str]:
    """A resolver's arguments: split on commas outside ``${...}``."""
    args, depth, cur = [], 0, []
    for ch in argstr:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            args.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        args.append("".join(cur).strip())
    return args


def _resolve_value(v: Any, root: ConfigNode, stack: tuple) -> Any:
    if isinstance(v, str):
        return _resolve_string(v, root, stack)
    if isinstance(v, ConfigNode):
        out = ConfigNode()
        for k, sub in v.items():
            out[k] = _resolve_value(sub, root, stack)
        return out
    if isinstance(v, list):
        return [_resolve_value(x, root, stack) for x in v]
    return v


def resolve(cfg: ConfigNode) -> ConfigNode:
    """Every interpolation of the tree, resolved."""
    return _resolve_value(cfg, cfg, ())


# --------------------------------------------------------------------------- #
# Loading and dumping
# --------------------------------------------------------------------------- #


def parse_cli_overrides(dotlist: List[str]) -> ConfigNode:
    """``a.b.c=value`` overrides, each value read as a YAML document (so
    ``1e-3`` stays a string and ``1.0e-3`` is a float, as in JAX)."""
    out = ConfigNode()
    for item in dotlist:
        if "=" not in item:
            raise ValueError(
                f"Malformed override (expected key=value): {item}")
        key, _, raw = item.partition("=")
        out.set_dotted(key.strip(), yamlio.load(raw, f"override {item!r}"))
    return out


def load_config(*yaml_files: str, cli_args: Optional[List[str]] = None,
                extra: Optional[dict] = None) -> ConfigNode:
    """The files deep-merged in order, then ``cli_args``, then
    ``extra``; every interpolation resolved."""
    cfg = ConfigNode()
    for f in yaml_files:
        cfg.merge(yamlio.load_file(f) or {})
    if cli_args:
        cfg.merge(parse_cli_overrides(cli_args))
    if extra:
        cfg.merge(extra)
    return resolve(cfg)


def dump_config(cfg: ConfigNode, path: str) -> None:
    """``cfg`` as YAML at ``path`` (its directory made)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(yamlio.dump(config_to_primitive(cfg)))
