"""Minimal hydra-compatible config system.

Reimplements the subset of hydra/OmegaConf the reference relies on
(see reference conf/config.yaml:55-70 defaults list, ``# @package`` headers,
``${...}`` interpolation, ``group=option`` / ``group@pkg=option`` /
``a.b.c=value`` / ``+a=value`` overrides, expt override files read by
reference run.py:18-27) without the hydra dependency. Content of the config
tree is exposed through :class:`Config`, a lazy view that resolves
interpolations on access so later overrides propagate naturally.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import yaml

from .values import parse_value

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")
_PACKAGE_RE = re.compile(r"^#\s*@package\s+([\w.]+)\s*$", re.MULTILINE)

# Custom resolvers, keyed by the "resolver:" prefix inside ${...}.
RESOLVERS: Dict[str, Callable[[str], Any]] = {
    "hydra": lambda arg: os.getcwd() if arg == "runtime.cwd" else None,
    "oc.env": lambda arg: os.environ.get(arg),
}


class MissingKeyError(KeyError):
    pass


class InterpolationError(ValueError):
    pass


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _tree_select(tree: dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            raise MissingKeyError(dotted)
        node = node[part]
    return node


def _tree_set(tree: dict, dotted: str, value, *, create: bool):
    parts = dotted.split(".")
    node = tree
    for part in parts[:-1]:
        if part not in node or not isinstance(node[part], dict):
            if not create and part not in node:
                raise MissingKeyError(dotted)
            node[part] = {} if not isinstance(node.get(part), dict) else node[part]
        node = node[part]
    if not create and parts[-1] not in node:
        raise MissingKeyError(dotted)
    node[parts[-1]] = value


class Config:
    """Attribute/dict-style lazy view over a composed config tree."""

    __slots__ = ("_root", "_path")

    def __init__(self, root: dict, path: Tuple[str, ...] = ()):  # noqa: D401
        object.__setattr__(self, "_root", root)
        object.__setattr__(self, "_path", path)

    # -- raw access ---------------------------------------------------------
    def _node(self) -> dict:
        node = self._root
        for part in self._path:
            node = node[part]
        return node

    def _resolve_value(self, raw, _stack: Optional[frozenset] = None):
        if isinstance(raw, dict):
            raise AssertionError("dicts are wrapped, not resolved")
        if isinstance(raw, str) and "${" in raw:
            return _resolve_interp(self._root, raw, _stack or frozenset())
        return raw

    # -- mapping protocol ----------------------------------------------------
    def __getitem__(self, key: str):
        node = self._node()
        if key not in node:
            raise MissingKeyError(".".join(self._path + (key,)))
        raw = node[key]
        if isinstance(raw, dict):
            return Config(self._root, self._path + (key,))
        if isinstance(raw, list):
            return [
                Config._wrap_list_item(self._root, el) for el in raw
            ]
        val = self._resolve_value(raw)
        if isinstance(val, dict):
            # interpolation resolved to a subtree elsewhere: wrap a copy
            return Config({"_": val}, ("_",))
        return val

    @staticmethod
    def _wrap_list_item(root, el):
        if isinstance(el, dict):
            return Config({"_": el}, ("_",))
        if isinstance(el, str) and "${" in el:
            return _resolve_interp(root, el, frozenset())
        return el

    def __getattr__(self, key: str):
        if key.startswith("__"):
            raise AttributeError(key)
        try:
            return self[key]
        except MissingKeyError as e:
            raise AttributeError(str(e)) from e

    def __setattr__(self, key: str, value):
        self._node()[key] = _unwrap(value)

    def __setitem__(self, key: str, value):
        self._node()[key] = _unwrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._node()

    def __iter__(self):
        return iter(self._node())

    def __len__(self):
        return len(self._node())

    def keys(self):
        return self._node().keys()

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def values(self):
        return [self[k] for k in self.keys()]

    def get(self, key: str, default=None):
        try:
            val = self[key]
        except MissingKeyError:
            return default
        return default if val is None else val

    # -- helpers ---------------------------------------------------------
    def select(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Config) or part not in node:
                return default
            node = node[part]
        return node

    def set(self, dotted: str, value, *, create: bool = True):
        _tree_set(self._node(), dotted, _unwrap(value), create=create)

    def to_container(self, resolve: bool = True):
        node = self._node()
        if not resolve:
            return copy.deepcopy(node)
        return _resolve_container(self._root, node, frozenset())

    def is_dict(self, key: str) -> bool:
        raw = self._node().get(key)
        if isinstance(raw, dict):
            return True
        if isinstance(raw, str) and "${" in raw:
            return isinstance(self._resolve_value(raw), dict)
        return False

    def __repr__(self):
        return f"Config({'.'.join(self._path) or '<root>'})"

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_container(resolve=True), sort_keys=False)


def _unwrap(value):
    if isinstance(value, Config):
        return value.to_container(resolve=False)
    return value


def _resolve_container(root, node, stack):
    if isinstance(node, dict):
        return {k: _resolve_container(root, v, stack) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_container(root, v, stack) for v in node]
    if isinstance(node, str) and "${" in node:
        return _resolve_container(root, _resolve_interp(root, node, stack), stack)
    return node


def _resolve_interp(root: dict, text: str, stack: frozenset):
    if text in stack:
        raise InterpolationError(f"interpolation cycle through {text!r}")
    stack = stack | {text}

    def lookup(expr: str):
        expr = expr.strip()
        for name, fn in RESOLVERS.items():
            prefix = name + ":"
            if expr.startswith(prefix):
                return fn(expr[len(prefix):])
        val = _tree_select(root, expr)
        if isinstance(val, str) and "${" in val:
            val = _resolve_interp(root, val, stack)
        return val

    m = _INTERP_RE.fullmatch(text.strip())
    if m:  # whole string is a single interpolation: keep value type
        return lookup(m.group(1))
    return _INTERP_RE.sub(lambda mo: str(lookup(mo.group(1))), text)


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

def _load_yaml_with_package(path: Path) -> Tuple[dict, Optional[str]]:
    text = path.read_text()
    pkg = None
    m = _PACKAGE_RE.search(text)
    if m:
        pkg = m.group(1)
    data = yaml.safe_load(text) or {}
    if not isinstance(data, dict):
        raise ValueError(f"{path}: top level must be a mapping")
    return data, pkg


class Override:
    """One parsed override: either a group choice or a value set."""

    def __init__(self, key: str, value: str):
        self.append = key.startswith("+")
        if self.append:
            key = key[1:]
        self.key = key
        self.raw_value = value
        # group overrides use '/' in the key or an '@' package redirect
        self.is_group = ("/" in key) or ("@" in key)

    @property
    def group_and_pkg(self) -> Tuple[str, Optional[str]]:
        if "@" in self.key:
            grp, pkg = self.key.split("@", 1)
            return grp, pkg
        return self.key, None


def parse_override_line(line: str) -> Optional[Override]:
    line = line.split("#")[0].strip()
    if not line:
        return None
    if "=" not in line:
        raise ValueError(f"override must be key=value: {line!r}")
    key, value = line.split("=", 1)
    return Override(key.strip(), value.strip())


def compose(config_dir: str,
            overrides: Optional[List[str]] = None,
            config_name: str = "config") -> Config:
    config_dir = Path(config_dir)
    overrides = [parse_override_line(o) for o in (overrides or [])]
    overrides = [o for o in overrides if o is not None]

    group_choices: Dict[Tuple[str, Optional[str]], str] = {}
    value_overrides: List[Override] = []
    for o in overrides:
        if o.is_group:
            grp, pkg = o.group_and_pkg
            group_choices[(grp, pkg)] = o.raw_value
        else:
            value_overrides.append(o)

    primary, _ = _load_yaml_with_package(config_dir / f"{config_name}.yaml")
    defaults = primary.pop("defaults", [])

    tree: dict = {}
    merged_self = False
    seen_groups: set = set()

    for entry in defaults:
        if entry == "_self_":
            _deep_merge(tree, primary)
            merged_self = True
            continue
        if isinstance(entry, str):
            group, pkg_override, option = entry, None, None
        elif isinstance(entry, dict):
            (spec, option), = entry.items()
            if "@" in spec:
                group, pkg_override = spec.split("@", 1)
            else:
                group, pkg_override = spec, None
        else:
            raise ValueError(f"bad defaults entry: {entry!r}")

        # apply CLI group choice
        choice_key = (group, pkg_override)
        if choice_key in group_choices:
            option = group_choices.pop(choice_key)
        seen_groups.add(choice_key)

        if option is None:
            fpath = config_dir / f"{group}.yaml"
        else:
            fpath = config_dir / group / f"{option}.yaml"
        data, header_pkg = _load_yaml_with_package(fpath)
        if pkg_override is not None:
            pkg = pkg_override
        elif header_pkg is not None:
            pkg = header_pkg
        else:
            pkg = group.replace("/", ".")
        if pkg in ("_global_", ""):
            _deep_merge(tree, data)
        else:
            sub = tree
            for part in pkg.split("."):
                sub = sub.setdefault(part, {})
            _deep_merge(sub, data)

    # group choices not present in the defaults list: load them additively
    for (group, pkg_override), option in group_choices.items():
        fpath = config_dir / group / f"{option}.yaml"
        data, header_pkg = _load_yaml_with_package(fpath)
        pkg = pkg_override or header_pkg or group.replace("/", ".")
        sub = tree
        for part in pkg.split("."):
            sub = sub.setdefault(part, {})
        _deep_merge(sub, data)

    if not merged_self:
        _deep_merge(tree, primary)

    for o in value_overrides:
        value = parse_value(o.raw_value) if o.raw_value != "" else ""
        try:
            _tree_set(tree, o.key, value, create=o.append)
        except MissingKeyError:
            raise MissingKeyError(
                f"override key {o.key!r} not found in config "
                f"(prefix with '+' to add a new key)") from None

    return Config(tree)
