"""Python-file config system with `_base_` inheritance.

The port's own copy of `ld_tpu/utils/config.py`, reading the same `configs/`
tree with the same semantics (mmcv.Config): configs are Python files defining
module-level variables; `_base_` lists parent configs whose dicts are
deep-merged (child wins); a child dict with `_delete_=True` replaces the base
dict instead of merging; `merge_from_dict` applies CLI-style dotted
overrides (`a.b.c=x`).
"""
from __future__ import annotations

import ast
import copy
import os
import types
from typing import Any, Dict, Optional

DELETE_KEY = '_delete_'
BASE_KEY = '_base_'


class ConfigDict(dict):
    """Dict with attribute access (cfg.model.backbone.depth)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict(
            {copy.deepcopy(k, memo): copy.deepcopy(v, memo)
             for k, v in self.items()})


def _to_config_dict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(x) for x in obj)
    return obj


def _to_plain(obj: Any) -> Any:
    """ConfigDicts as plain dicts, so that their repr is Python source."""
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_plain(x) for x in obj)
    return obj


def _merge_a_into_b(a: dict, b: dict) -> dict:
    """Deep-merge dict a (child) into dict b (base); a wins on conflicts."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in b and isinstance(b[k], dict) \
                and not v.get(DELETE_KEY, False):
            b[k] = _merge_a_into_b(v, b[k])
        else:
            v = copy.deepcopy(v)
            if isinstance(v, dict):
                v.pop(DELETE_KEY, None)
            b[k] = v
    return b


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    with open(filename, 'r') as f:
        code = f.read()
    module = types.ModuleType('_cfg')
    module.__file__ = filename
    exec(compile(code, filename, 'exec'), module.__dict__)
    return {
        k: v
        for k, v in module.__dict__.items()
        if not k.startswith('__') and not isinstance(v, types.ModuleType)
    }


class Config:
    """Loaded configuration with attribute access and base inheritance."""

    def __init__(self, cfg_dict: Optional[dict] = None,
                 filename: Optional[str] = None):
        cfg_dict = cfg_dict or {}
        object.__setattr__(self, '_cfg_dict', _to_config_dict(cfg_dict))
        object.__setattr__(self, '_filename', filename)

    @staticmethod
    def fromfile(filename: str) -> 'Config':
        filename = os.path.abspath(os.path.expanduser(filename))
        cfg_dict = Config._load_with_bases(filename)
        return Config(cfg_dict, filename=filename)

    @staticmethod
    def _load_with_bases(filename: str) -> dict:
        cfg_dict = _exec_pyfile(filename)
        base_files = cfg_dict.pop(BASE_KEY, [])
        if isinstance(base_files, str):
            base_files = [base_files]
        base_dict: dict = {}
        cfg_dir = os.path.dirname(filename)
        for base in base_files:
            parent = Config._load_with_bases(os.path.join(cfg_dir, base))
            dup = set(base_dict) & set(parent)
            # later bases win over earlier ones for duplicated keys
            base_dict.update({k: v for k, v in parent.items() if k not in dup})
            for k in dup:
                base_dict[k] = _merge_a_into_b(parent[k], base_dict[k]) \
                    if isinstance(parent[k], dict) and isinstance(base_dict[k], dict) \
                    else parent[k]
        return _merge_a_into_b(cfg_dict, base_dict)

    # ---- dict-ish interface -------------------------------------------------
    @property
    def filename(self):
        return self._filename

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, '_cfg_dict'), name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = _to_config_dict(value)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setitem__(self, name, value):
        self._cfg_dict[name] = _to_config_dict(value)

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def to_dict(self) -> dict:
        return copy.deepcopy(dict(self._cfg_dict))

    def merge_from_dict(self, options: Dict[str, Any]):
        """Apply dotted-key overrides, e.g. {'model.backbone.depth': 50}."""
        for full_key, value in options.items():
            d = self._cfg_dict
            keys = full_key.split('.')
            for k in keys[:-1]:
                d = d.setdefault(k, ConfigDict())
            d[keys[-1]] = _to_config_dict(value)

    def dump(self, path: str):
        """Write the merged config as a Python file that `fromfile` reads
        back."""
        import pprint
        with open(path, 'w') as f:
            for k, v in self._cfg_dict.items():
                f.write(f'{k} = {pprint.pformat(_to_plain(v), width=100)}\n')

    def __repr__(self):
        return f'Config(file={self._filename}): {dict(self._cfg_dict)!r}'


def parse_cfg_options(pairs) -> Dict[str, Any]:
    """The command line's `--cfg-options key=value ...` as a dict for
    `merge_from_dict`; each value is a Python literal where it parses as
    one, else the string."""
    out = {}
    for pair in pairs:
        key, value = pair.split('=', 1)
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        out[key] = value
    return out
