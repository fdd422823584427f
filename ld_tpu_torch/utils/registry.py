"""Registry + config-driven instantiation.

The port's own copy of `ld_tpu/utils/registry.py`: config files name
components by string (`type='GFLHead'`), and each registry maps that string
to the PyTorch class that implements it.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A string -> class/function registry.

    Example:
        >>> HEADS = Registry('head')
        >>> @HEADS.register_module()
        ... class GFLHead: ...
        >>> head = HEADS.build(dict(type='GFLHead', num_classes=80))
    """

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return (f'{self.__class__.__name__}(name={self._name}, '
                f'items={list(self._module_dict)})')

    def get(self, key: str) -> Optional[Any]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None,
                        force: bool = False,
                        module: Optional[Any] = None) -> Callable:
        """Register a class or function, usable as decorator or direct call."""
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator

    def _register(self, module: Any, name: Optional[str], force: bool):
        if not (inspect.isclass(module) or inspect.isfunction(module)):
            raise TypeError(f'module must be a class or function, '
                            f'got {type(module)}')
        names = [module.__name__] if name is None else (
            [name] if isinstance(name, str) else list(name))
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f'{n} is already registered in {self._name}')
            self._module_dict[n] = module

    def build(self, cfg: dict, default_args: Optional[dict] = None) -> Any:
        return build_from_cfg(cfg, self, default_args)


def build_from_cfg(cfg: dict, registry: Registry,
                   default_args: Optional[dict] = None) -> Any:
    """Instantiate `registry[cfg['type']](**cfg_without_type, **default_args)`."""
    if not isinstance(cfg, dict) or 'type' not in cfg:
        raise TypeError(f'cfg must be a dict with a "type" key, got {cfg!r}')
    args = dict(cfg)
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    obj_type = args.pop('type')
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f'{obj_type} is not in the {registry.name} registry')
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f'type must be a str or class, got {type(obj_type)}')
    return obj_cls(**args)


BACKBONES = Registry('backbone')
NECKS = Registry('neck')
HEADS = Registry('head')
DETECTORS = Registry('detector')
PIPELINES = Registry('pipeline')
LOSSES = Registry('loss')
ASSIGNERS = Registry('assigner')
