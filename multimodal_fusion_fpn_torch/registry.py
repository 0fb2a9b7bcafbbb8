"""Factory registry utility: the port's copy of
``multimodal_fusion_fpn_tpu/registry.py``.

Behavioral parity with the original project's decorator-based factory
system (its ``utils.py:42-73``): ``get_factory_adder`` returns an
``add_class`` decorator plus the dict it populates.  The decorator can be
used bare (``@add_class``) or with an explicit registry name
(``@add_class('name')``).
"""

from typing import Any, Callable, Dict, Optional, Tuple, Union


def get_factory_adder() -> Tuple[Callable, Dict[str, Any]]:
    """Return ``(add_class, registry_dict)``.

    Example:
        >>> add_class, registry = get_factory_adder()
        >>> @add_class
        ... class A: pass
        >>> @add_class('b_alias')
        ... class B: pass
        >>> sorted(registry) == ['A', 'b_alias']
        True
    """
    registry: Dict[str, Any] = {}

    def _register(cls: Any, name: Optional[str] = None) -> Any:
        registry[cls.__name__ if name is None else name] = cls
        return cls

    def add_class(cls_or_name: Union[Any, str], name: Optional[str] = None):
        if callable(cls_or_name):
            return _register(cls_or_name, name)
        # Used as @add_class('name')
        alias = cls_or_name

        def wrapper(cls: Any) -> Any:
            return _register(cls, alias)

        return wrapper

    return add_class, registry
