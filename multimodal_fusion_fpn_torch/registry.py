"""Factory registry utility.

The port's copy of ``multimodal_fusion_fpn_tpu/registry.py``, after the
original project's decorator-based factory system (``utils.py:42-73``):
``get_factory_adder`` returns an ``add_class`` decorator plus the dict it
populates, keyed by class name.
"""

from typing import Any, Callable, Dict, Tuple


def get_factory_adder() -> Tuple[Callable, Dict[str, Any]]:
    """Return ``(add_class, registry_dict)``.

    Example:
        >>> add_class, registry = get_factory_adder()
        >>> @add_class
        ... class A: pass
        >>> sorted(registry) == ['A']
        True
    """
    registry: Dict[str, Any] = {}

    def add_class(cls: Any) -> Any:
        registry[cls.__name__] = cls
        return cls

    return add_class, registry
