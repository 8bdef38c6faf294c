from ..registry import datasets as _registry

make = _registry.make
register = _registry.register

from . import synthetic  # noqa: E402,F401
