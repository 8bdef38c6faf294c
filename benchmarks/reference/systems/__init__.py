from ..registry import systems as _registry

make = _registry.make
register = _registry.register

from . import neus, split_occ  # noqa: E402,F401
