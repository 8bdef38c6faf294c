from ..registry import models as _registry

make = _registry.make
register = _registry.register

from . import (geometry, light, neus, split_mixed_occ,  # noqa: E402,F401
               texture, variance)
