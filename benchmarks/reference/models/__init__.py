from ..registry import models as _registry

make = _registry.make
register = _registry.register

from . import (geometry, light, neus, scatterer,  # noqa: E402,F401
               split_mixed_occ, texture, variance)
