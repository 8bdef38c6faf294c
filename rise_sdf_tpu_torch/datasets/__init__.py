from ..registry import datasets as _registry

make = _registry.make
register = _registry.register

from . import blender, colmap, synthetic, tensoir  # noqa: E402,F401
