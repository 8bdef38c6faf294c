"""The plain PyTorch reference: a frozen copy of the port's model,
training and eval code (``rise_sdf_tpu_torch`` at the commit that
added this benchmark), with every hand-written kernel replaced by its
plain version on every device:

* ``ops/gather.py``: G1 -> ``index_select``;
* ``ops/scatter.py``: K1 -> ``index_add_``;
* ``ops/scatter_sorted.py``: K2 -> its plain arithmetic in torch ops;
* ``datasets/``: the procedural scenes alone;
* ``draws.py``: parameters drawn on the device from two buffers
  (``Draws``), which the harness also hands to the program.

It imports nothing of ``rise_sdf_tpu_torch`` or of the JAX package, and
builds its own prefilter bank and FG table under ``reference/_cache/``.
Later changes to the program do not touch it, so it stays the yardstick
that ``correct`` is judged by.
"""

from . import registry  # noqa: F401
