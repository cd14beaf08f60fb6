"""The edge_relax kernel: ``csrc/edge_relax.cu``, its plain version
``ref.py`` and the wrapper ``ops.py``."""
