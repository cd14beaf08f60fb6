"""The embedding_bag kernel: ``csrc/embedding_bag.cu``, its plain version
``ref.py`` and the wrapper ``ops.py``."""
