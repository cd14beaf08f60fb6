"""The flash_attention kernel: ``csrc/flash_attn.cu``, its plain version
``ref.py`` and the wrapper ``ops.py``."""
