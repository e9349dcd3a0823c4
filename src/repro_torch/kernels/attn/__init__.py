"""Port of ``src/repro/kernels/attn``: kernel K4 and its plain version, the
counterpart of ``ref.py`` (``attn.py``), and the wrapper module
(``ops.py``)."""
