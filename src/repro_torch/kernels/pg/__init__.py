"""Port of ``src/repro/kernels/pg``: kernel K1 (``pg.py``)."""
