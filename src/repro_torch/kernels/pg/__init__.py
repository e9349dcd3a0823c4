"""Port of ``src/repro/kernels/pg``: kernels K1 and K2 (``pg.py``) and the
single-instance round that calls K2 (``ops.py``)."""
