"""Port of ``src/repro/kernels/resize``: kernel K3 (``resize.py``) and
``compress_frames`` (``ops.py``)."""
