"""Port of ``src/repro/launch``: the serving launcher (``serve.py``)."""
