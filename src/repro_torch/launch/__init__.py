"""Port of ``src/repro/launch``: the serving launcher (``serve.py``) and
the metro solve's cells mesh (``mesh.py``)."""
