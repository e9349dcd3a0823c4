"""Port of ``src/repro/launch``: the serving launcher (``serve.py``), the
train launcher (``train.py``) and the metro solve's cells mesh
(``mesh.py``)."""
