"""Port of ``src/repro/launch``: the serving launcher (``serve.py``), the
train launcher (``train.py``), the production, test and cells meshes and
the H100's roofline constants (``mesh.py``), the dry-run cells
(``specs.py``), one rank's counts of a step (``cost.py``, in the role of
the reference's ``hlo_analysis.py``) and the dry run (``dryrun.py``)."""
