"""Port of ``examples/``: the repository's documented ways to start the
system, as modules of the port. Each mirrors its reference line for line
where it can, imports only ``repro_torch``, takes ``--device`` (the card
unless the caller asks for ``cpu``) and runs as
``python -m repro_torch.examples.<name>``:

* ``quickstart``: one SF-ESP instance through the six algorithms;
* ``slicing_demo``: SDLA curves, a re-slice and compression on frames;
* ``serve_edge``: the serving launcher (``launch/serve.py``);
* ``train_lm``: a ~100M-parameter LM trained with checkpoint/restart,
  asserting that the loss falls.
"""
