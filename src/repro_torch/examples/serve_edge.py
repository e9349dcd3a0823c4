"""Port of ``examples/serve_edge.py``: serve a small model with batched
requests behind SEM-O-RAN admission (deliverable (b), serving flavor).
Wraps ``launch/serve.py``: the re-slice (K1 on the card), the vision jobs'
resize (K3) and, for an arch with full-attention layers (``--arch
chatglm3-6b``), the LM jobs' prefill through K4.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_edge [--device cpu]
"""

from ..launch.serve import main

if __name__ == "__main__":
    main()
