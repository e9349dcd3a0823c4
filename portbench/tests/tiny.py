"""A copy of the benchmark with tiny cells, for the CPU tests: the same
harness, readers and references, configurations of every kind at smoke
widths (bf16, two layers), traffic of the same kinds at a few dozen
tokens, and the cells' own limits."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PB = Path(__file__).resolve().parents[1]

TINY = {
    "tiny-glm": {"name": "tiny-glm", "n_layers": 2, "d_model": 64,
                 "n_heads": 4, "n_kv_heads": 2, "d_head": 16, "d_ff": 96,
                 "vocab_size": 512, "block_pattern": ["attn"],
                 "rope_fraction": 0.5, "rope_theta": 500000.0,
                 "mlp_kind": "swiglu", "norm_eps": 1e-5,
                 "param_dtype": "bfloat16", "remat": True},
    "tiny-rwkv": {"name": "tiny-rwkv", "n_layers": 2, "d_model": 128,
                  "n_heads": 2, "n_kv_heads": 2, "d_head": 64, "d_ff": 192,
                  "vocab_size": 512, "block_pattern": ["rwkv"],
                  "rwkv_head_dim": 64, "norm_eps": 1e-5,
                  "param_dtype": "bfloat16"},
}
TRAFFIC = {
    "tiny-prefill": {"kind": "prefill", "batch": 2, "prompt_len": 40,
                     "cache_len": 40, "distinct_prompts": 2, "zipf_a": 1.3},
    "tiny-decode": {"kind": "decode", "batch": 2, "cache_len": 48,
                    "start_pos": 40, "zipf_a": 1.3},
    "tiny-train": {"kind": "train", "microbatches": 4, "micro_batch": 1,
                   "seq_len": 32, "zipf_a": 1.3,
                   "checked_steps": 2,
                   "opt": {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                           "weight_decay": 0.1, "clip_norm": 1.0,
                           "warmup_steps": 0, "total_steps": 1000000,
                           "min_lr_ratio": 0.1}},
}
CELLS = {
    "tiny-glm-prefill": ("tiny-glm", "tiny-prefill", "glm-prefill-32k"),
    # two RWKV layers: bf16's error grows with depth (0.005 a layer at
    # width 256), so the 24-layer cell's limit is far above these
    # readings (program 0.010-0.024, fp8 control 0.13-0.22); the tiny
    # cell takes a limit between them (OWN_LIMITS)
    "tiny-rwkv-prefill": ("tiny-rwkv", "tiny-prefill", "rwkv-prefill-8k"),
    "tiny-glm-decode": ("tiny-glm", "tiny-decode", "glm-decode-32k"),
    "tiny-glm-train": ("tiny-glm", "tiny-train", "glm-train-4k"),
}


OWN_LIMITS = {"tiny-rwkv-prefill": {"logits_rel": 0.06, "cache_rel": 0.06}}


def make_root(tmp: Path, cells=None) -> Path:
    """``tmp`` as a checkout root: a copy of ``portbench/`` with the tiny
    configurations, traffic and cells added, and a ``BENCHMARK.json``
    that names them beside the real one's metrics. Each tiny cell takes
    the limits of the real cell it stands for, where that cell exists."""
    root = Path(tmp)
    shutil.copytree(PB, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    real = json.loads((PB.parent / "BENCHMARK.json").read_text())
    bench = dict(real, configs=[], workloads=[])
    for name, port in TINY.items():
        f = f"portbench/configs/{name}.json"
        (root / f).write_text(json.dumps({"name": name, "port": port}))
        bench["configs"].append({"name": name, "source": "tiny",
                                 "file": f, "reduced": [], "why": "tiny"})
    for name, tr in TRAFFIC.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(tr))
    for name, (cfg, tr, like) in (cells or CELLS).items():
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": tr, "chips": 1, "why": "tiny"})
        src = PB / "workloads" / f"{like}.json"
        cell = json.loads(src.read_text()) if src.exists() else {
            "trace_calls": 2,
            "limits": {"logits_rel": 0.05, "cache_rel": 0.05,
                       "token_gap": 0.5, "past_changed": 0.0,
                       "loss_gap.1": 0.01, "loss_gap.2": 0.01,
                       "grad_gap": 0.05,
                       "change_gap": 0.2}}
        if name in OWN_LIMITS:
            cell = dict(cell, limits=OWN_LIMITS[name])
        (root / "portbench" / "workloads" / f"{name}.json").write_text(
            json.dumps(cell))
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "workloads" in m:
                m["workloads"] = [n for n, (_, tr, like) in
                                  (cells or CELLS).items()
                                  if like in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
