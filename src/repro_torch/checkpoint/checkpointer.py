"""Port of ``src/repro/checkpoint/checkpointer.py``: a sharded numpy
checkpointer with manifest, async save and atomic commit.

The reference's contract:
  * every host writes only its own shards (``host<k>.npz``),
  * a ``manifest.json`` with the step, the tree's structure and the leaf
    count is committed LAST via atomic rename — a crash mid-save never
    corrupts the previous checkpoint (restore reads the newest *complete*
    step: its manifest and every host's file; one host removes old steps),
  * ``restore_latest`` + the deterministic data pipeline (step in the
    manifest) give exactly-once training semantics across restarts,
  * saves run on a background thread so the train loop never blocks on I/O.

Leaves are torch tensors, flattened in the reference's order (dict keys
sorted, tuples in order) as ``leaf<i>`` of the npz. A bfloat16 leaf, which
numpy has no type for, is stored widened to float32 (exact) and the
manifest's ``dtypes`` names it: the port narrows it back bit for bit, and
the reference's ``restore`` (``data[leaf].astype(like.dtype)``) reads the
right values. A checkpoint without ``dtypes`` (the reference's) restores by
the arrays' own types, so a float32 checkpoint the reference wrote restores
here; a port checkpoint that stored bf16 leaves as 16-bit patterns
(``uint16``) still restores here.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

__all__ = ["Checkpointer"]

# In-flight background writers per checkpoint directory, across Checkpointer
# instances. A restarted trainer builds a FRESH Checkpointer on the same
# directory while the crashed run's async save may still be committing; reads
# must drain those writers or restore_latest() misses the newest manifest and
# training silently resumes from an older step (or from scratch).
_PENDING: dict[str, threading.Thread] = {}
_PENDING_LOCK = threading.Lock()


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_structure(v) for v in tree) + ",)"
    return "*"


def _unflatten(like, leaves):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return tuple(walk(v) for v in t)
        return next(it)
    return walk(like)


def _host_array(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy (bfloat16 widened to float32, which
    is exact), and the name of its type."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy(), "bfloat16"
    return t.numpy().copy(), str(t.dtype).removeprefix("torch.")


def _tensor(a: np.ndarray, dtype_name: str, like: torch.Tensor):
    if dtype_name == "bfloat16" and a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(like.dtype).reshape(like.shape).to(like.device)


class Checkpointer:
    def __init__(self, directory: str, host_id: int = 0, n_hosts: int = 1,
                 keep: int = 3):
        self.dir = directory
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    @property
    def _key(self) -> str:
        return os.path.abspath(self.dir)

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: dict, *, blocking: bool = False):
        """Snapshot (a host copy of every leaf) then write in the
        background."""
        arrays, dtypes = zip(*(_host_array(t) for t in _flatten(state)))
        self.wait()
        thread = threading.Thread(
            target=self._write,
            args=(step, list(arrays), list(dtypes), _structure(state)),
            daemon=True)
        with _PENDING_LOCK:
            _PENDING[self._key] = thread
        thread.start()
        if blocking:
            self.wait()

    def wait(self):
        """Join any in-flight writer for this directory (any instance's)."""
        with _PENDING_LOCK:
            thread = _PENDING.get(self._key)
            if thread is None or thread is threading.current_thread():
                return                 # nothing pending, or _gc inside writer
            _PENDING.pop(self._key)
        thread.join()

    def _write(self, step: int, arrays, dtypes, structure: str):
        tmp = os.path.join(self.dir, f".tmp-{step}-{self.host_id}")
        final = os.path.join(self.dir, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"host{self.host_id}.npz"),
                 **{f"leaf{i}": a for i, a in enumerate(arrays)})
        manifest = {
            "step": step,
            "time": time.time(),
            "n_hosts": self.n_hosts,
            "n_leaves": len(arrays),
            "treedef": structure,
            "dtypes": dtypes,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.makedirs(final, exist_ok=True)
        for name in os.listdir(tmp):
            os.replace(os.path.join(tmp, name), os.path.join(final, name))
        os.rmdir(tmp)
        self._gc()

    def _gc(self):
        if self.host_id != 0:          # one host removes old steps
            return
        steps = sorted(self.list_steps())
        for s in steps[:-self.keep]:
            d = os.path.join(self.dir, f"step_{s:09d}")
            for name in os.listdir(d):
                os.remove(os.path.join(d, name))
            os.rmdir(d)

    # -------------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        self.wait()                    # drain in-flight commits before reading
        steps = []
        for name in os.listdir(self.dir):
            d = os.path.join(self.dir, name)
            if name.startswith("step_") and all(
                    os.path.exists(os.path.join(d, f)) for f in
                    ["manifest.json"] + [f"host{h}.npz"
                                         for h in range(self.n_hosts)]):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def restore(self, step: int, like: dict) -> dict:
        """The checkpoint of ``step`` in ``like``'s structure, each leaf a
        tensor of ``like``'s leaf's type, shape and device."""
        self.wait()
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = _flatten(like)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(f"checkpoint {d} has {manifest['n_leaves']} "
                             f"leaves, the state {len(leaves)}")
        with np.load(os.path.join(d, f"host{self.host_id}.npz")) as data:
            arrays = [data[f"leaf{i}"] for i in range(len(leaves))]
        names = manifest.get("dtypes") or [a.dtype.name for a in arrays]
        return _unflatten(like, [_tensor(a, n, t) for a, n, t in
                                 zip(arrays, names, leaves)])

    def restore_latest(self, like: dict) -> tuple[int, dict] | None:
        steps = self.list_steps()
        if not steps:
            return None
        return steps[-1], self.restore(steps[-1], like)
