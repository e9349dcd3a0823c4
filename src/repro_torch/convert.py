"""Carry the JAX package's host state into the port's objects.

SF-ESP has no learned parameters; its state is the data model — the
semantic curve matrix, resource pools, coupling topology and the tables of
built problem instances. These converters take that state as plain numpy
arrays and scalars (what a test reads off the reference's objects) and build
the port's equivalents, without importing the reference, so both packages
can be handed the very same state.

Identity matters in two places and is preserved: every instance of one
deployment must share ONE ``link_capacity`` array (``merge_coupling``
identifies the link set by array identity) and one semantic model object
(``stack_instances`` refuses mixed models). :class:`Converter` memoizes both
by the identity of the source array or model it was given.

LM-service models do have parameters: :func:`lm_params` carries a reference
parameter tree, given as numpy arrays, into the port's tree.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.semantics import DEFAULT_MODEL, SemanticModel
from .core.types import CouplingSpec, ProblemInstance, ResourcePool, TaskSet

__all__ = ["Converter", "lm_params", "resource_pool", "semantic_model",
           "task_set"]

_TASK_FIELDS = ("app_idx", "min_accuracy", "max_latency", "bits_per_job",
                "jobs_per_sec", "gpu_time_per_job", "n_ues")


def semantic_model(params) -> SemanticModel:
    """A mutable port model over the given (n_apps, 3) ``[M, γ, H]`` rows."""
    return SemanticModel(np.array(params, np.float64))


def resource_pool(names, capacity, price, levels) -> ResourcePool:
    return ResourcePool(names=tuple(names),
                        capacity=np.array(capacity, np.float64),
                        price=np.array(price, np.float64),
                        levels=tuple(np.array(lv, np.float64)
                                     for lv in levels))


def task_set(**arrays) -> TaskSet:
    """A :class:`TaskSet` from its seven (T,) arrays, by field name."""
    return TaskSet(**{f: np.array(arrays[f]) for f in _TASK_FIELDS})


class Converter:
    """Builds port objects from reference state, keeping shared state shared.

    ``link_capacity`` arrays and semantic-model parameter sources are
    memoized by the identity of the object passed in, so instances that
    shared a link set or a model in the reference share one here too.
    """

    def __init__(self):
        self._links: dict[int, tuple[object, np.ndarray]] = {}
        self._models: dict[int, tuple[object, SemanticModel]] = {}

    def link_capacity(self, arr) -> np.ndarray:
        hit = self._links.get(id(arr))
        if hit is None:
            # keep the source alive so its id cannot be recycled
            hit = (arr, np.array(arr, np.float64))
            self._links[id(arr)] = hit
        return hit[1]

    def coupling(self, link_capacity, incidence, names=None) -> CouplingSpec:
        return CouplingSpec(self.link_capacity(link_capacity),
                            np.array(incidence, bool),
                            None if names is None else tuple(names))

    def model(self, source, params) -> SemanticModel:
        """The port model standing for reference model ``source`` (any
        object; ``None`` means the paper default) with curve ``params``."""
        if source is None:
            return DEFAULT_MODEL
        hit = self._models.get(id(source))
        if hit is None:
            hit = (source, semantic_model(params))
            self._models[id(source)] = hit
        return hit[1]

    def instance(self, *, pool: dict, tasks: dict, z_grid, acc, acc_agnostic,
                 grid, lat, lat_agnostic, z_star_idx, z_star_idx_agnostic,
                 coupling: dict | None = None, model_source=None,
                 model_params=None) -> ProblemInstance:
        """A :class:`ProblemInstance` from its tables; ``pool``/``tasks``/
        ``coupling`` are keyword dicts of :func:`resource_pool`,
        :func:`task_set` and :meth:`coupling`."""
        return ProblemInstance(
            pool=resource_pool(**pool), tasks=task_set(**tasks),
            z_grid=np.array(z_grid), acc=np.array(acc),
            acc_agnostic=np.array(acc_agnostic), grid=np.array(grid),
            lat=np.array(lat), lat_agnostic=np.array(lat_agnostic),
            z_star_idx=np.array(z_star_idx),
            z_star_idx_agnostic=np.array(z_star_idx_agnostic),
            coupling=None if coupling is None else self.coupling(**coupling),
            semantics=self.model(model_source, model_params)
            if model_source is not None else None)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params(tree, cfg, device="cuda"):
    """The port's parameter tree for model ``cfg`` from the reference's
    (``init_params`` output with every leaf a numpy array, as
    ``jax.tree.map(np.asarray, params)`` gives it): the same keys, tuples
    and leaves, each leaf a tensor on ``device`` of the array's type."""
    if tuple(np.shape(tree["embed"])) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {np.shape(tree['embed'])} does not fit "
                         f"{cfg.name}")
    if ("lm_head" in tree) == cfg.tie_embeddings:
        raise ValueError(f"lm_head does not fit tie_embeddings="
                         f"{cfg.tie_embeddings}")

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        return _tensor(node, device)
    return conv(tree)
