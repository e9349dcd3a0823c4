"""Port of ``src/repro/core/semantics.py`` (the port's own numpy copy),
held against it value for value by ``tests/test_torch_core.py``.

Semantic accuracy curves a_τ(z) — the paper's first key concept.

Different target-class sets tolerate different compression levels (paper Fig. 1
and Fig. 2-left). The paper treats ``a_τ(z)`` as *given problem input*, built by
the SDLA rApp from representative datasets. We model each application's
accuracy-vs-compression curve with a saturating Hill function

    a(z) = M · z^γ / (z^γ + H)          (M = asymptotic metric, H = h^γ)

whose three parameters are calibrated to every operating point the paper
reports. ``z`` is the bitrate scaling factor of Section IV-A; the metric is mAP
for the COCO/YOLOX detection applications and mIoU for the Cityscapes/BiSeNetV2
segmentation applications (Tab. II).

Calibration anchors (all from the paper text):
  * COCO All:        a(1.0) = 0.50 (YOLOX on full COCO),  a(0.10) ≈ 0.25
                     (HighComp baseline: 10 % size → mAP ≈ 0.25), sup < 0.55
                     (Fig. 6 "high" threshold unreachable for All).
  * COCO Bags:       a(0.28) ≈ 0.30 (Fig. 7: Bags compressed to 28 % meets the
                     constraint; the agnostic All curve would pick 14 %, which
                     the true Bags curve does NOT meet).
  * COCO Animals:    reaches 0.50 on its own curve (Fig. 7(f)), which All never
                     does.
  * Cityscapes All:  meets 0.50 mIoU at z ≈ 0.18 (Fig. 7(i) agnostic pick),
                     sup < 0.70 ("high" mIoU unreachable for All).
  * Cityscapes Flat: meets 0.50 mIoU at z ≈ 0.08 (Fig. 7(i) semantic pick).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

__all__ = [
    "AppClass",
    "APPS",
    "APP_INDEX",
    "DETECTION_APPS",
    "SEGMENTATION_APPS",
    "LM_APPS",
    "PAPER_APPS",
    "SERVICE_BITS_PER_JOB",
    "SERVICE_GPU_TIME",
    "DEFAULT_MODEL",
    "SemanticModel",
    "accuracy",
    "accuracy_table",
    "min_z_for_accuracy",
    "agnostic_app",
    "warm_start_accuracy",
]


@dataclasses.dataclass(frozen=True)
class AppClass:
    """One row of paper Tab. II plus its calibrated curve parameters."""

    name: str
    service: str          # "detection" (mAP) | "segmentation" (mIoU)
    target_classes: tuple[str, ...]
    asymptote: float      # M — metric as z → ∞ (strict upper bound of a(z))
    gamma: float          # γ — curve steepness
    hill: float           # H = h^γ — half-saturation constant


def _hill(M: float, anchor_z: float, anchor_a: float, gamma: float) -> AppClass | tuple:
    """Solve H from one (z, a) anchor given M and γ: a = M x/(x+H), x=z^γ."""
    x = anchor_z ** gamma
    H = x * (M - anchor_a) / anchor_a
    return M, gamma, H


# --- COCO / YOLOX multi-object detection applications (Tab. II) -------------
# γ for COCO-All solved from the two anchors a(1)=0.50, a(0.1)=0.25 with
# M=0.55:  H=0.1 from the first;  γ = log(H·0.25/(0.55-0.25)·...)  → 1.079.
_COCO_ALL = AppClass(
    "coco_all", "detection",
    ("<all 80 COCO classes>",),
    # a(1) = 0.4975 — strictly below the 0.50 bound ("a mAP of 0.5 can never
    # be reached by All", Fig. 7(f)) while matching the ≈0.50/≈0.25 anchors.
    asymptote=0.55, gamma=1.079, hill=0.1055,
)
_COCO_URBAN = AppClass(
    "coco_urban", "detection",
    ("bicycle", "car", "motorcycle", "bus", "truck", "traffic light",
     "stop sign", "person"),
    # bicycle-limited: slightly easier than All at mid z, sup just below 0.58
    *_hill(M=0.58, anchor_z=1.0, anchor_a=0.52, gamma=1.05),
)
_COCO_BAGS = AppClass(
    "coco_bags", "detection",
    ("handbag", "backpack", "suitcase"),
    # small objects — *harder* than All: a(0.28)=0.30, a(0.14)≈0.19 < 0.30.
    *_hill(M=0.48, anchor_z=0.28, anchor_a=0.30, gamma=1.30),
)
_COCO_ANIMALS = AppClass(
    "coco_animals", "detection",
    ("bird", "cat", "dog", "horse", "sheep", "cow", "elephant", "bear",
     "zebra", "giraffe"),
    # large distinctive objects: reaches 0.50 at z ≈ 0.30, a(1) ≈ 0.62.
    *_hill(M=0.68, anchor_z=0.30, anchor_a=0.50, gamma=1.10),
)
_COCO_PERSON = AppClass(
    "coco_person", "detection",
    ("person",),
    # the easiest detection app: meets the 0.55 "high" bound at z ≈ 0.25.
    *_hill(M=0.70, anchor_z=0.25, anchor_a=0.55, gamma=1.10),
)

# --- Cityscapes / BiSeNetV2 segmentation applications (Tab. II) -------------
_CITY_ALL = AppClass(
    "cityscapes_all", "segmentation",
    ("<all 19 Cityscapes eval classes>",),
    # anchors: a(1)=0.65 (≈BiSeNetV2 val mIoU under stream re-encode),
    # a(0.18)=0.50 (Fig. 7(i) agnostic pick), sup < 0.70.
    asymptote=0.69, gamma=1.062, hill=0.0615,
)
_CITY_VEHICLES = AppClass(
    "cityscapes_vehicles", "segmentation",
    ("car", "truck", "bus", "train", "motorcycle", "bicycle"),
    *_hill(M=0.80, anchor_z=0.55, anchor_a=0.70, gamma=1.10),
)
_CITY_OBJECTS = AppClass(
    "cityscapes_objects", "segmentation",
    ("pole", "traffic light", "traffic sign"),
    # thin structures — hardest: sup < 0.60.
    *_hill(M=0.60, anchor_z=1.0, anchor_a=0.55, gamma=1.35),
)
_CITY_FLAT = AppClass(
    "cityscapes_flat", "segmentation",
    ("road", "sidewalk"),
    # huge homogeneous regions — easiest: meets 0.50 at z ≈ 0.08.
    *_hill(M=0.85, anchor_z=0.08, anchor_a=0.50, gamma=1.168),
)
_CITY_PERSON = AppClass(
    "cityscapes_person", "segmentation",
    ("person",),
    *_hill(M=0.74, anchor_z=1.0, anchor_a=0.68, gamma=1.15),
)

DETECTION_APPS = (_COCO_ALL, _COCO_URBAN, _COCO_BAGS, _COCO_ANIMALS, _COCO_PERSON)
SEGMENTATION_APPS = (_CITY_ALL, _CITY_VEHICLES, _CITY_OBJECTS, _CITY_FLAT,
                     _CITY_PERSON)

# --- edge LM applications (beyond-paper workload) ----------------------------
# Same semantic-compression story applied to token streams: ``z`` is the
# prompt/context keep-rate and a(z) the task-quality metric. The Hill family
# fits published prompt-compression curves (LLMLingua-style: summarization is
# robust down to ~20 % of tokens, code generation degrades quickly).
_LM_ALL = AppClass(
    "lm_all", "lm",
    ("<all prompt domains>",),
    *_hill(M=0.80, anchor_z=0.30, anchor_a=0.55, gamma=1.10),
)
_LM_SUMMARIZATION = AppClass(
    "lm_summarization", "lm",
    ("news", "meeting notes", "papers"),
    # redundant inputs — easiest: keeps ~0.6 quality at 20 % of tokens.
    *_hill(M=0.78, anchor_z=0.20, anchor_a=0.60, gamma=1.05),
)
_LM_CODE = AppClass(
    "lm_code", "lm",
    ("code completion", "repair"),
    # identifiers/structure can't be dropped — hardest: sup < 0.75.
    *_hill(M=0.75, anchor_z=1.0, anchor_a=0.68, gamma=1.40),
)
LM_APPS = (_LM_ALL, _LM_SUMMARIZATION, _LM_CODE)

# the ten Tab. II rows the paper evaluates; LM apps extend the registry beyond
# the paper without disturbing the Fig. 6/7 scenario draws.
PAPER_APPS: tuple[AppClass, ...] = DETECTION_APPS + SEGMENTATION_APPS
APPS: tuple[AppClass, ...] = PAPER_APPS + LM_APPS
APP_INDEX: dict[str, int] = {a.name: i for i, a in enumerate(APPS)}

# service → dataset-wide "All" curve a semantics-agnostic algorithm falls back to
_AGNOSTIC_NAME = {"detection": "coco_all", "segmentation": "cityscapes_all",
                  "lm": "lm_all"}

# per-service stream characteristics, shared by the scenario library and the
# serving SDLA so scenario-built and request-built instances agree
# (Section V-A: COCO images ~100 KB; YOLOX ≈ 0.125 s on one reference GPU —
# the Fig. 2-right calibration point; BiSeNetV2 is a real-time segmenter,
# ~3x lighter; LM requests are small token payloads, decode-dominated).
SERVICE_BITS_PER_JOB = {"detection": 0.8, "segmentation": 0.8,
                        "lm": 0.02}                              # Mbit/job
SERVICE_GPU_TIME = {"detection": 0.125, "segmentation": 0.042,
                    "lm": 0.060}                                 # s/job @ z=1

# parameter matrix for vectorized evaluation: (n_apps, 3) = [M, γ, H]
_PARAMS = np.array([[a.asymptote, a.gamma, a.hill] for a in APPS])

_AGNOSTIC_IDX = np.array([APP_INDEX[_AGNOSTIC_NAME[a.service]] for a in APPS])

# model-instance counter: signatures must distinguish two models that happen
# to share a version number, and id() can be recycled after gc.
_MODEL_UIDS = itertools.count()


class SemanticModel:
    """First-class, versioned accuracy model — a(z) as mutable problem input.

    The paper treats the curves as *given*; a live system's SDLA recalibrates
    them as classifiers are retrained or scenes change (semantic drift). This
    object makes that explicit: the per-app Hill parameters live in a
    ``(n_apps, 3)`` float64 matrix ``[M, γ, H]``, every in-place curve change
    bumps a monotone ``version`` and records *which* apps moved, and
    ``signature`` keys every derived cache (stacked tables, device halves,
    serve sessions) so a drifted model can never silently serve stale rows.

    ``DEFAULT_MODEL`` is the immutable paper calibration — bit-for-bit the
    table the module-level functions always computed. Engines that want drift
    own a mutable copy via :meth:`paper_default`.
    """

    __slots__ = ("params", "version", "_uid", "_mutable", "_nominal",
                 "_changed")

    def __init__(self, params: np.ndarray | None = None, *,
                 mutable: bool = True):
        self.params = np.array(_PARAMS if params is None else params,
                               np.float64)
        if self.params.shape != (len(APPS), 3):
            raise ValueError(f"params must be ({len(APPS)}, 3) [M, γ, H], "
                             f"got {self.params.shape}")
        self._validate(self.params)
        self.version = 0
        self._uid = next(_MODEL_UIDS)
        self._mutable = mutable
        # nominal = construction-time calibration; transient shifts (scales)
        # are expressed relative to it so composed schedules don't compound.
        self._nominal = self.params.copy()
        self._changed: list[frozenset[int]] = []   # _changed[k]: bump k→k+1

    @staticmethod
    def _validate(rows: np.ndarray) -> None:
        if not (np.isfinite(rows).all() and (rows > 0.0).all()):
            raise ValueError("curve params [M, γ, H] must be finite and > 0 "
                             "(keeps a(z) monotone increasing in z)")

    @classmethod
    def paper_default(cls) -> "SemanticModel":
        """A fresh *mutable* copy of the paper calibration (driftable)."""
        return cls(_PARAMS)

    @property
    def n_apps(self) -> int:
        return self.params.shape[0]

    @property
    def signature(self) -> tuple[int, int]:
        """Hashable cache-key component: (model identity, curve version)."""
        return (self._uid, self.version)

    # -- curve evaluation (the former module globals, now methods) ----------

    def accuracy(self, app_idx, z):
        """a(z) for application index/array ``app_idx`` at compression ``z``.

        Vectorized over both arguments (broadcast); pure numpy so it can also
        be traced by JAX via jnp dispatch on the caller side when needed.
        """
        app_idx = np.asarray(app_idx)
        z = np.asarray(z, np.float64)
        M, g, H = (self.params[app_idx, i] for i in range(3))
        x = np.power(np.clip(z, 1e-9, 1.0), g)
        return M * x / (x + H)

    def accuracy_table(self, app_idx: np.ndarray,
                       z_grid: np.ndarray) -> np.ndarray:
        """(T, Z) table of a_τ(z) for each task's app over the z grid."""
        return self.accuracy(np.asarray(app_idx)[:, None],
                             np.asarray(z_grid)[None, :])

    def warm_start_accuracy(self, app_idx: int, z: float) -> float:
        """The handover warm-start pin: the accuracy a stream already encoded
        at ``z`` achieves — Eq. (2) in the target cell then re-derives (at
        most) that same compression instead of renegotiating the stream. The
        pin is recorded as a *value* at handover time, so it stays put when
        the model later drifts under it."""
        return float(self.accuracy(np.array([app_idx]), np.array([z]))[0])

    def min_z_for_accuracy(self, app_idx: np.ndarray, min_acc: np.ndarray,
                           z_grid: np.ndarray) -> np.ndarray:
        """Eq. (2): z*_τ = min z s.t. a_τ(z) ≥ A_c, as an index into z_grid.

        Returns -1 where the bound is unreachable for any z ≤ 1 (the task is
        pruned from the candidate set, Alg. 1 line 7). Relies on a(z) being
        monotone increasing in z (Hill curves are).
        """
        table = self.accuracy_table(app_idx, z_grid)     # (T, Z)
        ok = table >= np.asarray(min_acc)[:, None]
        any_ok = ok.any(axis=1)
        first = np.argmax(ok, axis=1)            # first True (z ascending)
        return np.where(any_ok, first, -1)

    def agnostic_app(self, app_idx: np.ndarray) -> np.ndarray:
        """Map each app to the dataset-wide 'All' app (what SI-EDGE assumes).

        SI-EDGE "considers all the tasks as belonging to the 'All'
        application" (Section V-B): detection apps → coco_all, segmentation →
        cityscapes_all, and the beyond-paper LM apps → lm_all. Registry
        structure, not curve shape — identical across all models.
        """
        return _AGNOSTIC_IDX[np.asarray(app_idx)]

    # -- drift ---------------------------------------------------------------

    def update(self, app_idx, params) -> tuple[int, int]:
        """Recalibrate: replace the ``[M, γ, H]`` rows of ``app_idx`` (also
        re-anchoring their nominal), bump ``version``, return the new
        :attr:`signature`."""
        if not self._mutable:
            raise ValueError(
                "immutable SemanticModel (DEFAULT_MODEL is shared paper "
                "truth); drift a copy from SemanticModel.paper_default()")
        app_idx = np.atleast_1d(np.asarray(app_idx, np.int64))
        rows = np.asarray(params, np.float64).reshape(len(app_idx), 3)
        self._validate(rows)
        self.params[app_idx] = rows
        self._nominal[app_idx] = rows
        self._changed.append(frozenset(int(i) for i in app_idx))
        self.version += 1
        return self.signature

    def scale_asymptotes(self, app_idx=None, scale: float = 1.0
                         ) -> tuple[int, int]:
        """Transient recalibration: set M = scale · nominal-M for ``app_idx``
        (all apps when None). Applied against the *nominal* curves so stepped
        / composed schedules set absolute levels instead of compounding —
        same convention as link ``scale`` in the fault plane. ``scale = 1``
        restores the nominal curve. Bumps ``version``."""
        if not self._mutable:
            raise ValueError(
                "immutable SemanticModel (DEFAULT_MODEL is shared paper "
                "truth); drift a copy from SemanticModel.paper_default()")
        if not (np.isfinite(scale) and scale > 0.0):
            raise ValueError(f"scale must be finite and > 0, got {scale}")
        idx = (np.arange(self.n_apps) if app_idx is None
               else np.atleast_1d(np.asarray(app_idx, np.int64)))
        self.params[idx, 0] = self._nominal[idx, 0] * float(scale)
        self._changed.append(frozenset(int(i) for i in idx))
        self.version += 1
        return self.signature

    def changed_since(self, version: int) -> frozenset[int]:
        """Union of app indices whose curves moved after ``version`` — the
        delta the serving session turns into dirty-row scatters."""
        if version >= self.version:
            return frozenset()
        return frozenset().union(*self._changed[version:])

    def snapshot(self) -> "SemanticModel":
        """Immutable value copy sharing this model's signature — what a
        double-buffered dispatch captures so in-flight unpacks don't see
        curves that moved after the solve was issued."""
        snap = SemanticModel(self.params)
        snap._uid, snap.version = self._uid, self.version
        snap._mutable = False
        return snap

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SemanticModel(uid={self._uid}, version={self.version}, "
                f"n_apps={self.n_apps}, mutable={self._mutable})")


#: The paper calibration, immutable and shared — every API that takes an
#: optional model defaults to it, which is why a model-free call today is
#: decision-for-decision identical to the pre-refactor module globals.
DEFAULT_MODEL = SemanticModel(_PARAMS, mutable=False)


def resolve(model: SemanticModel | None) -> SemanticModel:
    """``model or DEFAULT_MODEL`` with a type check — the single normalization
    point for every ``model=None`` default across the stack."""
    if model is None:
        return DEFAULT_MODEL
    if not isinstance(model, SemanticModel):
        raise TypeError(f"expected SemanticModel or None, got {type(model)!r}")
    return model


# --- module-level delegates (the original public API, unchanged) -------------

def accuracy(app_idx, z):
    """a(z) under the paper calibration — delegates to ``DEFAULT_MODEL``."""
    return DEFAULT_MODEL.accuracy(app_idx, z)


def accuracy_table(app_idx: np.ndarray, z_grid: np.ndarray) -> np.ndarray:
    """(T, Z) table of a_τ(z) — delegates to ``DEFAULT_MODEL``."""
    return DEFAULT_MODEL.accuracy_table(app_idx, z_grid)


def warm_start_accuracy(app_idx: int, z: float) -> float:
    """Handover warm-start pin — delegates to ``DEFAULT_MODEL``."""
    return DEFAULT_MODEL.warm_start_accuracy(app_idx, z)


def min_z_for_accuracy(app_idx: np.ndarray, min_acc: np.ndarray,
                       z_grid: np.ndarray) -> np.ndarray:
    """Eq. (2) z* index — delegates to ``DEFAULT_MODEL``."""
    return DEFAULT_MODEL.min_z_for_accuracy(app_idx, min_acc, z_grid)


def agnostic_app(app_idx: np.ndarray) -> np.ndarray:
    """Service-wide 'All' fallback — delegates to ``DEFAULT_MODEL``."""
    return DEFAULT_MODEL.agnostic_app(app_idx)
