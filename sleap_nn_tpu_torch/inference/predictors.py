"""The legacy ``*Predictor`` classes, kept for scripts written against them.

Port of ``sleap_nn_tpu/inference/predictors.py``: each ``from_trained_models``
class method, and the legacy ``Predictor.from_model_paths`` dispatcher,
warns with a ``DeprecationWarning`` that names the port's
``Predictor.from_model_paths``, then forwards to it.
:func:`legacy_predictor_internal_use` silences the warning for deliberate
internal calls.
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Optional

from sleap_nn_tpu_torch.inference.predictor import Predictor as _NewPredictor

_LEGACY_INTERNAL_USE = threading.local()

# The legacy keyword arguments the new factory takes under the same name;
# the others (a preprocessing config, which each model dir has) are
# accepted and ignored. ``device`` picks the card or the CPU, as there.
_FORWARDED = {
    "peak_threshold", "integral_patch_size", "batch_size", "max_instances",
    "return_confmaps", "backbone_ckpt_path", "head_ckpt_path", "anchor_part",
    "max_peaks", "crop_size",
    "min_line_scores", "k_per_node", "n_points", "max_edge_length_ratio",
    "dist_penalty_weight", "min_instance_peaks", "return_paf_graph",
    "device",
}


@contextlib.contextmanager
def legacy_predictor_internal_use():
    """Silence the legacy entries' ``DeprecationWarning`` inside the block."""
    prev = getattr(_LEGACY_INTERNAL_USE, "active", False)
    _LEGACY_INTERNAL_USE.active = True
    try:
        yield
    finally:
        _LEGACY_INTERNAL_USE.active = prev


def _warn_deprecated(entry: str):
    if getattr(_LEGACY_INTERNAL_USE, "active", False):
        return
    warnings.warn(
        f"{entry} is deprecated and will be removed in a future release; "
        "use sleap_nn_tpu_torch.inference.predictor.Predictor.from_model_paths instead.",
        DeprecationWarning,
        stacklevel=3,
    )


def _forward(model_paths, kwargs):
    """Build the new predictor from the legacy keyword arguments
    (``integral_refinement`` is the new ``refinement``)."""
    mapped = {k: v for k, v in kwargs.items() if k in _FORWARDED}
    if "integral_refinement" in kwargs:
        mapped["refinement"] = kwargs["integral_refinement"]
    return _NewPredictor.from_model_paths([str(p) for p in model_paths], **mapped)


class Predictor:
    """The legacy dispatcher. Deprecated."""

    @classmethod
    def from_model_paths(cls, model_paths, **kwargs):
        _warn_deprecated("sleap_nn_tpu_torch.inference.predictors.Predictor.from_model_paths")
        return _forward(model_paths, kwargs)


class SingleInstancePredictor(Predictor):
    """Legacy single-instance predictor. Deprecated."""

    @classmethod
    def from_trained_models(cls, confmap_ckpt_path: Optional[str] = None, **kwargs):
        _warn_deprecated(f"{cls.__name__}.from_trained_models")
        return _forward([confmap_ckpt_path], kwargs)


class TopDownPredictor(Predictor):
    """Legacy top-down predictor (centroid + centered-instance). Deprecated."""

    @classmethod
    def from_trained_models(cls, centroid_ckpt_path: Optional[str] = None,
                            confmap_ckpt_path: Optional[str] = None, **kwargs):
        _warn_deprecated(f"{cls.__name__}.from_trained_models")
        return _forward([p for p in (centroid_ckpt_path, confmap_ckpt_path) if p], kwargs)


class BottomUpPredictor(Predictor):
    """Legacy bottom-up predictor. Deprecated."""

    @classmethod
    def from_trained_models(cls, bottomup_ckpt_path: Optional[str] = None, **kwargs):
        _warn_deprecated(f"{cls.__name__}.from_trained_models")
        return _forward([bottomup_ckpt_path], kwargs)


class BottomUpMultiClassPredictor(Predictor):
    """Legacy multi-class bottom-up predictor. Deprecated."""

    @classmethod
    def from_trained_models(cls, bottomup_ckpt_path: Optional[str] = None, **kwargs):
        _warn_deprecated(f"{cls.__name__}.from_trained_models")
        return _forward([bottomup_ckpt_path], kwargs)


class TopDownMultiClassPredictor(Predictor):
    """Legacy multi-class top-down predictor. Deprecated."""

    @classmethod
    def from_trained_models(cls, centroid_ckpt_path: Optional[str] = None,
                            confmap_ckpt_path: Optional[str] = None, **kwargs):
        _warn_deprecated(f"{cls.__name__}.from_trained_models")
        return _forward([p for p in (centroid_ckpt_path, confmap_ckpt_path) if p], kwargs)
