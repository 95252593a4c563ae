"""Port parity: the legacy ``*Predictor`` classes
(``inference/predictors.py``).

Each ``from_trained_models`` class method, and the legacy dispatcher's
``from_model_paths``, warns once with the JAX package's
``DeprecationWarning`` text (naming the port's ``Predictor``), then
forwards to the port's ``Predictor.from_model_paths``: the same layer type,
knobs and ``Labels`` on the same dirs. ``legacy_predictor_internal_use``
silences the warning.
"""

import warnings

import numpy as np
import pytest

from sleap_nn_tpu.inference import predictors as jshim
from sleap_nn_tpu_torch.inference import predictors as shim
from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.io import model as pio
from tests.test_torch_data_parallel import dirs  # noqa: F401  (the module's dir fixture)
from tests.test_torch_model_dir import FrameVideo
from tests.test_torch_topdown import blob_frames
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

CLASSES = {  # class -> (its path keywords by model type, the type set it builds)
    "SingleInstancePredictor": ({"confmap_ckpt_path": "single_instance"}, "single_instance"),
    "TopDownPredictor": ({"centroid_ckpt_path": "centroid",
                          "confmap_ckpt_path": "centered_instance"}, "topdown"),
    "BottomUpPredictor": ({"bottomup_ckpt_path": "bottomup"}, "bottomup"),
    "BottomUpMultiClassPredictor": ({"bottomup_ckpt_path": "multi_class_bottomup"},
                                    "multi_class_bottomup"),
    "TopDownMultiClassPredictor": ({"centroid_ckpt_path": "centroid"}, "centroid"),
}


def _warned(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [w for w in caught if issubclass(w.category, DeprecationWarning)]


def _labels(n=6):
    frames = blob_frames(n, seed=9)
    return pio.Labels([pio.LabeledFrame(FrameVideo(frames), i) for i in range(n)])


@pytest.mark.parametrize("name", CLASSES)
def test_each_class_warns_once_and_forwards(dirs, name):  # noqa: F811
    paths, model_type = CLASSES[name]
    kwargs = {k: str(getattr(dirs, v)) for k, v in paths.items()}
    knobs = dict(peak_threshold=0.1, batch_size=4, max_instances=5, integral_refinement=None,
                 device="cpu", preprocess_config={"ignored": True})
    if model_type == "bottomup":
        knobs.update(min_line_scores=-0.5, k_per_node=10)
    got, deps = _warned(getattr(shim, name).from_trained_models, **kwargs, **knobs)
    assert len(deps) == 1
    assert str(deps[0].message) == (
        f"{name}.from_trained_models is deprecated and will be removed in a future release; "
        "use sleap_nn_tpu_torch.inference.predictor.Predictor.from_model_paths instead.")
    # The JAX shim's message but for the package it names.
    _, jdeps = _warned(lambda: pytest.raises(Exception, getattr(jshim, name).from_trained_models,
                                             **{k: "/nonexistent" for k in kwargs}))
    assert str(jdeps[0].message).replace("sleap_nn_tpu.inference.Predictor",
                                         "sleap_nn_tpu_torch.inference.predictor.Predictor") \
        == str(deps[0].message)
    assert isinstance(got, Predictor) and got.model_type == model_type
    assert got.device.type == "cpu" and got.batch_size == 4
    post = getattr(got.layer, "centroid_layer", got.layer).post
    assert post.peak_threshold == 0.1 and post.refinement is None
    plain = Predictor.from_model_paths(list(kwargs.values()), peak_threshold=0.1, batch_size=4,
                                       max_instances=5, refinement=None, device="cpu",
                                       **{k: v for k, v in knobs.items()
                                          if k in ("min_line_scores", "k_per_node")})
    src = _labels()
    a, b = got.predict(src), plain.predict(src)
    assert [lf.frame_idx for lf in a] == [lf.frame_idx for lf in b]
    for fa, fb in zip(a, b):
        assert len(fa.instances) == len(fb.instances)
        for ia, ib in zip(fa.instances, fb.instances):
            np.testing.assert_array_equal(ia.numpy(), ib.numpy())


def test_dispatcher_warns_and_internal_use_silences(dirs):  # noqa: F811
    path = [str(dirs.single_instance)]
    got, deps = _warned(shim.Predictor.from_model_paths, path, device="cpu")
    assert len(deps) == 1 and "Predictor.from_model_paths" in str(deps[0].message)
    assert "removed in a future release" in str(deps[0].message)
    assert isinstance(got, Predictor)
    with shim.legacy_predictor_internal_use():
        _, deps = _warned(shim.SingleInstancePredictor.from_trained_models,
                          confmap_ckpt_path=path[0], device="cpu")
        with shim.legacy_predictor_internal_use():
            pass
        _, deps_inner = _warned(shim.Predictor.from_model_paths, path, device="cpu")
    assert deps == [] and deps_inner == []
    _, deps = _warned(shim.SingleInstancePredictor.from_trained_models,
                      confmap_ckpt_path=path[0], device="cpu")
    assert len(deps) == 1


def test_missing_dir_warns_then_fails_like_jax():
    for module in (shim, jshim):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with pytest.raises(Exception):
                module.BottomUpPredictor.from_trained_models(bottomup_ckpt_path="/nonexistent")
        assert [w.category for w in caught].count(DeprecationWarning) == 1
