"""PyTorch + CUDA port of ``sleap_nn_tpu`` for NVIDIA Hopper (H100).

The JAX package is the reference: this package mirrors its module paths
and public names (``sleap_nn_tpu/x/y.py`` -> ``sleap_nn_tpu_torch/x/y.py``)
and keeps its layouts at public functions (NHWC maps, ``(x, y)`` points,
the same output dict keys and NaN / -1 / 0 padding of invalid slots).

It imports torch, numpy, scipy and the standard library (PyYAML only
inside the functions that read or write YAML). Each Pallas kernel of the
JAX package has a hand-written CUDA C++ counterpart in ``csrc/``, built
with nvcc at first use (``ops/_build.py``) and launched for CUDA tensors;
CPU tensors take the kernel's plain PyTorch version.

Ported so far: top-down and bottom-up inference
(``inference.predictor.Predictor.predict`` with ``make_labels=False``)
and centroid-model training (``training.ModelTrainer``,
``train.run_training``) on in-memory labels.
"""

__version__ = "0.1.0"
