"""PyTorch + CUDA port of ``sleap_nn_tpu`` for NVIDIA Hopper (H100).

The JAX package is the reference: this package mirrors its module paths
and public names (``sleap_nn_tpu/x/y.py`` -> ``sleap_nn_tpu_torch/x/y.py``)
and keeps its layouts at public functions (NHWC maps, ``(x, y)`` points,
the same output dict keys and NaN / -1 / 0 padding of invalid slots).

It imports torch, numpy and the standard library only. Each Pallas kernel
of the JAX package that the ported path runs has a hand-written CUDA C++
counterpart in ``csrc/``, built with nvcc at first use (``ops/_build.py``)
and launched for CUDA tensors; CPU tensors take the kernel's plain PyTorch
version.

Ported so far: top-down inference (UNet centroid + centered-instance
models, ``inference.predictor.Predictor.predict`` with
``make_labels=False``).
"""

__version__ = "0.1.0"
