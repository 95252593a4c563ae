"""PyTorch + CUDA port of ``sleap_nn_tpu`` for NVIDIA Hopper (H100).

The JAX package is the reference: this package mirrors its module paths
and public names (``sleap_nn_tpu/x/y.py`` -> ``sleap_nn_tpu_torch/x/y.py``)
and keeps its layouts at public functions (NHWC maps, ``(x, y)`` points,
the same output dict keys and NaN / -1 / 0 padding of invalid slots).

Each Pallas kernel of the JAX package has a hand-written CUDA C++
counterpart in ``csrc/``, built with nvcc at first use (``ops/_build.py``)
and launched for CUDA tensors; CPU tensors take the kernel's plain
PyTorch version.

It imports torch, numpy, scipy and the standard library (PyYAML and h5py
only inside the functions that read or write YAML or ``.slp`` files); a
JAX trainer's orbax checkpoints are converted by ``tools/orbax_to_torch.py``
outside the package. Ported so far: training of the
single-instance, centroid, centered-instance and bottom-up models on
in-memory labels into a model directory (``train.run_training``), and
inference from model directories (``inference.run.predict``,
``Predictor.from_model_paths``) to ``Labels`` and ``.slp`` files.
"""

__version__ = "0.1.0"
