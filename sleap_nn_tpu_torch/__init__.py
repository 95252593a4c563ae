"""PyTorch + CUDA port of ``sleap_nn_tpu`` for NVIDIA Hopper (H100).

The JAX package is the reference: this package mirrors its module paths
and public names (``sleap_nn_tpu/x/y.py`` -> ``sleap_nn_tpu_torch/x/y.py``)
and keeps its layouts at public functions (NHWC maps, ``(x, y)`` points,
the same output dict keys and NaN / -1 / 0 padding of invalid slots).

Each Pallas kernel of the JAX package has a hand-written CUDA C++
counterpart in ``csrc/``, built with nvcc at first use (``ops/_build.py``)
and launched for CUDA tensors; CPU tensors take the kernel's plain
PyTorch version.

The bottom-up grouping's host loop is C++ (``native/paf_group.cpp``, a
copy of the JAX package's), built with g++ at first use and loaded with
ctypes; scipy runs it where no compiler builds the library.

It imports torch, numpy, scipy and the standard library (PyYAML and cv2
only inside the functions that read or write YAML or decode video);
``.slp`` and analysis HDF5 files go through its own HDF5 subset
(``io/hdf5.py``), so it needs no h5py. A JAX trainer's orbax
checkpoints are converted by ``tools/orbax_to_torch.py`` outside the
package. Ported: everything the JAX package does but its JAX- and
TPU-only parts (ROADMAP.md lists them): training of the pose, identity
and segmentation models from in-memory labels or ``.slp`` files into a
model directory, with the post-training evaluation
(``train.run_training``, ``train.train``), inference from model or
export directories to ``Labels``, ``.slp`` and analysis files, from a
local path or a ``file://`` or ``http(s)://`` URL, tracking, evaluation,
SAM prompted masks, export, and the command line over them (``cli.py``:
``python -m sleap_nn_tpu_torch.cli``).

The top-level names ``predict``, ``Predictor`` and ``load_models`` are
imported on first use, so ``import sleap_nn_tpu_torch`` imports no torch.
"""

import os
import sys

__version__ = "0.1.0"

# This process's rank in a multi-process run, from the launcher's LOCAL_RANK.
RANK = int(os.environ.get("LOCAL_RANK", 0))

__all__ = ["RANK", "Predictor", "__version__", "load_models", "predict",
           "process_rank"]


def process_rank() -> int:
    """The rank in the initialised process group, else :data:`RANK`."""
    # No process group exists before torch is imported; this stays cheap.
    torch = sys.modules.get("torch")
    if torch is not None and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return RANK


def load_models(model_paths, **kwargs):
    """A :class:`Predictor` of trained model dir(s): forwards to
    ``Predictor.from_model_paths`` (on the card unless ``device="cpu"``)."""
    from sleap_nn_tpu_torch.inference import Predictor as _Predictor

    return _Predictor.from_model_paths(model_paths, **kwargs)


def __getattr__(name: str):
    if name == "predict":
        from sleap_nn_tpu_torch.inference import predict as _predict

        return _predict
    if name == "Predictor":
        from sleap_nn_tpu_torch.inference import Predictor as _Predictor

        return _Predictor
    raise AttributeError(f"module 'sleap_nn_tpu_torch' has no attribute {name!r}")
