"""Inference: backends, layers, providers, the predictor and ``predict``."""

from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.inference.run import predict

__all__ = ["Predictor", "predict"]
