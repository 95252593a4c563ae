"""Training of the ported models: single-instance, centroid, centered-instance
and bottom-up."""

from sleap_nn_tpu_torch.training.model_trainer import ModelTrainer, xavier_init_params

__all__ = ["ModelTrainer", "xavier_init_params"]
