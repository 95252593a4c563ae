"""Host and device data handling: preprocessing, augmentation, the training pipeline."""
