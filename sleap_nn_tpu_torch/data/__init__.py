"""Host and device data handling for inference."""
