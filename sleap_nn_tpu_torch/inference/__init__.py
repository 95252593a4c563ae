"""Inference: backend, layers, providers and predictor of the top-down path."""
