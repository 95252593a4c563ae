"""Ported model definitions (UNet backbone, confidence-map heads)."""
