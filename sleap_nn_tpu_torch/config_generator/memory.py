"""Memory estimate of a UNet training config.

Port of ``sleap_nn_tpu/config_generator/memory.py``: an analytic model of
the parameters, Adam's two moments and the kept activations, in GB.
"""

from __future__ import annotations

import dataclasses

from sleap_nn_tpu_torch.config_generator.architecture_estimates import (
    decoder_blocks,
    encoder_blocks,
    estimate_unet_params,
)


@dataclasses.dataclass
class MemoryEstimate:
    """Estimated memory footprint in GB (reference: memory.py:16)."""

    params_gb: float = 0.0
    activations_gb: float = 0.0
    optimizer_gb: float = 0.0
    cache_bytes: int = 0
    batch_size: int = 4

    @property
    def total_device_gb(self) -> float:
        return self.params_gb + self.activations_gb + self.optimizer_gb

    # Back-compat name from the reference (GPU -> device).
    @property
    def total_gpu_gb(self) -> float:
        return self.total_device_gb

    @property
    def cache_memory_gb(self) -> float:
        return self.cache_bytes / 1e9

    def __str__(self) -> str:
        return (
            f"device={self.total_device_gb:.2f} GB "
            f"(params {self.params_gb:.3f} + act {self.activations_gb:.2f} + "
            f"opt {self.optimizer_gb:.3f}), cache={self.cache_memory_gb:.2f} GB"
        )


def estimate_memory(
    height: int,
    width: int,
    channels: int = 1,
    batch_size: int = 4,
    filters: int = 32,
    filters_rate: float = 1.5,
    max_stride: int = 16,
    output_stride: int = 2,
    scale: float = 1.0,
    n_heads_channels: int = 2,
    num_frames: int = 0,
    bytes_per_value: int = 4,
) -> MemoryEstimate:
    """Estimate params/activations/optimizer/cache memory (reference: :101)."""
    n_params = estimate_unet_params(
        filters=filters,
        filters_rate=filters_rate,
        max_stride=max_stride,
        output_stride=output_stride,
        in_channels=channels,
        head_channels=n_heads_channels,
    )
    params_gb = n_params * bytes_per_value / 1e9
    optimizer_gb = 2 * params_gb  # Adam: m + v

    h, w = int(height * scale), int(width * scale)
    act_values = 0
    down = encoder_blocks(max_stride)
    hh, ww = h, w
    for block in range(down):
        f = int(filters * (filters_rate**block))
        act_values += 2 * hh * ww * f  # convs_per_block=2 activations kept for bwd
        hh, ww = hh // 2, ww // 2
    up = decoder_blocks(max_stride, output_stride)
    for block in range(up):
        hh, ww = hh * 2, ww * 2
        f = int(filters * (filters_rate ** max(0, down - 1 - block)))
        act_values += 2 * hh * ww * f
    activations_gb = batch_size * act_values * bytes_per_value / 1e9

    cache_bytes = num_frames * height * width * channels  # uint8 decoded cache
    return MemoryEstimate(
        params_gb=params_gb,
        activations_gb=activations_gb,
        optimizer_gb=optimizer_gb,
        cache_bytes=cache_bytes,
        batch_size=batch_size,
    )
