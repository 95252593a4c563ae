"""Identity classification: peak -> class assignment (host numpy and scipy).

Port of ``sleap_nn_tpu/inference/identity.py``, copied: Hungarian matching
of peaks to classes per (sample, node) from class-map probabilities, and of
instances to classes from class vectors. The matrices are small, so this
runs on the host, on the fixed-size peak arrays the device peak finder
returns. ``BottomUpMultiClassLayer`` gathers each peak's class
probabilities on the device and hands them to :func:`group_and_assemble`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def group_class_peaks(
    peak_class_probs: np.ndarray,
    peak_sample_inds: np.ndarray,
    peak_channel_inds: np.ndarray,
    n_samples: int,
    n_channels: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Hungarian-match peaks to classes per (sample, channel); keep the
    assignments whose class is the peak's best. Returns ``(peak_inds,
    class_inds)``."""
    peak_inds_list, class_inds_list = [], []
    for sample in range(n_samples):
        for channel in range(n_channels):
            mask = (peak_sample_inds == sample) & (peak_channel_inds == channel)
            if not mask.any():
                continue
            rows, cols = linear_sum_assignment(-peak_class_probs[mask])
            peak_inds_list.append(np.nonzero(mask)[0][rows])
            class_inds_list.append(cols)
    if not peak_inds_list:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    peak_inds = np.concatenate(peak_inds_list)
    class_inds = np.concatenate(class_inds_list)
    matched = peak_class_probs[peak_inds, class_inds]
    keep = matched == peak_class_probs[peak_inds].max(axis=1)
    return peak_inds[keep], class_inds[keep]


def classify_peaks_from_maps(
    class_maps: np.ndarray,
    peak_points: np.ndarray,
    peak_vals: np.ndarray,
    peak_sample_inds: np.ndarray,
    peak_channel_inds: np.ndarray,
    n_channels: int,
    sort_keys: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group peaks into per-class instances through class maps.

    Args:
        class_maps: ``(n_samples, H, W, n_classes)``.
        peak_points: ``(n_peaks, 2)`` (x, y) in class-map grid coordinates;
            each peak reads the map at its rounded (half to even), clipped
            position.
        peak_vals / peak_sample_inds / peak_channel_inds: ``(n_peaks,)``.
        sort_keys: ``(n_peaks, 2)`` unrefined peak positions that order the
            peaks (see :func:`group_and_assemble`); default ``peak_points``.

    Returns:
        ``(points (S, n_classes, n_channels, 2), point_vals, class_probs)``,
        NaN where no peak was assigned.
    """
    n_samples, h, w, n_classes = class_maps.shape
    xy = np.round(peak_points).astype(int)
    cols = np.clip(xy[:, 0], 0, w - 1)
    rows = np.clip(xy[:, 1], 0, h - 1)
    return group_and_assemble(
        peak_points, peak_vals, peak_sample_inds, peak_channel_inds,
        class_maps[peak_sample_inds, rows, cols, :], n_samples, n_classes, n_channels,
        sort_keys=sort_keys,
    )


def group_and_assemble(
    peak_points: np.ndarray,
    peak_vals: np.ndarray,
    peak_sample_inds: np.ndarray,
    peak_channel_inds: np.ndarray,
    peak_class_probs: np.ndarray,
    n_samples: int,
    n_classes: int,
    n_channels: int,
    sort_keys: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hungarian-group gathered per-peak class probabilities
    (``(n_peaks, n_classes)``) into instances.

    The peaks are first put in the reference's scan order, (sample,
    channel, rounded y, rounded x) of ``sort_keys``: the Hungarian match
    breaks ties by row order, so the same order gives the same assignment
    on tied class probabilities.
    """
    keys = peak_points if sort_keys is None else sort_keys
    order = np.lexsort((np.round(keys[:, 0]), np.round(keys[:, 1]),
                        peak_channel_inds, peak_sample_inds))
    peak_points = peak_points[order]
    peak_vals = peak_vals[order]
    peak_sample_inds = peak_sample_inds[order]
    peak_channel_inds = peak_channel_inds[order]
    peak_class_probs = peak_class_probs[order]

    peak_inds, class_inds = group_class_peaks(
        peak_class_probs, peak_sample_inds, peak_channel_inds, n_samples, n_channels)

    points = np.full((n_samples, n_classes, n_channels, 2), np.nan, dtype=np.float32)
    point_vals = np.full((n_samples, n_classes, n_channels), np.nan, dtype=np.float32)
    class_probs = np.full((n_samples, n_classes, n_channels), np.nan, dtype=np.float32)
    s = peak_sample_inds[peak_inds]
    c = peak_channel_inds[peak_inds]
    points[s, class_inds, c] = peak_points[peak_inds]
    point_vals[s, class_inds, c] = peak_vals[peak_inds]
    class_probs[s, class_inds, c] = peak_class_probs[peak_inds, class_inds]
    return points, point_vals, class_probs


def get_class_inds_from_vectors(peak_class_probs: np.ndarray):
    """Give each row (instance) a distinct class by Hungarian matching on
    its class vector (NaN counts as 0). Returns ``(class_inds, class_probs)``:
    -1 and NaN for rows left without a class."""
    n_samples = peak_class_probs.shape[0]
    rows, cols = linear_sum_assignment(-np.nan_to_num(peak_class_probs))
    class_inds = np.full((n_samples,), -1, dtype=np.int64)
    class_probs = np.full((n_samples,), np.nan, dtype=np.float32)
    class_inds[rows] = cols
    class_probs[rows] = peak_class_probs[rows, cols]
    return class_inds, class_probs
