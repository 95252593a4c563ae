"""Frame-by-frame identity tracking (host numpy and scipy).

Port of ``sleap_nn_tpu/tracking/``: feature extraction (keypoints,
centroids, bounding boxes), OKS / IoU / cosine / euclidean scoring,
Hungarian and greedy assignment, fixed-window and local-queue candidates,
optical-flow shifting (cv2, imported when a flow tracker runs) and Kalman
prediction.
"""

from sleap_nn_tpu_torch.tracking.tracker import (
    FlowShiftTracker,
    KalmanShiftTracker,
    Tracker,
    connect_single_breaks,
    run_tracker,
)

__all__ = [
    "Tracker",
    "FlowShiftTracker",
    "KalmanShiftTracker",
    "run_tracker",
    "connect_single_breaks",
]
