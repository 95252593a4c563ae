"""In-memory labels data model (the ``.slp`` reader and writer are not ported yet)."""

from sleap_nn_tpu_torch.io.model import (
    Edge,
    Instance,
    LabeledFrame,
    Labels,
    Node,
    PredictedCentroid,
    PredictedInstance,
    Skeleton,
    Symmetry,
    Track,
    UserCentroid,
    is_negative_frame,
)

__all__ = [
    "Edge", "Instance", "LabeledFrame", "Labels", "Node", "PredictedCentroid",
    "PredictedInstance", "Skeleton", "Symmetry", "Track", "UserCentroid", "is_negative_frame",
]
