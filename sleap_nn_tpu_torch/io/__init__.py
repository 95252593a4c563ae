"""Labels and video I/O: the labels data model, ``.slp`` read / write and
the embedded-frame video backend (h5py is imported by the reads and writes
only)."""

from sleap_nn_tpu_torch.io.model import (
    Edge,
    Instance,
    LabeledFrame,
    Labels,
    Node,
    PredictedCentroid,
    PredictedInstance,
    PredictedROI,
    Skeleton,
    SuggestionFrame,
    Symmetry,
    Track,
    UserCentroid,
    is_negative_frame,
)
from sleap_nn_tpu_torch.io.slp import load_slp, save_slp
from sleap_nn_tpu_torch.io.video import Video

__all__ = [
    "Edge", "Instance", "LabeledFrame", "Labels", "Node", "PredictedCentroid",
    "PredictedInstance", "PredictedROI", "Skeleton", "SuggestionFrame", "Symmetry", "Track",
    "UserCentroid", "Video", "is_negative_frame", "load_slp", "save_slp",
]


def load_file(path):
    """Load a labels file (``.slp``)."""
    return load_slp(path)
