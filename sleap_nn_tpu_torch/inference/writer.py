"""Incremental labels writer.

Port of ``sleap_nn_tpu/inference/writer.py`` (``IncrementalLabelsWriter``):
buffer predicted frames, periodically flush to a temp ``.slp`` so long
runs survive interruption, atomically finalize. Each flush writes
through ``save_slp``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels
from sleap_nn_tpu_torch.io.slp import save_slp


class IncrementalLabelsWriter:
    """Buffered .slp writer with periodic temp-file flushes."""

    def __init__(self, output_path, flush_every: int = 256, provenance: Optional[dict] = None):
        self.output_path = Path(output_path)
        self.tmp_path = self.output_path.with_suffix(".tmp.slp")
        self.flush_every = flush_every
        self.frames: List[LabeledFrame] = []
        self.provenance = provenance or {}
        self._since_flush = 0
        self._finalized = False

    def add_frames(self, frames: List[LabeledFrame]):
        self.frames.extend(frames)
        self._since_flush += len(frames)
        if self._since_flush >= self.flush_every:
            self.flush()

    def _build_labels(self) -> Labels:
        labels = Labels(labeled_frames=list(self.frames))
        labels.provenance = dict(self.provenance)
        return labels

    def flush(self):
        """Write the buffered frames to the temp path (crash recovery)."""
        save_slp(self.tmp_path, self._build_labels())
        self._since_flush = 0

    def finalize(self) -> Labels:
        """Write the final file atomically and clean up the temp."""
        labels = self._build_labels()
        save_slp(self.tmp_path, labels)
        os.replace(self.tmp_path, self.output_path)
        self._finalized = True
        return labels

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and not self._finalized:
            self.finalize()
        return False
