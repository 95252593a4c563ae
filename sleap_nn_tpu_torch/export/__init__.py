"""Model export: one serialized uint8-in, outputs-out program.

Port of ``sleap_nn_tpu/export``. The artifact is a ``torch.export``
program (``model.pt2``) whose graph holds the uint8 normalization, the
forward and the peak finding, with ``metadata.json`` and a numeric
verification of the loaded program against the untraced wrapper. Importing
this package registers the kernels' operators (``ops/library.py``), which
a loaded program calls.
"""

from sleap_nn_tpu_torch.export.exporter import (
    ExportMetadata,
    export_model,
    load_exported_model,
    verify_export_numerics,
)

__all__ = [
    "export_model",
    "load_exported_model",
    "verify_export_numerics",
    "ExportMetadata",
]
