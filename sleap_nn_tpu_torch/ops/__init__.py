"""Ops of the port: peaks, crops, grids and the hand-written CUDA kernels.

The public names are the JAX package's, imported on first use, so
``import sleap_nn_tpu_torch.ops`` imports no torch and builds no kernel.
"""

from sleap_nn_tpu_torch._lazy import reexports

__all__, __getattr__, __dir__ = reexports(__name__, {
    "grid": ("gaussian_pdf", "make_grid_vectors"),
    "confmaps": ("make_confmaps", "make_multi_confmaps"),
    "edge_maps": ("distance_to_edge", "get_edge_points", "make_edge_maps", "make_multi_pafs",
                  "make_pafs"),
    "peaks": ("find_global_peaks", "find_global_peaks_rough", "find_local_peaks",
              "find_local_peaks_rough", "integral_regression", "nms_max_pool"),
    "crops": ("crop_bboxes", "make_centered_bboxes"),
})
