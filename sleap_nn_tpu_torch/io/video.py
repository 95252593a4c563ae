"""Videos: a filename plus a backend that reads frames.

Port of ``Video`` and ``HDF5VideoBackend`` of ``sleap_nn_tpu/io/video.py``:
what ``load_slp`` needs for frames embedded in a ``.slp`` / HDF5 file
(PNG bytes, decoded by ``io/png.py``, or raw arrays, with the
``frame_numbers`` map of the embedding group). h5py is imported by the
backend's reads only. The media-file and image-sequence backends
(``MediaVideoBackend``, ``ImageVideoBackend``) read through cv2 and are not
ported (ROADMAP.md section 1, item 3): a ``Video`` of such a file raises
``NotImplementedError`` when it is opened. Any object with
``get_frame(idx)``, ``num_frames`` and ``shape`` serves as a backend, so an
in-memory ``Video`` takes an array-backed one.

Frames come back as ``uint8 (H, W, C)``, C in {1, 3}.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from sleap_nn_tpu_torch.io.png import decode_png

_UNPORTED_MEDIA = ("reading {} needs the media / image video backends, which use cv2 and are "
                   "not ported (ROADMAP.md section 1, item 3)")


def rgb_to_gray_uint8(frames: np.ndarray) -> np.ndarray:
    """ITU-601 luma on uint8 RGB, ``(..., 3)`` -> ``(..., 1)``.

    Bit-identical to ``cv2.cvtColor(..., COLOR_RGB2GRAY)``, which the JAX
    package calls: 15-bit fixed-point weights, rounded half up.
    """
    f = frames.astype(np.uint32)
    luma = (f[..., 0] * 9798 + f[..., 1] * 19235 + f[..., 2] * 3735 + (1 << 14)) >> 15
    return luma.astype(np.uint8)[..., None]


class HDF5VideoBackend:
    """Frames embedded in an HDF5 file (the ``.pkg.slp`` convention).

    The dataset holds either raw arrays or encoded image bytes; an adjacent
    ``frame_numbers`` dataset maps source-video frame indices to rows.
    """

    def __init__(self, filename: str, dataset: str, input_format: str = "channels_last"):
        self.filename = str(filename)
        self.dataset = dataset
        self.input_format = input_format
        self._local = threading.local()
        self._frame_map = None  # frame_idx -> row
        self._attrs = None

    def _file(self):
        import h5py

        f = getattr(self._local, "f", None)
        if f is None:
            f = h5py.File(self.filename, "r")
            self._local.f = f
        return f

    def _load_meta(self):
        if self._attrs is not None:
            return
        f = self._file()
        ds = f[self.dataset]
        self._attrs = dict(ds.attrs)
        grp = self.dataset.rsplit("/", 1)[0] if "/" in self.dataset else ""
        fn_path = f"{grp}/frame_numbers" if grp else "frame_numbers"
        if fn_path in f:
            self._frame_map = {int(n): i for i, n in enumerate(f[fn_path][:])}
        else:
            self._frame_map = {i: i for i in range(ds.shape[0])}

    @property
    def num_frames(self) -> int:
        self._load_meta()
        return len(self._frame_map)

    @property
    def frame_numbers(self) -> List[int]:
        self._load_meta()
        return sorted(self._frame_map)

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        self._load_meta()
        a = self._attrs
        if {"height", "width", "channels"} <= set(a):
            return (self.num_frames, int(a["height"]), int(a["width"]), int(a["channels"]))
        img = self.get_frame(self.frame_numbers[0])
        return (self.num_frames,) + img.shape

    def get_frame(self, idx: int, fmt: Optional[str] = None) -> np.ndarray:
        self._load_meta()
        ds = self._file()[self.dataset]
        row = self._frame_map.get(int(idx))
        if row is None:
            raise IndexError(f"Frame {idx} is not embedded in {self.filename}:{self.dataset}")
        data = ds[row]
        enc = self._attrs.get("format", "")
        if isinstance(enc, bytes):
            enc = enc.decode()
        if enc in ("jpg", "jpeg"):
            raise NotImplementedError(
                "decoding JPEG-embedded frames needs cv2, which the port does not use "
                "(ROADMAP.md section 1, item 3)")
        if ds.dtype == object or enc == "png":
            img = decode_png(np.asarray(data).tobytes())
        else:
            img = np.asarray(data)
            if self.input_format == "channels_first" and img.ndim == 3:
                img = np.moveaxis(img, 0, -1)
            if img.ndim == 2:
                img = img[..., None]
        if (fmt == "gray" or int(self._attrs.get("channels", img.shape[-1])) == 1) \
                and img.shape[-1] == 3:
            img = rgb_to_gray_uint8(img)
        return img


class Video:
    """A video source: a filename plus a lazily-opened backend.

    Indexing with an int returns a ``uint8 (H, W, C)`` frame; a list/array of
    ints returns a stacked ``(N, H, W, C)`` array.
    """

    def __init__(
        self,
        filename: Union[str, Sequence[str]],
        backend=None,
        backend_metadata: Optional[dict] = None,
        source_video: Optional["Video"] = None,
    ):
        self.filename = filename
        self.backend = backend
        self.backend_metadata = backend_metadata or {}
        self.source_video = source_video

    def open(self) -> "Video":
        if self.backend is not None:
            return self
        md, fn = self.backend_metadata, self.filename
        dataset = md.get("dataset")
        if dataset:
            self.backend = HDF5VideoBackend(
                fn, dataset, input_format=md.get("input_format", "channels_last"))
        elif not isinstance(fn, (list, tuple)) and Path(str(fn)).suffix.lower() in (
                ".h5", ".hdf5", ".slp"):
            self.backend = HDF5VideoBackend(fn, "video")
        else:
            raise NotImplementedError(_UNPORTED_MEDIA.format(repr(fn)))
        return self

    @property
    def shape(self) -> Optional[Tuple[int, int, int, int]]:
        """``(n_frames, H, W, C)``, or None where the backend cannot be
        opened here (a media file) or read."""
        try:
            self.open()
            return tuple(self.backend.shape)
        except Exception:
            return None

    def __len__(self) -> int:
        self.open()
        return self.backend.num_frames

    def __getitem__(self, idx):
        self.open()
        if isinstance(idx, (list, tuple, np.ndarray)):
            return np.stack([self.backend.get_frame(int(i)) for i in idx])
        return self.backend.get_frame(int(idx))

    def get_frame(self, idx: int, fmt: Optional[str] = None) -> np.ndarray:
        """Read one frame; ``fmt='gray'`` converts RGB to one channel (ITU-601)."""
        img = self[idx]
        if fmt == "gray" and img.shape[-1] == 3:
            img = rgb_to_gray_uint8(img)
        return img

    def __repr__(self) -> str:
        return f"Video(filename={self.filename!r}, shape={self.shape})"

    # -- serialization helpers ---------------------------------------------
    def to_backend_json(self) -> dict:
        """The sleap-io ``videos_json`` backend dict."""
        b = self.backend
        if isinstance(b, HDF5VideoBackend):
            return {
                "backend": {
                    "filename": "." if self.backend_metadata.get("embedded") else str(self.filename),
                    "dataset": b.dataset,
                    "input_format": b.input_format,
                    "convert_range": False,
                }
            }
        if isinstance(self.filename, (list, tuple)):
            return {"backend": {"filename": list(self.filename),
                                "grayscale": self.backend_metadata.get("grayscale")}}
        grayscale = getattr(b, "grayscale", None) if b is not None else \
            self.backend_metadata.get("grayscale")
        return {
            "backend": {
                "filename": str(self.filename),
                "grayscale": grayscale,
                "bgr": True,
                "dataset": "",
                "input_format": "",
            }
        }

    @classmethod
    def from_backend_json(cls, spec: dict, slp_path: Optional[str] = None) -> "Video":
        bk = dict(spec.get("backend", {}))
        fn = bk.get("filename", "")
        dataset = bk.get("dataset") or ""
        if dataset:
            # Embedded in the .slp container itself when filename is "."
            container = slp_path if fn in (".", "") else fn
            v = cls(
                filename=container,
                backend=HDF5VideoBackend(
                    container, dataset, input_format=bk.get("input_format", "channels_last")),
                backend_metadata={"embedded": fn in (".", ""), "dataset": dataset},
            )
            src = spec.get("source_video")
            if src:
                v.source_video = cls(filename=src.get("backend", {}).get("filename", ""),
                                     backend_metadata=src.get("backend", {}))
            return v
        if isinstance(fn, list):
            return cls(filename=[cls._resolve_media_path(f, slp_path) for f in fn],
                       backend_metadata={"grayscale": bk.get("grayscale")})
        return cls(filename=cls._resolve_media_path(fn, slp_path),
                   backend_metadata={"grayscale": bk.get("grayscale")})

    @staticmethod
    def _resolve_media_path(fn: str, slp_path: Optional[str]) -> str:
        """Recover a stale media path using the .slp file's own directory:
        the path as stored, then joined to the slp dir, then each suffix of
        it under the slp dir (basename last). Returns the stored path when
        nothing matches."""
        import os

        if not fn or not slp_path or os.path.exists(fn):
            return fn
        base = Path(slp_path).parent
        parts = Path(fn).parts
        candidates = [base / fn] + [base / Path(*parts[i:]) for i in range(1, len(parts))]
        for cand in candidates:
            if cand.exists():
                return str(cand)
        return fn
