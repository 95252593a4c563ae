"""Videos: a filename plus a backend that reads frames.

Port of ``sleap_nn_tpu/io/video.py``, with its three backends:

- ``MediaVideoBackend``: any container OpenCV can demux (mp4, avi, ...),
  one ``cv2.VideoCapture`` per thread (a capture is not thread safe), a
  seek only when the asked frame is not the next one, and a probe of the
  first frame that finds grayscale content stored as RGB.
- ``HDF5VideoBackend``: frames embedded in a ``.slp`` / HDF5 file, PNG
  bytes (decoded by ``io/png.py``, so a ``.slp`` needs no cv2), JPEG bytes
  (cv2) or raw arrays, with the ``frame_numbers`` map of the embedding
  group.
- ``ImageVideoBackend``: a list of image files, one frame each.

cv2 is imported by the functions that decode only; HDF5 reads go
through the port's own reader (``io/hdf5.py``). Any object with ``get_frame(idx)``, ``num_frames`` and ``shape``
serves as a backend, so an in-memory ``Video`` takes an array-backed one.

Frames come back as ``uint8 (H, W, C)``, C in {1, 3}.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from sleap_nn_tpu_torch.io import hdf5
from sleap_nn_tpu_torch.io.png import decode_png


def rgb_to_gray_uint8(frames: np.ndarray) -> np.ndarray:
    """ITU-601 luma on uint8 RGB, ``(..., 3)`` -> ``(..., 1)``.

    Bit-identical to ``cv2.cvtColor(..., COLOR_RGB2GRAY)``, which the JAX
    package calls: 15-bit fixed-point weights, rounded half up.
    """
    f = frames.astype(np.uint32)
    luma = (f[..., 0] * 9798 + f[..., 1] * 19235 + f[..., 2] * 3735 + (1 << 14)) >> 15
    return luma.astype(np.uint8)[..., None]


def _imdecode(buf: np.ndarray, grayscale: bool) -> np.ndarray:
    """Encoded image bytes -> ``(H, W, C)`` uint8, RGB or one channel."""
    import cv2

    flag = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
    img = cv2.imdecode(buf, flag)
    if img is None:
        raise ValueError("Failed to decode embedded frame.")
    if img.ndim == 2:
        img = img[..., None]
    elif img.shape[-1] == 3:
        img = img[..., ::-1]  # BGR -> RGB
    return np.ascontiguousarray(img)


class _ThreadHandles:
    """Per-thread file handles (``self._local``), left behind when the
    backend is pickled (into the ranks of a data-parallel run) and opened
    anew where it is unpickled."""

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_local", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local = threading.local()


class MediaVideoBackend(_ThreadHandles):
    """OpenCV-based media file reader with thread-local handles.

    Each thread keeps its own capture and the index of the frame it reads
    next; ``get_frame`` seeks (``CAP_PROP_POS_FRAMES``) only when asked for
    another one. Seeks in inter-coded streams may land off the asked frame
    in some cv2 builds, so the seek points are the JAX package's.
    """

    def __init__(self, filename: str, grayscale: Optional[bool] = None):
        self.filename = str(filename)
        self.grayscale = grayscale
        self._local = threading.local()
        self._meta: Optional[Tuple[int, int, int]] = None  # (n_frames, h, w)

    def _cap(self):
        import cv2

        cap = getattr(self._local, "cap", None)
        if cap is None:
            cap = cv2.VideoCapture(self.filename)
            if not cap.isOpened():
                raise FileNotFoundError(f"Could not open video: {self.filename}")
            self._local.cap = cap
            self._local.pos = 0
        return cap

    @property
    def num_frames(self) -> int:
        self._ensure_meta()
        return self._meta[0]

    def _ensure_meta(self):
        if self._meta is None:
            import cv2

            cap = self._cap()
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            self._meta = (n, h, w)
            if self.grayscale is None:
                # Probe the first frame for grayscale content stored as RGB.
                frame = self.get_frame(0)
                if frame.shape[-1] == 3:
                    self.grayscale = bool(np.all(frame[..., 0] == frame[..., 1])
                                          and np.all(frame[..., 1] == frame[..., 2]))
                else:
                    self.grayscale = True

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        self._ensure_meta()
        n, h, w = self._meta
        return (n, h, w, 1 if self.grayscale else 3)

    def get_frame(self, idx: int, fmt: Optional[str] = None) -> np.ndarray:
        """Decode one frame; ``fmt="gray"`` converts BGR to gray in one pass
        (``COLOR_BGR2GRAY`` on BGR equals ``COLOR_RGB2GRAY`` on RGB)."""
        import cv2

        cap = self._cap()
        if getattr(self._local, "pos", None) != idx:
            cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok, img = cap.read()
        if not ok:
            raise IndexError(f"Failed to read frame {idx} from {self.filename}")
        self._local.pos = idx + 1
        if fmt == "gray" or self.grayscale:
            return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)[..., None]
        return np.ascontiguousarray(img[..., ::-1])  # BGR -> RGB


class HDF5VideoBackend(_ThreadHandles):
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
        f = getattr(self._local, "f", None)
        if f is None:
            f = hdf5.File(self.filename, "r")
            self._local.f = f
        return f

    def _dataset(self):
        """This thread's handle on the frames' dataset, which keeps its
        chunk index once read."""
        ds = getattr(self._local, "ds", None)
        if ds is None:
            ds = self._file()[self.dataset]
            self._local.ds = ds
        return ds

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
        ds = self._dataset()
        row = self._frame_map.get(int(idx))
        if row is None:
            raise IndexError(f"Frame {idx} is not embedded in {self.filename}:{self.dataset}")
        data = ds[row]
        enc = self._attrs.get("format", "")
        if isinstance(enc, bytes):
            enc = enc.decode()
        if enc in ("jpg", "jpeg"):
            buf = np.frombuffer(np.asarray(data).tobytes(), dtype=np.uint8)
            return _imdecode(buf, fmt == "gray" or int(self._attrs.get("channels", 3)) == 1)
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


class ImageVideoBackend:
    """A sequence of image files treated as video frames."""

    def __init__(self, filenames: Sequence[str], grayscale: Optional[bool] = None):
        self.filenames = [str(f) for f in filenames]
        self.grayscale = grayscale

    @property
    def num_frames(self) -> int:
        return len(self.filenames)

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (self.num_frames,) + self.get_frame(0).shape

    def get_frame(self, idx: int, fmt: Optional[str] = None) -> np.ndarray:
        import cv2

        gray = fmt == "gray" or self.grayscale
        img = cv2.imread(self.filenames[idx], cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(self.filenames[idx])
        if img.ndim == 2:
            return img[..., None]
        return np.ascontiguousarray(img[..., ::-1])


# The backends whose get_frame decodes to one channel itself (fmt="gray").
_GRAY_DECODERS = (MediaVideoBackend, HDF5VideoBackend, ImageVideoBackend)
_IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}


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

    @classmethod
    def from_filename(cls, filename: Union[str, Sequence[str]], **kwargs) -> "Video":
        """An opened ``Video`` of a media file, an image file or a list of
        them, or an HDF5 file (``dataset`` / ``input_format`` in
        ``kwargs``)."""
        return cls(filename=filename, backend_metadata=kwargs).open()

    def open(self) -> "Video":
        """Pick the backend by what the filename is: a list of images, an
        HDF5 dataset, a single image, else a media file."""
        if self.backend is not None:
            return self
        md, fn = self.backend_metadata, self.filename
        if isinstance(fn, (list, tuple)):
            self.backend = ImageVideoBackend(fn, grayscale=md.get("grayscale"))
            return self
        ext = Path(str(fn)).suffix.lower()
        if md.get("dataset"):
            self.backend = HDF5VideoBackend(
                fn, md["dataset"], input_format=md.get("input_format", "channels_last"))
        elif ext in (".h5", ".hdf5", ".slp"):
            self.backend = HDF5VideoBackend(fn, "video")
        elif ext in _IMAGE_EXTS:
            self.backend = ImageVideoBackend([str(fn)], grayscale=md.get("grayscale"))
        else:
            self.backend = MediaVideoBackend(str(fn), grayscale=md.get("grayscale"))
        return self

    @property
    def is_open(self) -> bool:
        return self.backend is not None

    def exists(self) -> bool:
        fn = self.filename
        if isinstance(fn, (list, tuple)):
            return all(Path(f).exists() for f in fn)
        return Path(str(fn)).exists()

    @property
    def shape(self) -> Optional[Tuple[int, int, int, int]]:
        """``(n_frames, H, W, C)``, or None where the file cannot be read."""
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
        """Read one frame; ``fmt="gray"`` has the backend decode to one
        channel (ITU-601), or converts after the read for a backend of
        another kind."""
        if fmt is None:
            return self[idx]
        self.open()
        if isinstance(self.backend, _GRAY_DECODERS):
            return self.backend.get_frame(int(idx), fmt=fmt)
        img = self.backend.get_frame(int(idx))
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
        if isinstance(b, ImageVideoBackend):
            return {"backend": {"filename": b.filenames, "grayscale": b.grayscale}}
        grayscale = getattr(b, "grayscale", None) if b is not None else None
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
            fn = [cls._resolve_media_path(f, slp_path) for f in fn]
            return cls(filename=fn, backend=ImageVideoBackend(fn, bk.get("grayscale")))
        v = cls(filename=cls._resolve_media_path(fn, slp_path),
                backend_metadata={"grayscale": bk.get("grayscale")})
        if v.exists():
            v.open()
        return v

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
