"""In-memory labels data model.

Port of ``sleap_nn_tpu/io/model.py``: ``Skeleton`` (nodes / edges /
symmetries), ``SuggestionFrame``, ``Track``, ``Instance`` /
``PredictedInstance``, ``PredictedCentroid`` / ``UserCentroid``,
``PredictedROI``, ``SegmentationMask``, ``LabeledFrame`` (with its
``masks``) and the ``Labels`` container with its splits, edits and
``save`` (``io/slp.py``). A frame's masks travel with the frame through
every ``Labels`` edit, as in the JAX package. A video is
an ``io.video.Video`` or any object with ``video[frame_idx]`` returning an
``(H, W, C)`` uint8 frame and ``video.shape`` as ``(n_frames, H, W, C)``
(or None).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class Node:
    """A skeleton node (body part)."""

    name: str


@dataclass(frozen=True)
class Edge:
    """A directed skeleton edge (source -> destination)."""

    source: Node
    destination: Node


@dataclass(frozen=True)
class Symmetry:
    """An unordered pair of mutually symmetric nodes (e.g. left/right)."""

    nodes: Tuple[Node, Node]

    def __iter__(self):
        return iter(self.nodes)


class Skeleton:
    """Skeleton graph: ordered nodes, directed edges, symmetry pairs."""

    def __init__(
        self,
        nodes: Sequence[Union[str, Node]] = (),
        edges: Sequence[Union[Tuple[int, int], Tuple[str, str], Edge]] = (),
        symmetries: Sequence[Union[Tuple[int, int], Tuple[str, str], Symmetry]] = (),
        name: str = "Skeleton-0",
    ):
        self.nodes: List[Node] = [n if isinstance(n, Node) else Node(str(n)) for n in nodes]
        self.name = name
        self.edges: List[Edge] = [self._as_edge(e) for e in edges]
        self.symmetries: List[Symmetry] = [self._as_symmetry(s) for s in symmetries]

    def _node_by(self, key: Union[int, str, Node]) -> Node:
        if isinstance(key, Node):
            return key
        if isinstance(key, str):
            return self.nodes[self.node_names.index(key)]
        return self.nodes[int(key)]

    def _as_edge(self, e) -> Edge:
        if isinstance(e, Edge):
            return e
        s, d = e
        return Edge(self._node_by(s), self._node_by(d))

    def _as_symmetry(self, s) -> Symmetry:
        if isinstance(s, Symmetry):
            return s
        a, b = s
        return Symmetry((self._node_by(a), self._node_by(b)))

    @property
    def node_names(self) -> List[str]:
        return [n.name for n in self.nodes]

    @property
    def edge_inds(self) -> List[Tuple[int, int]]:
        names = self.node_names
        return [
            (names.index(e.source.name), names.index(e.destination.name)) for e in self.edges
        ]

    @property
    def edge_names(self) -> List[Tuple[str, str]]:
        return [(e.source.name, e.destination.name) for e in self.edges]

    @property
    def symmetry_inds(self) -> List[Tuple[int, int]]:
        names = self.node_names
        return [(names.index(a.name), names.index(b.name)) for a, b in self.symmetries]

    def index(self, node: Union[str, Node]) -> int:
        name = node.name if isinstance(node, Node) else node
        return self.node_names.index(name)

    def __len__(self) -> int:
        return len(self.nodes)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Skeleton)
            and self.node_names == other.node_names
            and self.edge_inds == other.edge_inds
        )

    def matches(self, other: "Skeleton") -> bool:
        return self == other

    def __repr__(self) -> str:
        return f"Skeleton(name={self.name!r}, nodes={self.node_names}, edges={self.edge_inds})"


@dataclass
class SuggestionFrame:
    """A frame suggested for labeling or prediction: a (video, frame_idx)
    pointer with a grouping id, stored in the ``.slp`` ``suggestions_json``."""

    video: object = None
    frame_idx: int = 0
    group: int = 0


@dataclass
class Track:
    """A track identity persisting across frames."""

    name: str = ""
    spawned_on: int = 0

    def __hash__(self):
        return id(self)


class Instance:
    """A user-labeled pose instance.

    ``points`` is an ``(n_nodes, 2) float64`` array in image (x, y) coords;
    invisible/missing nodes are NaN. ``visible`` tracks explicit visibility,
    ``complete`` the ``.slp`` per-point flag; ``from_predicted`` is the
    prediction a user instance was made from.
    """

    def __init__(
        self,
        points: Union[np.ndarray, Dict[str, Sequence[float]]],
        skeleton: Skeleton,
        track: Optional[Track] = None,
        visible: Optional[np.ndarray] = None,
        complete: Optional[np.ndarray] = None,
        from_predicted: Optional["PredictedInstance"] = None,
    ):
        if isinstance(points, dict):
            arr = np.full((len(skeleton), 2), np.nan, dtype=np.float64)
            for name, xy in points.items():
                arr[skeleton.index(name)] = xy
            points = arr
        self.points = np.asarray(points, dtype=np.float64).reshape(len(skeleton), 2)
        self.skeleton = skeleton
        self.track = track
        if visible is None:
            visible = ~np.isnan(self.points[:, 0])
        self.visible = np.asarray(visible, dtype=bool)
        if complete is None:
            complete = np.zeros(len(skeleton), dtype=bool)
        self.complete = np.asarray(complete, dtype=bool)
        self.from_predicted = from_predicted

    def numpy(self, invisible_as_nan: bool = True) -> np.ndarray:
        pts = self.points.astype(np.float64).copy()
        if invisible_as_nan:
            pts[~self.visible] = np.nan
        return pts

    @property
    def n_visible(self) -> int:
        return int(np.sum(self.visible & ~np.isnan(self.points[:, 0])))

    def is_empty(self) -> bool:
        return bool(np.all(np.isnan(self.numpy())))

    def centroid(self, anchor: Optional[str] = None) -> np.ndarray:
        """The ``anchor`` node where it is visible, else the mean of the visible nodes."""
        pts = self.numpy()
        if anchor is not None:
            idx = self.skeleton.index(anchor)
            if not np.isnan(pts[idx]).any():
                return pts[idx]
        return np.nanmean(pts, axis=0)

    def bounding_box(self) -> np.ndarray:
        """``[x0, y0, x1, y1]`` over the visible points (NaN if none)."""
        pts = self.numpy()
        if np.all(np.isnan(pts)):
            return np.full(4, np.nan)
        return np.array(
            [np.nanmin(pts[:, 0]), np.nanmin(pts[:, 1]), np.nanmax(pts[:, 0]), np.nanmax(pts[:, 1])]
        )

    def __len__(self) -> int:
        return len(self.skeleton)

    def __repr__(self) -> str:
        return f"Instance(n_visible={self.n_visible}, track={self.track.name if self.track else None})"


class PredictedInstance(Instance):
    """A model-predicted instance with per-point and instance scores."""

    def __init__(
        self,
        points: Union[np.ndarray, Dict[str, Sequence[float]]],
        skeleton: Skeleton,
        point_scores: Optional[np.ndarray] = None,
        score: float = 0.0,
        track: Optional[Track] = None,
        tracking_score: float = 0.0,
        visible: Optional[np.ndarray] = None,
    ):
        super().__init__(points, skeleton, track=track, visible=visible)
        if point_scores is None:
            point_scores = np.zeros(len(skeleton), dtype=np.float64)
        self.point_scores = np.asarray(point_scores, dtype=np.float64)
        self.score = float(score)
        self.tracking_score = float(tracking_score) if tracking_score is not None else 0.0

    @classmethod
    def from_numpy(
        cls,
        points: np.ndarray,
        point_scores: np.ndarray,
        skeleton: Skeleton,
        score: float = 0.0,
        track: Optional[Track] = None,
        tracking_score: float = 0.0,
    ) -> "PredictedInstance":
        return cls(points=points, skeleton=skeleton, point_scores=point_scores, score=score,
                   track=track, tracking_score=tracking_score)

    def __repr__(self) -> str:
        return (
            f"PredictedInstance(n_visible={self.n_visible}, score={self.score:.3f}, "
            f"track={self.track.name if self.track else None})"
        )


class PredictedCentroid:
    """A predicted instance center point (centroid-only output)."""

    def __init__(self, point: np.ndarray, score: float = 0.0,
                 track: Optional[Track] = None):
        self.point = np.asarray(point, dtype=np.float64).reshape(2)
        self.score = float(score)
        self.track = track


class UserCentroid(PredictedCentroid):
    """A user-annotated instance center (no pose)."""

    def __init__(self, point: np.ndarray, track: Optional[Track] = None):
        super().__init__(point, score=1.0, track=track)


class PredictedROI:
    """A predicted closed polygon in image pixel coords (a simplified mask outline)."""

    def __init__(self, points: np.ndarray, score: float = 0.0,
                 track: Optional[Track] = None):
        self.points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
        self.score = float(score)
        self.track = track

    @property
    def area(self) -> float:
        """Shoelace polygon area (px^2)."""
        x, y = self.points[:, 0], self.points[:, 1]
        return float(0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1))))

    def __len__(self) -> int:
        return len(self.points)


class SegmentationMask:
    """A (predicted) instance or foreground mask of one frame.

    ``scale`` is the factor from mask pixels to image pixels: a mask kept
    at the model's output grid has ``scale`` above 1, and ``decode``
    resizes it to the image (cv2 nearest neighbour).
    """

    def __init__(self, mask: np.ndarray, score: float = 0.0, track: Optional[Track] = None,
                 scale: float = 1.0):
        self.mask = np.asarray(mask, dtype=bool)
        self.score = float(score)
        self.track = track
        self.scale = float(scale)

    @property
    def area(self) -> int:
        return int(self.mask.sum())

    @property
    def image_area(self) -> float:
        """Mask area in image pixels."""
        return float(self.mask.sum()) * self.scale * self.scale

    def decode(self, out_hw: Optional[tuple] = None) -> np.ndarray:
        """The mask at image resolution (nearest neighbour), cropped or
        zero-padded to ``out_hw`` where given."""
        m = self.mask
        if self.scale != 1.0:
            import cv2

            m = cv2.resize(
                m.astype(np.uint8),
                (max(1, int(round(m.shape[1] * self.scale))),
                 max(1, int(round(m.shape[0] * self.scale)))),
                interpolation=cv2.INTER_NEAREST,
            ).astype(bool)
        if out_hw is not None:
            h, w = int(out_hw[0]), int(out_hw[1])
            if m.shape != (h, w):
                out = np.zeros((h, w), dtype=bool)
                hh, ww = min(h, m.shape[0]), min(w, m.shape[1])
                out[:hh, :ww] = m[:hh, :ww]
                m = out
        return m

    def centroid(self) -> np.ndarray:
        """Mean ``(x, y)`` of the mask's pixels (the mask's centre when empty)."""
        ys, xs = np.nonzero(self.mask)
        if len(xs) == 0:
            return np.array([self.mask.shape[1] / 2.0, self.mask.shape[0] / 2.0])
        return np.array([xs.mean(), ys.mean()])

    def __repr__(self) -> str:
        return f"SegmentationMask(area={self.area}, score={self.score:.3f})"


class LabeledFrame:
    """All instances labeled/predicted on one frame of one video."""

    def __init__(self, video, frame_idx: int, instances: Optional[List[Instance]] = None,
                 masks: Optional[List[SegmentationMask]] = None,
                 rois: Optional[List[PredictedROI]] = None,
                 centroids: Optional[List[PredictedCentroid]] = None):
        self.video = video
        self.frame_idx = int(frame_idx)
        self.instances: List[Instance] = list(instances or [])
        self.masks: List[SegmentationMask] = list(masks or [])
        self.rois: List[PredictedROI] = list(rois or [])
        self.centroids: List[PredictedCentroid] = list(centroids or [])

    @property
    def user_instances(self) -> List[Instance]:
        return [i for i in self.instances if not isinstance(i, PredictedInstance)]

    @property
    def predicted_instances(self) -> List[PredictedInstance]:
        return [i for i in self.instances if isinstance(i, PredictedInstance)]

    @property
    def has_predicted_instances(self) -> bool:
        return len(self.predicted_instances) > 0

    @property
    def user_centroids(self) -> List[UserCentroid]:
        return [c for c in self.centroids if isinstance(c, UserCentroid)]

    @property
    def has_user_instances(self) -> bool:
        return len(self.user_instances) > 0

    @property
    def image(self) -> np.ndarray:
        return self.video[self.frame_idx]

    def numpy(self) -> np.ndarray:
        """Stack instance points to ``(n_instances, n_nodes, 2)``."""
        if not self.instances:
            return np.zeros((0, 0, 2))
        return np.stack([i.numpy() for i in self.instances])

    def remove_predictions(self):
        self.instances = self.user_instances

    def __len__(self) -> int:
        return len(self.instances)

    def __iter__(self) -> Iterator[Instance]:
        return iter(self.instances)

    def __repr__(self) -> str:
        return f"LabeledFrame(frame_idx={self.frame_idx}, n_instances={len(self.instances)})"


def is_negative_frame(lf: LabeledFrame) -> bool:
    """User-confirmed negative: a labeled frame with no instances at all."""
    return not list(lf.instances)


class Labels:
    """Top-level labels container."""

    def __init__(
        self,
        labeled_frames: Optional[List[LabeledFrame]] = None,
        videos: Optional[List] = None,
        skeletons: Optional[List[Skeleton]] = None,
        tracks: Optional[List[Track]] = None,
        provenance: Optional[dict] = None,
        suggestions: Optional[List[SuggestionFrame]] = None,
    ):
        self.labeled_frames: List[LabeledFrame] = list(labeled_frames or [])
        self.videos = list(videos or [])
        self.skeletons = list(skeletons or [])
        self.tracks = list(tracks or [])
        self.provenance = dict(provenance or {})
        self.suggestions: List[SuggestionFrame] = list(suggestions or [])
        self._update_from_frames()

    @property
    def negative_frames(self) -> List[LabeledFrame]:
        """User-confirmed negative frames: labeled, with no instance."""
        return [lf for lf in self.labeled_frames if is_negative_frame(lf)]

    def _update_from_frames(self):
        for lf in self.labeled_frames:
            if lf.video is not None and not any(v is lf.video for v in self.videos):
                self.videos.append(lf.video)
            for inst in lf.instances:
                if inst.skeleton not in self.skeletons:
                    self.skeletons.append(inst.skeleton)
                if inst.track is not None and inst.track not in self.tracks:
                    self.tracks.append(inst.track)

    def __len__(self) -> int:
        return len(self.labeled_frames)

    def __iter__(self) -> Iterator[LabeledFrame]:
        return iter(self.labeled_frames)

    def __getitem__(self, key) -> Union[LabeledFrame, List[LabeledFrame]]:
        """A frame by position, a list of frames by slice, or the frame of
        a ``(video, frame_idx)`` pair."""
        if isinstance(key, (int, slice)):
            return self.labeled_frames[key]
        if isinstance(key, tuple) and len(key) == 2:
            found = self.find(*key)
            if not found:
                raise KeyError(key)
            return found[0]
        raise KeyError(key)

    def append(self, lf: LabeledFrame):
        self.labeled_frames.append(lf)
        self._update_from_frames()

    def extend(self, lfs: Sequence[LabeledFrame]):
        self.labeled_frames.extend(lfs)
        self._update_from_frames()

    @property
    def skeleton(self) -> Skeleton:
        if not self.skeletons:
            raise ValueError("Labels has no skeletons.")
        return self.skeletons[0]

    @property
    def video(self):
        if not self.videos:
            raise ValueError("Labels has no videos.")
        return self.videos[0]

    def find(self, video, frame_idx: Optional[int] = None) -> List[LabeledFrame]:
        return [lf for lf in self.labeled_frames
                if lf.video is video and (frame_idx is None or lf.frame_idx == frame_idx)]

    @property
    def user_labeled_frames(self) -> List[LabeledFrame]:
        return [lf for lf in self.labeled_frames if lf.has_user_instances]

    def instances(self) -> Iterator[Instance]:
        for lf in self.labeled_frames:
            yield from lf.instances

    def remove_predictions(self):
        """Drop every predicted instance, then the frames left empty."""
        for lf in self.labeled_frames:
            lf.remove_predictions()
        self.labeled_frames = [lf for lf in self.labeled_frames if len(lf) > 0]

    def clean(
        self,
        frames: bool = True,
        empty_instances: bool = False,
        skeletons: bool = False,
        tracks: bool = False,
        videos: bool = False,
    ):
        """Remove empty frames / instances and unused objects."""
        if empty_instances:
            for lf in self.labeled_frames:
                lf.instances = [i for i in lf.instances if not i.is_empty()]
        if frames:
            self.labeled_frames = [lf for lf in self.labeled_frames if len(lf) > 0]
        if tracks:
            used = {i.track for i in self.instances() if i.track is not None}
            self.tracks = [t for t in self.tracks if t in used]
        if skeletons:
            used = [i.skeleton for i in self.instances()]
            self.skeletons = [s for s in self.skeletons if any(s is u for u in used)]
        if videos:
            used = {id(lf.video) for lf in self.labeled_frames}
            self.videos = [v for v in self.videos if id(v) in used]

    def split(self, n: Union[int, float], seed: Optional[int] = None) -> Tuple["Labels", "Labels"]:
        """Random split into (first, rest). ``n`` is a count or a fraction."""
        rng = np.random.default_rng(seed)
        idxs = rng.permutation(len(self.labeled_frames))
        if isinstance(n, float):
            n = max(int(round(n * len(idxs))), 1)
        n = min(n, len(idxs))
        return self.extract(sorted(idxs[:n].tolist())), self.extract(sorted(idxs[n:].tolist()))

    def extract(self, inds: Sequence[int]) -> "Labels":
        lfs = [self.labeled_frames[i] for i in inds]
        return Labels(
            labeled_frames=lfs,
            videos=list(self.videos),
            skeletons=list(self.skeletons),
            tracks=list(self.tracks),
            provenance=dict(self.provenance),
        )

    def make_training_splits(
        self,
        n_train: Union[int, float],
        n_val: Optional[Union[int, float]] = None,
        n_test: Optional[Union[int, float]] = None,
        seed: Optional[int] = None,
        include_centroid_only_frames: bool = False,
    ) -> Tuple["Labels", ...]:
        """Split user-labeled frames into train/val(/test) subsets.

        The JAX package's split, draw for draw: one
        ``np.random.default_rng(seed).permutation`` over the user-labeled
        frames (plus, with ``include_centroid_only_frames``, frames that
        carry only user centroids); a float count is a fraction of them,
        rounded, at least 1.
        """
        user = [
            i for i, lf in enumerate(self.labeled_frames)
            if lf.has_user_instances
            or (include_centroid_only_frames and lf.user_centroids)
        ]
        rng = np.random.default_rng(seed)
        idxs = rng.permutation(len(user))

        def count(x, total):
            if x is None:
                return 0
            if isinstance(x, float):
                return max(int(round(x * total)), 1)
            return int(x)

        total = len(user)
        k_train = count(n_train, total)
        k_val = count(n_val, total) if n_val is not None else total - k_train
        k_test = count(n_test, total) if n_test is not None else 0
        train_i = sorted(idxs[:k_train].tolist())
        val_i = sorted(idxs[k_train : k_train + k_val].tolist())
        test_i = sorted(idxs[k_train + k_val : k_train + k_val + k_test].tolist())
        out = [self.extract([user[i] for i in train_i]), self.extract([user[i] for i in val_i])]
        if n_test is not None:
            out.append(self.extract([user[i] for i in test_i]))
        return tuple(out)

    def save(self, path, embed: bool = False):
        """Write a ``.slp`` file."""
        from sleap_nn_tpu_torch.io.slp import save_slp

        save_slp(path, self, embed=embed)

    def __repr__(self) -> str:
        return (
            f"Labels(n_frames={len(self.labeled_frames)}, n_videos={len(self.videos)}, "
            f"n_skeletons={len(self.skeletons)}, n_tracks={len(self.tracks)})"
        )
