"""Median-split BVH builder (host side).

Parity reference: ``Assets/Services/BVH/BVHBuilder.cs``:

* node bounds encapsulate all three vertices of every triangle (:107-119);
* leaf when count <= 4 (MAX_TRIANGLES_PER_LEAF, :58,:125) or when the
  partition degenerates (:142-145);
* split on the longest axis at the AABB center (:130-136);
* quicksort-style in-place index partition on triangle centroids (:160-183);
* BFS flatten so children are contiguous and right = leftOrFirst + 1
  (:189-238); triangles reordered to match leaf order (:214-215).

Output is SoA numpy ready for device upload
(:func:`cosig_tpu.ops.bvh_traverse.build_bvh_device`).

A C++ implementation with identical output lives in
``cosig_tpu/native/src/bvh.cc``; :func:`build_bvh` dispatches to it when
the native library is available (``use_native='auto'``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from cosig_tpu.scene.tessellate import TriangleSoA

F32 = np.float32

MAX_TRIANGLES_PER_LEAF = 4


@dataclass
class BVH:
    """Flattened BVH. Internal nodes: count == 0, left_or_first = left child
    (right child = left + 1). Leaves: count > 0, left_or_first = first
    triangle in the reordered soup."""

    node_min: np.ndarray  # [N, 3] f32
    node_max: np.ndarray  # [N, 3] f32
    left_or_first: np.ndarray  # [N] i32
    count: np.ndarray  # [N] i32
    triangles: TriangleSoA  # reordered to match leaf references
    order: np.ndarray  # [T] i32: original index of each reordered triangle

    @property
    def num_nodes(self) -> int:
        return int(self.node_min.shape[0])

    def depth(self) -> int:
        """Max tree depth (root = 1); bounds the traversal stack."""

        def rec(i: int) -> int:
            if self.count[i] > 0:
                return 1
            left = int(self.left_or_first[i])
            return 1 + max(rec(left), rec(left + 1))

        return rec(0) if self.num_nodes else 0


class _Node:
    __slots__ = ("bmin", "bmax", "left", "right", "start", "count")

    def __init__(self):
        self.left = self.right = None
        self.start = self.count = 0


def build_bvh(
    tris: TriangleSoA,
    max_leaf: int = MAX_TRIANGLES_PER_LEAF,
    use_native: str = "auto",
) -> BVH:
    """Build the flattened BVH; algorithmic twin of BVHBuilder.Build (:76-95)."""
    if use_native in ("auto", "native"):
        try:
            from cosig_tpu.native import bvh_native

            result = bvh_native.build(tris, max_leaf)
            if result is not None:
                return result
            if use_native == "native":
                raise RuntimeError("native BVH library unavailable")
        except ImportError:
            if use_native == "native":
                raise
    return _build_python(tris, max_leaf)


def _build_python(tris: TriangleSoA, max_leaf: int) -> BVH:
    t = tris.count
    if t == 0:
        return BVH(
            node_min=np.zeros((1, 3), F32),
            node_max=np.zeros((1, 3), F32),
            left_or_first=np.zeros((1,), np.int32),
            count=np.zeros((1,), np.int32),
            triangles=tris,
            order=np.zeros((0,), np.int32),
        )

    centers = tris.centers
    # Vectorized per-triangle bounds for fast range reductions.
    tri_min = np.minimum(np.minimum(tris.v0, tris.v1), tris.v2)
    tri_max = np.maximum(np.maximum(tris.v0, tris.v1), tris.v2)
    indices = np.arange(t, dtype=np.int64)

    def build(start: int, count: int) -> _Node:
        node = _Node()
        sel = indices[start : start + count]
        node.bmin = tri_min[sel].min(axis=0)
        node.bmax = tri_max[sel].max(axis=0)
        node.start = start
        node.count = count
        if count <= max_leaf:
            return node

        size = node.bmax - node.bmin
        axis = 0
        if size[1] > size[0]:
            axis = 1
        if size[2] > size[axis]:
            axis = 2
        pivot = (node.bmin[axis] + node.bmax[axis]) * F32(0.5)

        # In-place two-pointer partition on centroids (:160-183). The
        # vectorized stable split below yields the same *set* on each side;
        # the reference's swap order differs, but leaf contents (sets) and
        # the tree shape are identical because only membership matters to
        # BuildRecursive's ranges.
        c = centers[sel, axis]
        left_mask = c < pivot
        mid = start + int(left_mask.sum())
        if mid == start or mid == start + count:
            # Robustness beyond the reference (which bails to a leaf,
            # :142-145): an oversized triangle can stretch the node bounds
            # so that every *centroid* sits on one side of the bounds
            # center. Retry splitting at the centroid-extent median before
            # giving up — otherwise scenes with large ground planes
            # degenerate to thousand-triangle leaves.
            node_centers = centers[sel]
            cmin = node_centers.min(axis=0)
            cmax = node_centers.max(axis=0)
            cext = cmax - cmin
            axis = int(np.argmax(cext))
            pivot = (cmin[axis] + cmax[axis]) * F32(0.5)
            c = node_centers[:, axis]
            left_mask = c < pivot
            mid = start + int(left_mask.sum())
            if mid == start or mid == start + count:
                return node  # all centroids coincide -> leaf
        indices[start : start + count] = np.concatenate(
            [sel[left_mask], sel[~left_mask]]
        )

        node.left = build(start, mid - start)
        node.right = build(mid, start + count - mid)
        node.count = 0
        return node

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        root = build(0, t)
    finally:
        sys.setrecursionlimit(old_limit)

    # BFS flatten (:189-238).
    node_min: List[np.ndarray] = []
    node_max: List[np.ndarray] = []
    lof: List[int] = []
    cnt: List[int] = []
    order: List[int] = []

    queue = [root]
    # Pre-allocate slots breadth-first: process queue while appending children.
    slots = [0]
    node_min.append(None)  # type: ignore
    node_max.append(None)  # type: ignore
    lof.append(0)
    cnt.append(0)
    qi = 0
    while qi < len(queue):
        n = queue[qi]
        idx = slots[qi]
        qi += 1
        node_min[idx] = n.bmin
        node_max[idx] = n.bmax
        if n.count > 0:  # leaf
            cnt[idx] = n.count
            lof[idx] = len(order)
            order.extend(indices[n.start : n.start + n.count].tolist())
        else:
            left_idx = len(node_min)
            for _ in range(2):
                node_min.append(None)  # type: ignore
                node_max.append(None)  # type: ignore
                lof.append(0)
                cnt.append(0)
            cnt[idx] = 0
            lof[idx] = left_idx
            queue.append(n.left)
            slots.append(left_idx)
            queue.append(n.right)
            slots.append(left_idx + 1)

    order_arr = np.asarray(order, dtype=np.int32)
    return BVH(
        node_min=np.stack(node_min).astype(F32),
        node_max=np.stack(node_max).astype(F32),
        left_or_first=np.asarray(lof, dtype=np.int32),
        count=np.asarray(cnt, dtype=np.int32),
        triangles=tris.take(order_arr),
        order=order_arr,
    )


def validate_bvh(bvh: BVH, tris: TriangleSoA) -> None:
    """Structural invariants (used by tests): every triangle exactly once,
    children contained in parents, leaves within bounds."""
    t = tris.count
    assert sorted(bvh.order.tolist()) == list(range(t)), "triangle permutation"
    n = bvh.num_nodes
    for i in range(n):
        assert (bvh.node_min[i] <= bvh.node_max[i] + 1e-6).all()
        if bvh.count[i] == 0 and t > 0:
            left = int(bvh.left_or_first[i])
            assert 0 < left and left + 1 < n
            for ch in (left, left + 1):
                assert (bvh.node_min[i] <= bvh.node_min[ch] + 1e-5).all()
                assert (bvh.node_max[ch] <= bvh.node_max[i] + 1e-5).all()
        else:
            first = int(bvh.left_or_first[i])
            cn = int(bvh.count[i])
            for k in range(first, first + cn):
                v = np.stack(
                    [bvh.triangles.v0[k], bvh.triangles.v1[k], bvh.triangles.v2[k]]
                )
                assert (v.min(axis=0) >= bvh.node_min[i] - 1e-4).all()
                assert (v.max(axis=0) <= bvh.node_max[i] + 1e-4).all()
