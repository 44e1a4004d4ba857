"""Geodesic-polyhedron bases of Mip-NeRF 360's lifted positional
encoding (MultiNeRF geopoly.py): the vertices of a tessellated
icosahedron or octahedron, antipodal duplicates removed, as [3, n]
columns in the published axis order."""

from __future__ import annotations

import itertools

import numpy as np


def _pairwise_sq_dist(cols0, cols1=None):
    """Squared Euclidean distance between all column pairs of [d, n] matrices."""
    if cols1 is None:
        cols1 = cols0
    n0 = np.sum(cols0**2, axis=0)
    n1 = np.sum(cols1**2, axis=0)
    return np.maximum(0.0, n0[:, None] + n1[None, :] - 2.0 * cols0.T @ cols1)


def _tesselate_faces(verts, faces, factor, eps=1e-4):
    """Subdivide each triangular face `factor` times, project to the sphere,
    and deduplicate shared edge/corner vertices."""
    if not isinstance(factor, int) or factor < 1:
        raise ValueError(f"tesselation factor must be an int >= 1, got {factor}")
    bary = np.array([(i, j, factor - i - j)
                     for i in range(factor + 1)
                     for j in range(factor + 1 - i)], dtype=np.float64) / factor
    out = []
    for face in faces:
        pts = bary @ verts[face, :]
        pts /= np.sqrt(np.sum(pts**2, axis=1, keepdims=True))
        out.append(pts)
    out = np.concatenate(out, axis=0)
    # Keep the first representative of each near-duplicate cluster.
    sq = _pairwise_sq_dist(out.T)
    first = np.array([np.min(np.argwhere(row <= eps)) for row in sq])
    return out[np.unique(first), :]


def generate_basis(base_shape, angular_tesselation, remove_symmetries=True,
                   eps=1e-4):
    """Basis matrix [3, n] from a tesselated icosahedron or octahedron.

    remove_symmetries drops antipodal duplicates (projections would just be
    negated copies). Axis order is reversed to match the reference basis
    (geopoly.py:78-124) so encodings are feature-for-feature comparable.
    """
    if base_shape == "icosahedron":
        a = (np.sqrt(5) + 1) / 2
        verts = np.array(
            [(-1, 0, a), (1, 0, a), (-1, 0, -a), (1, 0, -a), (0, a, 1),
             (0, a, -1), (0, -a, 1), (0, -a, -1), (a, 1, 0), (-a, 1, 0),
             (a, -1, 0), (-a, -1, 0)]) / np.sqrt(a + 2)
        faces = np.array(
            [(0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1),
             (8, 10, 1), (8, 3, 10), (5, 3, 8), (5, 2, 3), (2, 7, 3),
             (7, 10, 3), (7, 6, 10), (7, 11, 6), (11, 0, 6), (0, 1, 6),
             (6, 1, 10), (9, 0, 11), (9, 11, 2), (9, 2, 5), (7, 2, 11)])
        verts = _tesselate_faces(verts, faces, angular_tesselation, eps)
    elif base_shape == "octahedron":
        verts = np.array(
            [(0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (-1, 0, 0), (1, 0, 0)],
            dtype=np.float64)
        corners = np.array(list(itertools.product([-1, 1], repeat=3)))
        pairs = np.argwhere(_pairwise_sq_dist(corners.T, verts.T) == 2)
        faces = np.sort(np.reshape(pairs[:, 1], [3, -1]).T, axis=1)
        verts = _tesselate_faces(verts, faces, angular_tesselation, eps)
    else:
        raise ValueError(f"base_shape {base_shape!r} not supported")

    if remove_symmetries:
        match = _pairwise_sq_dist(verts.T, -verts.T) < eps
        verts = verts[np.any(np.triu(match), axis=1), :]
    return verts[:, ::-1]
