"""Isosurface extraction by marching tetrahedra, in torch ops on the level
grid's own device (counterpart of ``rise_sdf_tpu/ops/mcubes.py``'s
``marching_tets``).

Each active cube (a sign change across its corners) splits into 6
tetrahedra around its main diagonal; each tetrahedron gives 0-2
triangles whose vertices interpolate linearly along its edges.  Vertices
are shared by edge id (the sorted pair of corner ids), so the mesh is
watertight where the field is; faces with a repeated vertex are
dropped.  The same cases, tables, vertex order (sorted edge ids, each
vertex interpolated from its edge's first occurrence) and face order as
the JAX package's numpy version, so the two give the same faces.

On the card a 512^3 grid (512 MB of float32) stays there: the corner
signs are counted in ``uint8`` and only the active cubes' corners are
gathered.
"""

from __future__ import annotations

from typing import Tuple

import torch

# cube corner i has offsets ((i>>2)&1, (i>>1)&1, i&1) in (x, y, z)
_CORNER_OFFSETS = [((i >> 2) & 1, (i >> 1) & 1, i & 1) for i in range(8)]

# 6-tet decomposition around diagonal corner0 (000) -> corner7 (111)
_TETS = [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7],
         [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]]


def _tet_case_tables():
    """For each of the 16 sign cases: up to 2 triangles, each vertex an
    edge (a pair of local tet-corner indices 0..3), padded with -1."""
    tris = torch.full((16, 2, 3, 2), -1, dtype=torch.int64)
    for case in range(1, 15):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if not case & (1 << i)]
        if len(inside) == 1:
            a = inside[0]
            e = [(a, o) for o in outside]
            tris[case, 0] = torch.tensor([e[0], e[1], e[2]])
        elif len(inside) == 3:
            a = outside[0]
            e = [(i, a) for i in inside]
            # flip orientation vs the 1-inside case
            tris[case, 0] = torch.tensor([e[0], e[2], e[1]])
        else:  # two inside: quad -> 2 triangles
            i0, i1 = inside
            o0, o1 = outside
            e00, e01 = (i0, o0), (i0, o1)
            e10, e11 = (i1, o0), (i1, o1)
            tris[case, 0] = torch.tensor([e00, e01, e11])
            tris[case, 1] = torch.tensor([e00, e11, e10])
    return tris


_TET_TRIS = _tet_case_tables()


def _empty(device):
    return (torch.zeros((0, 3), dtype=torch.float32, device=device),
            torch.zeros((0, 3), dtype=torch.int64, device=device))


def marching_tets(level: torch.Tensor, threshold: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extract {level == threshold}. level: [Rx, Ry, Rz] float32.

    Returns (verts [V, 3] float32 in index coordinates [0, R-1], faces
    [F, 3] int64), on ``level``'s device.  Triangles are oriented so
    normals point toward *decreasing* level (outward for an SDF with
    negative interior).
    """
    level = level.float()
    dev = level.device
    rx, ry, rz = level.shape
    inside = level < threshold

    # active cubes: any corner sign differs
    cs = torch.zeros((rx - 1, ry - 1, rz - 1), dtype=torch.uint8, device=dev)
    for ox, oy, oz in _CORNER_OFFSETS:
        cs += inside[ox:rx - 1 + ox, oy:ry - 1 + oy, oz:rz - 1 + oz]
    active = torch.nonzero((cs > 0) & (cs < 8))               # [A, 3]
    del cs, inside
    if active.shape[0] == 0:
        return _empty(dev)

    # global corner ids + values (level - threshold) of each cube [A, 8]
    offs = torch.tensor(_CORNER_OFFSETS, dtype=torch.int64, device=dev)
    c3 = active[:, None, :] + offs[None, :, :]
    gid = (c3[..., 0] * ry + c3[..., 1]) * rz + c3[..., 2]
    vals = level.reshape(-1)[gid] - threshold

    # tets [T, 4] of global corner ids / values; those with a sign change
    tets = torch.tensor(_TETS, dtype=torch.int64, device=dev)
    tet_gid = gid[:, tets].reshape(-1, 4)
    tet_val = vals[:, tets].reshape(-1, 4)
    neg = (tet_val < 0).to(torch.uint8)
    case = neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2) | (neg[:, 3] << 3)
    cut = (case != 0) & (case != 15)
    tet_gid, tet_val, case = tet_gid[cut], tet_val[cut], case[cut].long()

    tris = _TET_TRIS.to(dev)[case]                  # [T, 2, 3, 2] local edges
    t_idx, k_idx = torch.nonzero(tris[:, :, 0, 0] >= 0, as_tuple=True)
    if t_idx.shape[0] == 0:
        return _empty(dev)
    tri_edges = tris[t_idx, k_idx].reshape(-1, 6)   # [F, 6] local corners
    tri_gid = torch.gather(tet_gid[t_idx], 1, tri_edges).reshape(-1, 3, 2)
    tri_val = torch.gather(tet_val[t_idx], 1, tri_edges).reshape(-1, 3, 2)

    # vertices shared by edge id (min_gid, max_gid), sorted by it; each
    # interpolated from its edge's first occurrence
    e0 = torch.minimum(tri_gid[..., 0], tri_gid[..., 1])
    e1 = torch.maximum(tri_gid[..., 0], tri_gid[..., 1])
    ekey = (e0 * (rx * ry * rz) + e1).reshape(-1)
    uniq, inv = torch.unique(ekey, sorted=True, return_inverse=True)
    pos = torch.arange(ekey.shape[0], device=dev)
    first = torch.full((uniq.shape[0],), ekey.shape[0], dtype=torch.int64,
                       device=dev).scatter_reduce(0, inv, pos, reduce="amin")
    faces = inv.reshape(-1, 3)
    g0 = tri_gid[..., 0].reshape(-1)[first]
    g1 = tri_gid[..., 1].reshape(-1)[first]
    v0 = tri_val[..., 0].reshape(-1)[first]
    v1 = tri_val[..., 1].reshape(-1)[first]

    def gid_to_xyz(g):
        return torch.stack([g // (rz * ry), (g // rz) % ry, g % rz],
                           -1).float()

    p0, p1 = gid_to_xyz(g0), gid_to_xyz(g1)
    denom = v1 - v0
    t = torch.where(denom.abs() > 1e-12,
                    -v0 / torch.where(denom == 0, 1.0, denom), 0.5)
    t = torch.clamp(t, 0.0, 1.0)[:, None]
    verts = p0 + t * (p1 - p0)

    # drop degenerate faces (two identical vertex ids)
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    return verts, faces[good]
