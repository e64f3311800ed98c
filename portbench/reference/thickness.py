"""Plain reference of the thickness stage: probability map -> iso-surface
by marching cubes -> components of `filter_threshold` cells or fewer
dropped -> Laplacian smoothing -> inner / outer split by k-means -> each
inner point's distance to the outer surface.

The marching-cubes table, the split's features and the k-means schedule
are frozen copies of the port's plain pieces; the components come from
scipy, the adjacency and the distance are written out here. A mesh is a
pair (vertices (N, 3) f32 x, y, z millimetres, faces (F, 3) int).
`Precision` rounds the smoothed vertices and the distances' operands for
the control.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import sparse
from scipy.sparse.csgraph import connected_components

from portbench.reference.mc_table import _CORNER_OFFSETS, MC_MAX_TRIS, MC_TRI_TABLE
from portbench.reference.ops import Precision

_EDGE_BASE = np.zeros((12, 3), np.int64)
for _e in range(12):
    _others = [a for a in range(3) if a != _e // 4]
    _EDGE_BASE[_e, _others[0]] = (_e % 4) & 1
    _EDGE_BASE[_e, _others[1]] = (_e % 4) >> 1


def _empty():
    return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)


def marching_cubes(vol: torch.Tensor, level: float, spacing_xyz):
    """Iso-surface of an [x, y, z] volume: a vertex on every grid edge whose
    ends fall on both sides of `level`, numbered by edge (x-edges, then y,
    then z, each in C order), triangles from the 256-case table in
    active-cube order."""
    dev = vol.device
    nx, ny, nz = vol.shape
    inside = vol > level
    cross = [(inside[:-1] != inside[1:]).reshape(-1), (inside[:, :-1] != inside[:, 1:]).reshape(-1),
             (inside[:, :, :-1] != inside[:, :, 1:]).reshape(-1)]
    sizes = [c.numel() for c in cross]
    offs = torch.as_tensor([0, sizes[0], sizes[0] + sizes[1]], device=dev)
    mask = torch.cat(cross)
    rank = torch.cumsum(mask, 0) - mask.long()
    vidx = torch.nonzero(mask).squeeze(1)
    axis = (vidx >= offs[1]).long() + (vidx >= offs[2]).long()
    local = vidx - offs[axis]
    shapes = torch.as_tensor([[nx - 1, ny, nz], [nx, ny - 1, nz], [nx, ny, nz - 1]], device=dev)
    sh = shapes[axis]
    plane = sh[:, 1] * sh[:, 2]
    rem = local % plane
    p0 = torch.stack([local // plane, rem // sh[:, 2], rem % sh[:, 2]], dim=-1)
    p1 = p0 + (torch.arange(3, device=dev)[None, :] == axis[:, None]).long()
    flat = vol.reshape(-1)
    va = flat[(p0[:, 0] * ny + p0[:, 1]) * nz + p0[:, 2]]
    vb = flat[(p1[:, 0] * ny + p1[:, 1]) * nz + p1[:, 2]]
    den = vb - va
    t = torch.where(den.abs() > 1e-20, (level - va) / torch.where(den == 0, torch.ones_like(den), den),
                    torch.full_like(den, 0.5)).clamp(0.0, 1.0)
    sp = torch.as_tensor(np.asarray(spacing_xyz, np.float32), device=dev)
    verts = (p0.float() + t[:, None] * (p1 - p0).float()) * sp
    codes = torch.zeros((nx - 1, ny - 1, nz - 1), dtype=torch.uint8, device=dev)
    for ci in range(8):
        ox, oy, oz = (int(o) for o in _CORNER_OFFSETS[ci])
        codes |= inside[ox : nx - 1 + ox, oy : ny - 1 + oy, oz : nz - 1 + oz].to(torch.uint8) << ci
    active = ((codes > 0) & (codes < 255)).reshape(-1)
    cube = torch.nonzero(active).squeeze(1)
    if cube.numel() == 0:
        return _empty()
    tris = torch.as_tensor(MC_TRI_TABLE.astype(np.int64), device=dev)[codes.reshape(-1)[cube].long()]
    slot = torch.nonzero((tris[..., 0] >= 0).reshape(-1)).squeeze(1)
    tcube = cube[slot // MC_MAX_TRIS]
    tedges = tris.reshape(-1, 3)[slot]
    cpos = torch.stack([tcube // ((ny - 1) * (nz - 1)), (tcube // (nz - 1)) % (ny - 1), tcube % (nz - 1)], dim=-1)
    ebase = cpos[:, None, :] + torch.as_tensor(_EDGE_BASE, device=dev)[tedges]
    esh = shapes[tedges // 4]
    elin = (ebase[..., 0] * esh[..., 1] + ebase[..., 1]) * esh[..., 2] + ebase[..., 2]
    faces = rank[elin + offs[tedges // 4]]
    return verts.cpu().numpy(), faces.cpu().numpy().astype(np.int64)


def extract_faces(verts, faces, keep):
    f = faces[np.asarray(keep, np.int64)]
    used, inv = np.unique(f.reshape(-1), return_inverse=True)
    return verts[used], inv.reshape(-1, 3)


def filter_components(verts, faces, threshold: int):
    """Keep the point-connected components of more than `threshold` cells."""
    if len(faces) == 0:
        return verts, faces
    rows = faces[:, [0, 1, 2]].reshape(-1)
    cols = faces[:, [1, 2, 0]].reshape(-1)
    g = sparse.coo_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(len(verts), len(verts)))
    _, labels = connected_components(g, directed=False)
    fl = labels[faces[:, 0]]
    keep = np.isin(fl, np.nonzero(np.bincount(fl) > threshold)[0])
    return extract_faces(verts, faces, np.nonzero(keep)[0])


def smooth(verts, faces, iterations: int, relaxation: float, device, prec: Precision):
    """Laplacian smoothing: v += relaxation (mean of neighbours - v), a
    vertex on the boundary averaging over its boundary neighbours only."""
    if len(verts) == 0:
        return verts
    n = len(verts)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]).astype(np.int64)
    keys, counts = np.unique(e.min(1) * n + e.max(1), return_counts=True)
    uniq = np.stack([keys // n, keys % n], axis=1)
    bnd_edges = uniq[counts == 1]
    is_bnd = np.zeros(n, bool)
    is_bnd[np.unique(bnd_edges)] = True
    src = np.concatenate([uniq[:, 0], uniq[:, 1]])
    dst = np.concatenate([uniq[:, 1], uniq[:, 0]])
    keep = ~is_bnd[src]
    src = np.concatenate([src[keep], bnd_edges[:, 0], bnd_edges[:, 1]])
    dst = np.concatenate([dst[keep], bnd_edges[:, 1], bnd_edges[:, 0]])
    s = torch.as_tensor(src, device=device)
    d = torch.as_tensor(dst, device=device)
    deg = torch.bincount(s, minlength=n).float()[:, None]
    movable = deg > 0
    v = prec.r(torch.as_tensor(verts, device=device))
    for _ in range(iterations):
        acc = torch.zeros_like(v).index_add_(0, s, v[d])
        avg = prec.r(acc / deg.clamp(min=1.0))
        v = torch.where(movable, prec.r(v + relaxation * (avg - v)), v)
    return v.cpu().numpy()


def _normals_centroids(verts, faces):
    tri = verts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    return n, tri.mean(axis=1)


def _norm_centroids(c):
    span = c.max(axis=0) - c.min(axis=0)
    return (c - c.mean(axis=0)) / np.where(span > 0, span, 1.0)


def kmeans2(x, n_iter: int):
    """Lloyd with a farthest-point start (from the mean), labels in the f32
    ||c||^2 - 2 x.c form, stopping when they repeat."""
    x = np.ascontiguousarray(x, np.float32)
    mean = x.mean(axis=0, dtype=np.float32)
    c = np.zeros((2, x.shape[1]), np.float32)
    c[0] = x[int(np.argmax(((x - mean) ** 2).sum(1)))]
    c[1] = x[int(np.argmax(((x - c[0]) ** 2).sum(1)))]
    prev = None
    for _ in range(n_iter):
        labels = np.argmin((c * c).sum(1) - 2.0 * (x @ c.T), axis=1)
        if prev is not None and np.array_equal(labels, prev):
            return labels
        prev = labels
        oh = (labels[:, None] == np.arange(2)[None, :]).astype(np.float32)
        cnt = oh.sum(0)
        sums = oh.T @ x
        nz = cnt > 0
        c[nz] = sums[nz] / cnt[nz, None]
    return np.argmin((c * c).sum(1) - 2.0 * (x @ c.T), axis=1)


def _orient(labels_pm1, normals):
    if not np.any(labels_pm1 == -1):
        return -labels_pm1
    if normals[labels_pm1 == -1, 1].mean() < 0:
        return -labels_pm1
    return labels_pm1


def split(verts, faces, kind: str, divisions: int, n_iter: int):
    """(inner, outer) meshes: tibial, one k = 2 clustering of [normalized
    centroids, 10 x normals]; femoral, the x range cut into bands, each
    clustered on [normalized centroids, normals, (centre - centroid) *
    normal]. The cluster whose mean y-normal is positive is inner."""
    if len(faces) < 2:
        return _empty(), _empty()
    normals, cents = _normals_centroids(verts, faces)
    if kind == "TC":
        feats = np.concatenate([_norm_centroids(cents), normals * 10.0], axis=1)
        labels = _orient(kmeans2(feats, n_iter) * 2 - 1, normals)
    else:
        cn = _norm_centroids(cents)
        center = (verts.min(axis=0) + verts.max(axis=0)) / 2.0
        dot = (center - cents) * normals
        x = cn[:, 0]
        lo_x, hi_x = x.min(), x.max()
        step = (hi_x - lo_x) / divisions
        labels = np.zeros(len(cents))
        for i in range(divisions):
            a = lo_x + step * i
            idx = np.nonzero((x >= a) & (x < a + step))[0]
            if len(idx) < 2:
                continue
            f = np.concatenate([cn[idx], normals[idx], dot[idx]], axis=1)
            labels[idx] = _orient(kmeans2(f, n_iter) * 2 - 1, normals[idx])
    inner = extract_faces(verts, faces, np.nonzero(labels == -1)[0])
    outer = extract_faces(verts, faces, np.nonzero(labels == 1)[0])
    return inner, outer


def _d2_block(p, a, b, c):
    """(P, T) squared distances of points p (P, 3) to triangles (T, 3) each
    corner: the closest point by the triangle's Voronoi regions."""
    p = p[:, None, :]
    ab, ac = (b - a)[None], (c - a)[None]
    ap = p - a[None]
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    bp = p - b[None]
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    cp = p - c[None]
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    v = vb / safe
    w = vc / safe
    q = a[None] + ab * v[..., None] + ac * w[..., None]  # interior
    # the regions by rising precedence: edge bc, edge ac, corner c, edge ab,
    # corner b, corner a
    t_ab = (d1 / torch.where(d1 - d3 == 0, torch.ones_like(d1), d1 - d3)).clamp(0, 1)
    t_ac = (d2 / torch.where(d2 - d6 == 0, torch.ones_like(d2), d2 - d6)).clamp(0, 1)
    t_bc = ((d4 - d3) / torch.where((d4 - d3) + (d5 - d6) == 0, torch.ones_like(d4), (d4 - d3) + (d5 - d6))).clamp(0, 1)
    q = torch.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[..., None],
                    b[None] + (c - b)[None] * t_bc[..., None], q)
    q = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None], a[None] + ac * t_ac[..., None], q)
    q = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c[None].expand_as(q), q)
    q = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None], a[None] + ab * t_ab[..., None], q)
    q = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b[None].expand_as(q), q)
    q = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a[None].expand_as(q), q)
    diff = p - q
    return (diff * diff).sum(-1)


def distance(points, verts, faces, device, prec: Precision, pchunk: int = 1024, tchunk: int = 8192):
    """Unsigned distance of each point to the mesh's surface (zeros where
    there is nothing to measure)."""
    if len(points) == 0 or len(faces) == 0:
        return np.zeros(len(points), np.float32)
    pts = prec.r(torch.as_tensor(points, device=device))
    tri = prec.r(torch.as_tensor(verts[faces], device=device))
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    out = torch.empty(len(points), device=device)
    for p0 in range(0, len(points), pchunk):
        best = None
        for t0 in range(0, len(faces), tchunk):
            d2 = _d2_block(pts[p0 : p0 + pchunk], a[t0 : t0 + tchunk], b[t0 : t0 + tchunk], c[t0 : t0 + tchunk])
            m = d2.amin(dim=1)
            best = m if best is None else torch.minimum(best, m)
        out[p0 : p0 + pchunk] = prec.r(torch.sqrt(best))
    return out.cpu().numpy()


def thickness(prob_zyx: torch.Tensor, spacing_xyz, kind: str, th: dict, prec: Precision):
    """(inner vertices, inner thickness) of one tissue's probability map."""
    dev = prob_zyx.device
    vol = prob_zyx.to(torch.float32).permute(2, 1, 0).contiguous()
    verts, faces = marching_cubes(vol, th["level"], spacing_xyz)
    verts, faces = filter_components(verts, faces, th["filter_threshold"])
    verts = smooth(verts, faces, th["iterations"], th["relaxation"], dev, prec)
    (iv, if_), (ov, of_) = split(verts, faces, kind, th["femoral_divisions"], th["kmeans_iterations"])
    return iv, distance(iv, ov, of_, dev, prec)
