"""Surface reconstruction from fused depth maps + mesh cleanup.

Covers the reference's meshing stage (ref: src/photogrammetrie/mvs/MVS.cpp:130-181:
ReconstructMesh(2.5, ...), 3x mesh.Clean passes with decimation/hole-closing/
smoothing, optional RefineMesh / TextureMesh) with an array formulation:

  * per-view DEPTH-MAP TRIANGULATION: adjacent valid pixels connect into two
    triangles per quad unless a depth discontinuity splits them — a dense,
    fully-array-parallel operation (openMVS instead runs sequential Delaunay
    tetra carving; that shape does not vectorize)
  * cross-view merge by VERTEX CLUSTERING on a world-space grid (also the
    decimation operator, standing in for openMVS decimate; --no-decimate
    keeps the native resolution)
  * LAPLACIAN SMOOTHING (k passes; ref smoothing factor 2, MVS.h:68)
  * degenerate/duplicate-face removal (the Clean passes)

Vertex colors come from the per-view images (per-vertex coloring; UV-atlas
texturing is the --refine-mesh/texture long tail, MVS.cpp:175-178).

Port of sfm_mvs_pipeline_tpu/mvs/mesh.py: host numpy, with the
back-projection of depth_map_to_mesh on the device (mvs/fusion.py).
cluster_vertices refuses, with a plain error, a grid whose packed key would
overflow int64 (the JAX package does not check).
"""

from __future__ import annotations

import numpy as np

from sfm_mvs_pipeline_tpu_torch.utils.stage_timer import stage


def depth_map_to_mesh(
    depth: np.ndarray,  # (H, W)
    valid: np.ndarray,  # (H, W)
    pose: np.ndarray,  # (6,)
    intr: np.ndarray,  # (7,)
    rgb: np.ndarray | None = None,  # (H, W, 3)
    max_depth_ratio: float = 0.05,
    stride: int = 1,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Triangulate one view's depth map, back-projecting on `device`
    (default: the card; raises without one). Returns (vertices, faces,
    colors)."""
    import torch

    from sfm_mvs_pipeline_tpu_torch import resolve_device
    from sfm_mvs_pipeline_tpu_torch.mvs.fusion import unproject_depth

    d = depth[::stride, ::stride]
    v = valid[::stride, ::stride]
    h, w = d.shape
    intr_s = intr.copy()
    intr_s[:3] = intr[:3] / stride
    dev = resolve_device(device)
    pts, _ = unproject_depth(
        torch.as_tensor(np.ascontiguousarray(d), dtype=torch.float32, device=dev), None,
        torch.as_tensor(pose, dtype=torch.float32, device=dev),
        torch.as_tensor(intr_s, dtype=torch.float32, device=dev),
    )
    pts = pts.cpu().numpy().reshape(h, w, 3)

    idx = np.arange(h * w).reshape(h, w)
    a = idx[:-1, :-1]
    b = idx[:-1, 1:]
    c = idx[1:, :-1]
    e = idx[1:, 1:]
    va = v[:-1, :-1]
    vb = v[:-1, 1:]
    vc = v[1:, :-1]
    ve = v[1:, 1:]
    da = d[:-1, :-1]
    db = d[:-1, 1:]
    dc = d[1:, :-1]
    de = d[1:, 1:]

    def smooth(x, y):
        m = np.minimum(x, y)
        return np.abs(x - y) <= max_depth_ratio * np.maximum(m, 1e-9)

    t1_ok = va & vb & vc & smooth(da, db) & smooth(da, dc) & smooth(db, dc)
    t2_ok = vb & ve & vc & smooth(db, de) & smooth(db, dc) & smooth(de, dc)
    f1 = np.stack([a[t1_ok], c[t1_ok], b[t1_ok]], axis=1)
    f2 = np.stack([b[t2_ok], c[t2_ok], e[t2_ok]], axis=1)
    faces = np.concatenate([f1, f2])

    verts = pts.reshape(-1, 3)
    cols = None
    if rgb is not None:
        cols = rgb[::stride, ::stride].reshape(-1, 3)
    # compact to used vertices
    used = np.unique(faces)
    remap = np.full(h * w, -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces], (cols[used] if cols is not None else None)


def cluster_vertices(
    vertices: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray | None,
    cell: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Vertex-clustering merge/decimation on a world grid of size `cell`."""
    if len(vertices) == 0:
        return vertices, faces, colors
    keys = np.floor(vertices / cell).astype(np.int64)
    # pack the 3 cell coordinates into ONE int64 key: np.unique on a 1D
    # array sorts 8-byte scalars instead of lexsorting rows (axis=0 cost
    # 31 s on the 7.8M-vertex big scene; packed ~4 s)
    keys -= keys.min(axis=0)
    r = keys.max(axis=0).astype(np.int64) + 1
    if int(r[0]) * int(r[1]) * int(r[2]) > np.iinfo(np.int64).max:
        raise ValueError(
            f"vertex grid of {int(r[0])} x {int(r[1])} x {int(r[2])} cells (cell {cell}) "
            "does not fit a packed int64 key; use a larger cell"
        )
    packed = (keys[:, 0] * r[1] + keys[:, 1]) * r[2] + keys[:, 2]
    _, inv, counts = np.unique(
        packed, return_inverse=True, return_counts=True
    )
    n_clusters = counts.shape[0]
    # bincount per column: np.add.at's buffered scatter cost ~20 s on the
    # 7.8M-vertex big scene; bincount is a tight counting loop
    new_verts = np.stack(
        [
            np.bincount(inv, weights=vertices[:, c], minlength=n_clusters)
            for c in range(3)
        ],
        axis=1,
    ) / counts[:, None]
    new_cols = None
    if colors is not None:
        cacc = np.stack(
            [
                np.bincount(
                    inv,
                    weights=colors[:, c].astype(np.float64),
                    minlength=n_clusters,
                )
                for c in range(3)
            ],
            axis=1,
        )
        new_cols = np.clip(cacc / counts[:, None], 0, 255).astype(np.uint8)
    new_faces = inv[faces]
    # drop degenerate + duplicate faces (the Clean pass)
    ok = (
        (new_faces[:, 0] != new_faces[:, 1])
        & (new_faces[:, 1] != new_faces[:, 2])
        & (new_faces[:, 0] != new_faces[:, 2])
    )
    new_faces = new_faces[ok]
    key = np.sort(new_faces, axis=1).astype(np.int64)
    if n_clusters <= 2_000_000:  # n^3 must stay inside int64
        n = np.int64(n_clusters)
        packed_f = (key[:, 0] * n + key[:, 1]) * n + key[:, 2]
        _, uniq = np.unique(packed_f, return_index=True)
    else:
        _, uniq = np.unique(key, axis=0, return_index=True)
    return new_verts, new_faces[np.sort(uniq)], new_cols


def laplacian_smooth(
    vertices: np.ndarray, faces: np.ndarray, iterations: int = 2, lam: float = 0.5
) -> np.ndarray:
    """Uniform Laplacian smoothing (ref smoothing factor 2, MVS.h:68)."""
    if len(vertices) == 0 or len(faces) == 0:
        return vertices
    v = vertices.copy()
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]],
         faces[:, [1, 0]], faces[:, [2, 1]], faces[:, [0, 2]]]
    )
    for _ in range(iterations):
        acc = np.zeros_like(v)
        cnt = np.zeros(len(v))
        np.add.at(acc, e[:, 0], v[e[:, 1]])
        np.add.at(cnt, e[:, 0], 1.0)
        has = cnt > 0
        mean = np.where(has[:, None], acc / np.maximum(cnt, 1)[:, None], v)
        v = v + lam * (mean - v)
    return v


def close_holes(
    vertices: np.ndarray,
    faces: np.ndarray,
    colors,
    max_edges: int = 30,
):
    """Close small boundary loops by fan triangulation.

    Parity with the reference's hole-closing Clean passes
    (ref: src/photogrammetrie/mvs/MVS.cpp:160-166 — ``mesh.Clean(...)`` with
    close-holes 30, src/photogrammetrie/mvs/MVS.h:67). A boundary edge is a
    directed edge that appears in exactly one face; boundary loops with at
    most ``max_edges`` edges are filled with a fan around their centroid
    (one new vertex per hole, so the fill shares the hole's scale).
    """
    if len(faces) == 0:
        return vertices, faces, colors
    # directed edges counted WITH multiplicity: an edge used by one face and
    # never in reverse is a boundary; an edge duplicated with the same
    # winding (degenerate duplicated faces) is not a clean boundary.
    # Packed-int64 vectorization — the previous python Counter over the
    # 5.4M edge tuples of the big scene cost ~10 s on its own
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    nv64 = np.int64(len(vertices))
    packed = e[:, 0].astype(np.int64) * nv64 + e[:, 1]
    uniq_e, n_e = np.unique(packed, return_counts=True)
    once = uniq_e[n_e == 1]
    rev = (once % nv64) * nv64 + once // nv64
    is_boundary = ~np.isin(rev, uniq_e)
    ba = once[is_boundary] // nv64
    bb = once[is_boundary] % nv64
    boundary = list(zip(ba.tolist(), bb.tolist()))
    if not boundary:
        return vertices, faces, colors
    # boundary edges of a manifold-with-border mesh chain b->a around holes;
    # walk successor pointers to extract loops. A vertex with >1 outgoing
    # boundary edge is a non-manifold pinch (vertex clustering can produce
    # these) — loops through it are ambiguous, so exclude them.
    nxt = {}
    pinched = set()
    for a, b in boundary:
        if a in nxt:
            pinched.add(a)
        else:
            nxt[a] = b
    seen = set(pinched)
    new_v, new_f, new_c = [], [], []
    base = len(vertices)
    for start in list(nxt):
        if start in seen:
            continue
        loop = [start]
        seen.add(start)
        cur = nxt[start]
        ok = True
        while cur != start:
            if cur in seen or cur not in nxt or len(loop) > max_edges:
                ok = False
                break
            loop.append(cur)
            seen.add(cur)
            cur = nxt[cur]
        if not ok or len(loop) < 3 or len(loop) > max_edges:
            continue
        centroid = vertices[loop].mean(axis=0)
        ci = base + len(new_v)
        new_v.append(centroid)
        if colors is not None:
            new_c.append(colors[loop].astype(np.float64).mean(axis=0))
        # fan orientation: boundary runs opposite to face winding, so
        # (b, a, centroid) keeps the fill consistent with its neighbors
        for k in range(len(loop)):
            a, b = loop[k], loop[(k + 1) % len(loop)]
            new_f.append((b, a, ci))
    if not new_v:
        return vertices, faces, colors
    vertices = np.concatenate([vertices, np.asarray(new_v)])
    faces = np.concatenate([faces, np.asarray(new_f, dtype=faces.dtype)])
    if colors is not None:
        colors = np.concatenate(
            [colors, np.clip(np.asarray(new_c), 0, 255).astype(colors.dtype)]
        )
    return vertices, faces, colors


def remove_small_components(
    vertices: np.ndarray, faces: np.ndarray, colors, min_faces: int = 50
):
    """Drop small disconnected islands (part of the Clean behavior)."""
    if len(faces) == 0:
        return vertices, faces, colors
    # sparse connected components over the face-edge graph (the Python
    # union-find loop cost 19 s on the 1.8M-face big scene; <1 s sparse)
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    nv = len(vertices)
    rows = np.concatenate([faces[:, 0], faces[:, 1]])
    cols_ = np.concatenate([faces[:, 1], faces[:, 2]])
    g = coo_matrix(
        (np.ones(len(rows), np.int8), (rows, cols_)), shape=(nv, nv)
    )
    _, labels = connected_components(g, directed=False)
    roots = labels[faces[:, 0]]
    uniq, counts = np.unique(roots, return_counts=True)
    big = uniq[counts >= min_faces]
    keep = np.isin(roots, big)
    faces = faces[keep]
    used = np.unique(faces)
    remap = np.full(len(vertices), -1, np.int64)
    remap[used] = np.arange(len(used))
    return (
        vertices[used],
        remap[faces],
        colors[used] if colors is not None else None,
    )


def mesh_from_depth_maps(
    depth_maps: np.ndarray,
    valids: np.ndarray,
    poses: np.ndarray,
    intr: np.ndarray,
    rgbs: np.ndarray | None = None,
    decimate: bool = True,
    smooth_iters: int = 2,
    close_holes_edges: int = 30,
    log=lambda *a: None,
    device=None,
) -> dict:
    """Full meshing pass over all views; the back-projection runs on
    `device` (default: the card), the rest is host numpy. Each step is a
    span of its own ("mesh backproject", "mesh cluster", "mesh
    components", "mesh holes", "mesh smooth"; utils/stage_timer.py)."""
    all_v, all_f, all_c = [], [], []
    off = 0
    with stage("mesh backproject"):
        for i in range(len(depth_maps)):
            if not valids[i].any():
                continue
            v, f, c = depth_map_to_mesh(
                depth_maps[i], valids[i], poses[i], intr,
                rgbs[i] if rgbs is not None else None, device=device,
            )
            all_v.append(v)
            all_f.append(f + off)
            if c is not None:
                all_c.append(c)
            off += len(v)
        if not all_v:
            return {"vertices": np.zeros((0, 3)), "faces": np.zeros((0, 3), int)}
        V = np.concatenate(all_v)
        F = np.concatenate(all_f)
        C = np.concatenate(all_c) if all_c else None
    log(f"raw mesh: {len(V)} verts, {len(F)} faces")

    with stage("mesh cluster"):
        # merge/decimate cell: median NN scale of the vertex soup
        bbox = V.max(0) - V.min(0)
        target = 1.5e-3 if decimate else 5e-4
        cell = float(np.linalg.norm(bbox)) * target * (4 if decimate else 1)
        V, F, C = cluster_vertices(V, F, C, max(cell, 1e-9))
    log(f"clustered: {len(V)} verts, {len(F)} faces (cell {cell:.4g})")

    with stage("mesh components"):
        V, F, C = remove_small_components(V, F, C)
    log(f"small components removed: {len(V)} verts, {len(F)} faces")
    with stage("mesh holes"):
        V, F, C = close_holes(V, F, C, max_edges=close_holes_edges)
    log(f"holes closed: {len(V)} verts, {len(F)} faces")
    with stage("mesh smooth"):
        V = laplacian_smooth(V, F, smooth_iters)
    log(f"cleaned: {len(V)} verts, {len(F)} faces")
    return {"vertices": V, "faces": F, "colors": C}
