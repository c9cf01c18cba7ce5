"""Binary PLY IO: point clouds (colors/normals), camera frustums, meshes.

Replaces the reference's hand-rolled PLY writers:
  * sparse cloud writer        (ref: src/photogrammetrie/util/PclUtils.cpp:401-460)
  * camera-frustum writer      (ref: PclUtils.cpp:466-590)
  * dense cloud + mesh writers (ref: src/photogrammetrie/util/OpenMvsUtils.cpp:214-448)
  * quality-colored cloud      (ref: PclUtils.cpp:91-265)

Files are binary little-endian like the reference (endianness probe:
src/photogrammetrie/util/Endians.cpp:8-13 — numpy's '<' dtypes make that
explicit here).

Port of sfm_mvs_pipeline_tpu/utils/ply.py: the writers take the native
C++ tier (sfm_mvs_pipeline_tpu_torch/native) when it is built, else numpy.
"""

from __future__ import annotations

import numpy as np


def write_ply_points(
    path: str,
    points: np.ndarray,  # (N, 3)
    colors: np.ndarray | None = None,  # (N, 3|4) uint8
    normals: np.ndarray | None = None,  # (N, 3)
) -> None:
    # native C++ writer fast path (alpha stays on the numpy path: the
    # native writer emits rgb only)
    if colors is None or colors.shape[1] == 3:
        from sfm_mvs_pipeline_tpu_torch import native

        if native.write_ply_native(path, points, colors, normals):
            return
    n = len(points)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    header += ["property float x", "property float y", "property float z"]
    if normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
        if colors.shape[1] == 4:
            fields += [("alpha", "u1")]
            header += ["property uchar alpha"]
    header += ["end_header"]

    rec = np.empty(n, dtype=fields)
    rec["x"], rec["y"], rec["z"] = (points[:, i].astype(np.float32) for i in range(3))
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = (
            normals[:, i].astype(np.float32) for i in range(3)
        )
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = (
            colors[:, i].astype(np.uint8) for i in range(3)
        )
        if colors.shape[1] == 4:
            rec["alpha"] = colors[:, 3].astype(np.uint8)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        rec.tofile(f)


def write_ply_mesh(
    path: str,
    vertices: np.ndarray,  # (V, 3)
    faces: np.ndarray,  # (F, 3) int
    colors: np.ndarray | None = None,  # (V, 3) uint8
    normals: np.ndarray | None = None,
) -> None:
    from sfm_mvs_pipeline_tpu_torch import native

    if native.write_ply_native(path, vertices, colors, normals, np.asarray(faces)):
        return
    v = len(vertices)
    fc = len(faces)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {v}"]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    header += ["property float x", "property float y", "property float z"]
    if normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    header += [
        f"element face {fc}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    rec = np.empty(v, dtype=fields)
    rec["x"], rec["y"], rec["z"] = (
        vertices[:, i].astype(np.float32) for i in range(3)
    )
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = (
            normals[:, i].astype(np.float32) for i in range(3)
        )
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = (
            colors[:, i].astype(np.uint8) for i in range(3)
        )
    frec = np.empty(fc, dtype=[("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
    frec["n"] = 3
    frec["a"], frec["b"], frec["c"] = (faces[:, i].astype(np.int32) for i in range(3))
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        rec.tofile(f)
        frec.tofile(f)


def read_ply(path: str) -> dict:
    """Minimal binary/ascii PLY reader for points (+colors +normals +faces)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n")
    if head_end < 0:
        raise ValueError("not a PLY file")
    header = data[:head_end].decode("ascii", "replace").splitlines()
    body = data[head_end + len(b"end_header\n"):]

    fmt = None
    elements = []  # (name, count, [(prop, type) or ("list", ...)])
    cur = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = {"name": parts[1], "count": int(parts[2]), "props": []}
            elements.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur["props"].append(("list", parts[2], parts[3], parts[4]))
            else:
                cur["props"].append((parts[2], parts[1]))

    tmap = {
        "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
        "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
        "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
        "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    }
    out = {}
    offset = 0
    if fmt == "ascii":
        text = body.decode().split()
        ti = 0
        for el in elements:
            if any(p[0] == "list" for p in el["props"]):
                faces = []
                for _ in range(el["count"]):
                    for p in el["props"]:
                        if p[0] == "list":
                            k = int(text[ti]); ti += 1
                            if p[3] in ("vertex_indices", "vertex_index"):
                                faces.append(
                                    [int(text[ti + j]) for j in range(k)]
                                )
                            ti += k
                        else:
                            ti += 1
                out["faces"] = np.asarray(faces)
            else:
                names = [p[0] for p in el["props"]]
                vals = np.array(
                    text[ti : ti + el["count"] * len(names)], dtype=np.float64
                ).reshape(el["count"], len(names))
                ti += el["count"] * len(names)
                for i, nm in enumerate(names):
                    out.setdefault(el["name"], {})[nm] = vals[:, i]
        return _organize(out)

    for el in elements:
        if any(p[0] == "list" for p in el["props"]):
            # face-like element: walk EVERY property per face; keep the
            # vertex index list, skip other lists (e.g. per-face texcoord
            # written by write_ply_mesh_textured) and scalar props
            faces = []
            for _ in range(el["count"]):
                for p in el["props"]:
                    if p[0] == "list":
                        cdt = np.dtype(tmap[p[1]])
                        idt = np.dtype(tmap[p[2]])
                        k = int(np.frombuffer(body, cdt, 1, offset)[0])
                        offset += cdt.itemsize
                        if p[3] in ("vertex_indices", "vertex_index"):
                            faces.append(
                                np.frombuffer(body, idt, k, offset).copy()
                            )
                        offset += idt.itemsize * k
                    else:
                        offset += np.dtype(tmap[p[1]]).itemsize
            out["faces"] = np.asarray(faces)
        else:
            dt = np.dtype([(p[0], tmap[p[1]]) for p in el["props"]])
            rec = np.frombuffer(body, dt, el["count"], offset)
            offset += dt.itemsize * el["count"]
            out[el["name"]] = {p[0]: rec[p[0]].copy() for p in el["props"]}
    return _organize(out)


def _organize(raw: dict) -> dict:
    out = {}
    v = raw.get("vertex", {})
    if {"x", "y", "z"} <= set(v):
        out["points"] = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    if {"red", "green", "blue"} <= set(v):
        out["colors"] = np.stack(
            [v["red"], v["green"], v["blue"]], axis=1
        ).astype(np.uint8)
    if {"nx", "ny", "nz"} <= set(v):
        out["normals"] = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(
            np.float64
        )
    if "faces" in raw:
        out["faces"] = raw["faces"]
    return out


def write_camera_frustums_ply(
    path: str,
    poses: np.ndarray,  # (S, 6) recovered only
    intrinsics: np.ndarray,  # (7,) shared intrinsics
    image_size: tuple[int, int],
    scale: float = 0.2,
) -> None:
    """Camera frustum wireframes + RGB world axes as colored edge segments,
    mirroring PclUtils::writeToPLY(scene...) (ref: PclUtils.cpp:466-590):
    5 vertices + 8 edges per camera, plus coordinate axes at the origin.

    Edges are emitted as degenerate triangles (a, b, b) so standard viewers
    render them; the reference writes explicit edge elements."""
    from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np

    w, h = image_size
    f = float(intrinsics[0])
    verts, cols, faces = [], [], []
    depth = scale
    hw = w / (2 * f) * depth
    hh = h / (2 * f) * depth
    for pose in poses:
        R = aa_to_rotmat_np(pose[:3])
        t = pose[3:]
        C = -R.T @ t
        corners_cam = np.array(
            [
                [0, 0, 0],
                [-hw, -hh, depth],
                [hw, -hh, depth],
                [hw, hh, depth],
                [-hw, hh, depth],
            ]
        )
        corners = corners_cam @ R + C  # R.T @ x + C for each row
        base = len(verts)
        verts.extend(corners)
        cols.extend([[0, 255, 0]] * 5)
        edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
        for a, b in edges:
            faces.append([base + a, base + b, base + b])
    # world axes (RGB = XYZ) like the reference
    base = len(verts)
    axis_len = scale * 2
    verts.extend(
        [
            [0, 0, 0], [axis_len, 0, 0],
            [0, 0, 0], [0, axis_len, 0],
            [0, 0, 0], [0, 0, axis_len],
        ]
    )
    cols.extend(
        [[255, 0, 0]] * 2 + [[0, 255, 0]] * 2 + [[0, 0, 255]] * 2
    )
    for i in range(3):
        faces.append([base + 2 * i, base + 2 * i + 1, base + 2 * i + 1])
    write_ply_mesh(
        path,
        np.asarray(verts, np.float64),
        np.asarray(faces, np.int64),
        colors=np.asarray(cols, np.uint8),
    )
