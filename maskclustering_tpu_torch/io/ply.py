"""Minimal self-contained PLY point-cloud I/O.

Copy of ``maskclustering_tpu/io/ply.py:25-220`` (pure numpy): the subset of
PLY the dataset loaders need, vertex positions (+ optional colors) and
triangle faces with per-face scalars, in binary (either byte order) or
ascii format.
"""

from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(f):
    """Parse a PLY header. Returns (format, elements, header_end_offset).

    elements is a list of (name, count, [(prop_name, np_dtype_str), ...]).
    List properties (e.g. face vertex_indices) are recorded with dtype None
    and a (count_type, item_type) tuple instead.
    """
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", errors="replace").strip().split()
        if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                elements[-1][2].append((tokens[4], None, (_PLY_TO_NP[tokens[2]], _PLY_TO_NP[tokens[3]])))
            else:
                elements[-1][2].append((tokens[2], _PLY_TO_NP[tokens[1]], None))
        elif tokens[0] == "end_header":
            break
    return fmt, elements


def read_ply_points(path: str, return_colors: bool = False):
    """Read vertex x/y/z (and optionally r/g/b) from a PLY file.

    Returns (N,3) float64 positions, or a (positions, colors_uint8) tuple.
    """
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        endian = "<" if fmt in ("binary_little_endian", "ascii") else ">"
        verts = None
        colors = None
        for name, count, props in elements:
            has_list = any(p[1] is None for p in props)
            if fmt == "ascii":
                if name == "vertex":
                    names = [p[0] for p in props]
                    rows = [f.readline().split() for _ in range(count)]
                    arr = np.array(rows, dtype=np.float64)
                    ix = [names.index(c) for c in ("x", "y", "z")]
                    verts = arr[:, ix]
                    if return_colors and all(c in names for c in ("red", "green", "blue")):
                        ic = [names.index(c) for c in ("red", "green", "blue")]
                        colors = arr[:, ic].astype(np.uint8)
                else:
                    for _ in range(count):
                        f.readline()
            else:
                if has_list:
                    # ragged element (faces): must walk it item by item to skip
                    for _ in range(count):
                        for _, dt, list_dt in props:
                            if dt is None:
                                ct, it = list_dt
                                n = int(np.frombuffer(f.read(np.dtype(ct).itemsize), dtype=endian + ct)[0])
                                f.read(n * np.dtype(it).itemsize)
                            else:
                                f.read(np.dtype(dt).itemsize)
                    continue
                dtype = np.dtype([(p[0], endian + p[1]) for p in props])
                data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
                if name == "vertex":
                    verts = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float64)
                    if return_colors and all(c in dtype.names for c in ("red", "green", "blue")):
                        colors = np.stack([data["red"], data["green"], data["blue"]], axis=1).astype(np.uint8)
    if verts is None:
        raise ValueError(f"no vertex element found in {path}")
    if return_colors:
        return verts, colors
    return verts


def read_ply_mesh(path: str):
    """Read a PLY mesh: vertices, triangle faces, and per-face scalar props.

    Returns ``(verts (N,3) float64, faces (F,3) int64, face_props dict)``.
    face_props maps scalar property names on the face element (e.g.
    ``category_id`` in Matterport house_segmentations meshes, reference
    preprocess/matterport3d/process.py:32-35) to (F,) arrays. Handles
    binary little/big endian and ascii; assumes uniform triangle faces on
    the fast path with a ragged fallback.
    """
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        endian = "<" if fmt in ("binary_little_endian", "ascii") else ">"
        verts = None
        faces = None
        face_props: dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    names = [p[0] for p in props]
                    arr = np.array(rows, dtype=np.float64)
                    ix = [names.index(c) for c in ("x", "y", "z")]
                    verts = arr[:, ix]
                elif name == "face" and count:
                    out_faces, scalars = [], {p[0]: [] for p in props if p[1] is not None}
                    for row in rows:
                        pos = 0
                        for pname, dt, _list_dt in props:
                            if dt is None:
                                n = int(row[pos])
                                out_faces.append([int(v) for v in row[pos + 1:pos + 1 + n]])
                                pos += 1 + n
                            else:
                                scalars[pname].append(float(row[pos]))
                                pos += 1
                    # truncate polygons to their first triangle, matching the
                    # binary paths' (F,3) contract
                    faces = np.asarray([t[:3] for t in out_faces], dtype=np.int64)
                    face_props = {k: np.asarray(v) for k, v in scalars.items()}
                continue
            has_list = any(p[1] is None for p in props)
            if not has_list:
                dtype = np.dtype([(p[0], endian + p[1]) for p in props])
                data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
                if name == "vertex":
                    verts = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float64)
                continue
            if count == 0:
                continue
            # face-like element: try the uniform-triangle fast path first
            start = f.tell()
            (lname, _, (ct, it)) = next(p for p in props if p[1] is None)
            n0 = int(np.frombuffer(f.read(np.dtype(ct).itemsize), dtype=endian + ct)[0])
            f.seek(start)
            fields = []
            for pname, dt, list_dt in props:
                if dt is None:
                    fields.append(("_n", endian + list_dt[0]))
                    fields.append(("_idx", endian + list_dt[1], (n0,)))
                else:
                    fields.append((pname, endian + dt))
            dtype = np.dtype(fields)
            raw = f.read(count * dtype.itemsize)
            # a ragged element can leave fewer bytes than the uniform guess
            # (e.g. a leading quad followed by triangles at EOF)
            uniform = len(raw) == count * dtype.itemsize
            data = np.frombuffer(raw, dtype=dtype) if uniform else None
            if not uniform or not np.all(data["_n"] == n0):  # ragged: slow walk
                f.seek(start)
                out_faces, scalars = [], {p[0]: [] for p in props if p[1] is not None}
                for _ in range(count):
                    for pname, dt, list_dt in props:
                        if dt is None:
                            ct_, it_ = list_dt
                            n = int(np.frombuffer(f.read(np.dtype(ct_).itemsize), dtype=endian + ct_)[0])
                            out_faces.append(np.frombuffer(f.read(n * np.dtype(it_).itemsize), dtype=endian + it_).astype(np.int64))
                        else:
                            scalars[pname].append(np.frombuffer(f.read(np.dtype(dt).itemsize), dtype=endian + dt)[0])
                if name == "face":
                    faces = np.asarray([t[:3] for t in out_faces], dtype=np.int64)
                    face_props = {k: np.asarray(v) for k, v in scalars.items()}
                continue
            if name == "face":
                faces = data["_idx"][:, :3].astype(np.int64)
                face_props = {p[0]: np.ascontiguousarray(data[p[0]]) for p in props if p[1] is not None}
    if verts is None:
        raise ValueError(f"no vertex element found in {path}")
    if faces is None:
        faces = np.zeros((0, 3), dtype=np.int64)
    return verts, faces, face_props


def write_ply_points(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Write an (N,3) point cloud as binary-little-endian PLY."""
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.empty(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if colors is not None:
        colors = np.asarray(colors, dtype=np.uint8)
        rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {c}" for c in ("x", "y", "z")]
    if colors is not None:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
