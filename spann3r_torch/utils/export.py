"""Artifact export: PLY point clouds, Nerfstudio transforms.json, GLB.

Pure-python writers (no open3d/trimesh dependency).  Contracts from
reference demo.py:43-72,199-253 and app.py:150-171.
"""
from __future__ import annotations

import json
import struct
from typing import List, Optional

import numpy as np


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY with optional uint8 colors in [0,1] float."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = len(pts)
    has_color = colors is not None
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            cols = np.asarray(colors).reshape(-1, 3)
            if cols.dtype != np.uint8:
                cols = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                     ("rgb", np.uint8, 3)])
            rec["xyz"] = pts
            rec["rgb"] = cols
            f.write(rec.tobytes())
        else:
            f.write(pts.tobytes())


def read_ply(path: str):
    """Minimal reader for the PLYs this module writes (tests/tools)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(l for l in header if l.startswith("element vertex")
                     ).split()[-1])
        has_color = any("uchar red" in l for l in header)
        if has_color:
            rec = np.frombuffer(f.read(n * 15), dtype=[("xyz", np.float32, 3),
                                                       ("rgb", np.uint8, 3)])
            return rec["xyz"].copy(), rec["rgb"].copy()
        pts = np.frombuffer(f.read(n * 12), dtype=np.float32).reshape(n, 3)
        return pts.copy(), None


def transforms_json(h: int, w: int, focal: float, poses: List[np.ndarray],
                    ply_file_path: str, ori_paths: Optional[List[str]] = None
                    ) -> dict:
    """Nerfstudio transforms dict (ref demo.py:43-72); converts CV->GL."""
    d = {"w": w, "h": h, "fl_x": float(focal), "fl_y": float(focal),
         "cx": w / 2, "cy": h / 2, "k1": 0, "k2": 0, "p1": 0, "p2": 0,
         "camera_model": "OPENCV"}
    frames = []
    for i, pose in enumerate(poses):
        pose = np.asarray(pose).copy()
        pose[:3, 1] *= -1
        pose[:3, 2] *= -1
        frames.append({
            "file_path": (f"imgs/img_{i:04d}.png" if ori_paths is None
                          else ori_paths[i]),
            "transform_matrix": pose.tolist()})
    d["frames"] = frames
    d["ply_file_path"] = ply_file_path
    return d


def pts3d_to_mesh(img: np.ndarray, pts3d: np.ndarray,
                  valid: Optional[np.ndarray] = None) -> dict:
    """Per-pixel quad mesh from a dense pointmap (ref dust3r/viz.py:79-114
    pts3d_to_trimesh, consumed by app.py:160-163 mesh mode).

    Each pixel quad becomes the reference's two unique triangles
    (TL,TR,BL) and (TR,BL,BR); the reference also appends reversed copies
    purely to defeat back-face culling — the GLB writer here sets
    doubleSided instead.  Faces whose 3 vertices aren't all valid are
    dropped (conf mask).  Returns vertices (N,3) f32, faces (F,3) u32,
    face_colors (F,3) from the TL / BR pixel like the reference, and
    vertex_colors (N,3) for writers that color at vertices."""
    h, w, _ = img.shape
    assert pts3d.shape == (h, w, 3)
    vertices = np.asarray(pts3d, np.float32).reshape(-1, 3)

    idx = np.arange(h * w).reshape(h, w)
    tl = idx[:-1, :-1].ravel()
    tr = idx[:-1, 1:].ravel()
    bl = idx[1:, :-1].ravel()
    br = idx[1:, 1:].ravel()
    faces = np.concatenate((np.c_[tl, tr, bl], np.c_[tr, bl, br]),
                           axis=0).astype(np.uint32)
    face_colors = np.concatenate((
        np.asarray(img, np.float32)[:-1, :-1].reshape(-1, 3),
        np.asarray(img, np.float32)[1:, 1:].reshape(-1, 3)), axis=0)

    if valid is not None:
        assert valid.shape == (h, w)
        ok = valid.ravel()[faces].all(axis=-1)
        faces = faces[ok]
        face_colors = face_colors[ok]

    return dict(vertices=vertices, faces=faces, face_colors=face_colors,
                vertex_colors=np.asarray(img, np.float32).reshape(-1, 3))


def cat_meshes(meshes: List[dict]) -> dict:
    """Concatenate per-frame meshes with vertex reindexing
    (ref dust3r/viz.py:117-127)."""
    off = np.cumsum([0] + [len(m["vertices"]) for m in meshes[:-1]])
    return dict(
        vertices=np.concatenate([m["vertices"] for m in meshes]),
        faces=np.concatenate([m["faces"] + np.uint32(o)
                              for m, o in zip(meshes, off)]),
        face_colors=np.concatenate([m["face_colors"] for m in meshes]),
        vertex_colors=np.concatenate([m["vertex_colors"] for m in meshes]))


def write_glb_mesh(path: str, vertices: np.ndarray, faces: np.ndarray,
                   vertex_colors: Optional[np.ndarray] = None) -> None:
    """GLB with a TRIANGLES-mode doubleSided mesh, uint32 indices, optional
    per-vertex COLOR_0 (the GLB-native encoding of the reference's
    trimesh face-color export, app.py:150-171)."""
    pts = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    idx = np.asarray(faces, dtype=np.uint32).reshape(-1, 3)
    if len(idx):
        assert idx.max() < len(pts), "face index out of range"
    n = len(pts)

    buffers = [pts.tobytes(), idx.tobytes()]
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": len(buffers[0])},
             {"buffer": 0, "byteOffset": len(buffers[0]),
              "byteLength": len(buffers[1])}]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": n, "type": "VEC3",
         "min": pts.min(axis=0).tolist() if n else [0, 0, 0],
         "max": pts.max(axis=0).tolist() if n else [0, 0, 0]},
        {"bufferView": 1, "componentType": 5125, "count": idx.size,
         "type": "SCALAR"},
    ]
    attributes = {"POSITION": 0}

    if vertex_colors is not None:
        cols = np.asarray(vertex_colors).reshape(-1, 3)
        if cols.dtype == np.uint8:
            cols = cols.astype(np.float32) / 255.0
        cols = np.clip(cols, 0, 1).astype(np.float32)
        off = sum(len(b) for b in buffers)
        buffers.append(cols.tobytes())
        views.append({"buffer": 0, "byteOffset": off,
                      "byteLength": len(buffers[-1])})
        accessors.append({"bufferView": 2, "componentType": 5126, "count": n,
                          "type": "VEC3"})
        attributes["COLOR_0"] = 2

    bin_blob = b"".join(buffers)
    bin_blob += b"\x00" * ((-len(bin_blob)) % 4)

    gltf = {
        "asset": {"version": "2.0", "generator": "spann3r_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attributes, "indices": 1,
                                    "material": 0, "mode": 4}]}],
        "materials": [{"doubleSided": True,
                       "pbrMetallicRoughness": {"metallicFactor": 0.0}}],
        "buffers": [{"byteLength": len(bin_blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    json_blob = json.dumps(gltf).encode("utf-8")
    json_blob += b" " * ((-len(json_blob)) % 4)

    total = 12 + 8 + len(json_blob) + 8 + len(bin_blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_blob), 0x4E4F534A))
        f.write(json_blob)
        f.write(struct.pack("<II", len(bin_blob), 0x004E4942))
        f.write(bin_blob)


def write_glb_scene(path: str, mesh: Optional[dict] = None,
                    points: Optional[np.ndarray] = None,
                    point_colors: Optional[np.ndarray] = None) -> None:
    """GLB with a TRIANGLES primitive (mesh dict per pts3d_to_mesh contract)
    and/or a POINTS primitive in one scene — the standalone equivalent of
    the reference's trimesh.Scene export (dust3r/viz.py:118-155 SceneViz)."""
    buffers: list = []
    views: list = []
    accessors: list = []
    primitives: list = []

    def add_view(blob):
        off = sum(len(b) for b in buffers)
        buffers.append(blob)
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(blob)})
        return len(views) - 1

    def add_pos(pts):
        pts = np.ascontiguousarray(pts, np.float32).reshape(-1, 3)
        v = add_view(pts.tobytes())
        accessors.append({"bufferView": v, "componentType": 5126,
                          "count": len(pts), "type": "VEC3",
                          "min": pts.min(axis=0).tolist() if len(pts) else [0]*3,
                          "max": pts.max(axis=0).tolist() if len(pts) else [0]*3})
        return len(accessors) - 1

    def add_col(cols, n):
        if cols is None:
            return None
        cols = np.asarray(cols).reshape(-1, 3)
        if cols.dtype == np.uint8:
            cols = cols.astype(np.float32) / 255.0
        cols = np.clip(cols, 0, 1).astype(np.float32)
        assert len(cols) == n
        v = add_view(np.ascontiguousarray(cols).tobytes())
        accessors.append({"bufferView": v, "componentType": 5126,
                          "count": n, "type": "VEC3"})
        return len(accessors) - 1

    if mesh is not None and len(mesh["faces"]):
        attrs = {"POSITION": add_pos(mesh["vertices"])}
        ci = add_col(mesh.get("vertex_colors"), len(mesh["vertices"]))
        if ci is not None:
            attrs["COLOR_0"] = ci
        idx = np.ascontiguousarray(mesh["faces"], np.uint32)
        v = add_view(idx.tobytes())
        accessors.append({"bufferView": v, "componentType": 5125,
                          "count": idx.size, "type": "SCALAR"})
        primitives.append({"attributes": attrs, "indices": len(accessors) - 1,
                           "material": 0, "mode": 4})
    if points is not None and len(points):
        attrs = {"POSITION": add_pos(points)}
        ci = add_col(point_colors, len(np.asarray(points).reshape(-1, 3)))
        if ci is not None:
            attrs["COLOR_0"] = ci
        primitives.append({"attributes": attrs, "mode": 0})
    assert primitives, "empty scene"

    bin_blob = b"".join(buffers)
    bin_blob += b"\x00" * ((-len(bin_blob)) % 4)
    gltf = {
        "asset": {"version": "2.0", "generator": "spann3r_tpu"},
        "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": primitives}],
        "materials": [{"doubleSided": True,
                       "pbrMetallicRoughness": {"metallicFactor": 0.0}}],
        "buffers": [{"byteLength": len(bin_blob)}],
        "bufferViews": views, "accessors": accessors,
    }
    json_blob = json.dumps(gltf).encode("utf-8")
    json_blob += b" " * ((-len(json_blob)) % 4)
    total = 12 + 8 + len(json_blob) + 8 + len(bin_blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_blob), 0x4E4F534A))
        f.write(json_blob)
        f.write(struct.pack("<II", len(bin_blob), 0x004E4942))
        f.write(bin_blob)


def read_glb(path: str) -> dict:
    """Minimal GLB reader for the writers in this module (tests): returns
    {'json': gltf dict, 'positions': (N,3), 'indices': (F,3) or None,
    'colors': (N,3) or None}."""
    with open(path, "rb") as f:
        magic, version, _ = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67 and version == 2
        jlen, jtype = struct.unpack("<II", f.read(8))
        assert jtype == 0x4E4F534A
        gltf = json.loads(f.read(jlen))
        blen, btype = struct.unpack("<II", f.read(8))
        assert btype == 0x004E4942
        blob = f.read(blen)

    def acc_data(i, dtype, ncomp):
        acc = gltf["accessors"][i]
        view = gltf["bufferViews"][acc["bufferView"]]
        start = view.get("byteOffset", 0)
        raw = blob[start:start + view["byteLength"]]
        arr = np.frombuffer(raw, dtype=dtype)
        return arr.reshape(-1, ncomp) if ncomp > 1 else arr

    def read_prim(prim):
        d = {"mode": prim.get("mode", 4),
             "positions": acc_data(prim["attributes"]["POSITION"],
                                   np.float32, 3),
             "indices": None, "colors": None}
        if "indices" in prim:
            d["indices"] = acc_data(prim["indices"], np.uint32, 1) \
                .reshape(-1, 3)
        if "COLOR_0" in prim["attributes"]:
            d["colors"] = acc_data(prim["attributes"]["COLOR_0"],
                                   np.float32, 3)
        return d

    prims = [read_prim(p) for p in gltf["meshes"][0]["primitives"]]
    out = dict(prims[0], json=gltf, primitives=prims)
    out.pop("mode")
    return out


def write_glb_pointcloud(path: str, points: np.ndarray,
                         colors: Optional[np.ndarray] = None) -> None:
    """Minimal GLB (glTF 2.0 binary) with a POINTS-mode mesh.

    Standalone replacement for the trimesh export in the reference app
    (app.py:150-171)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = len(pts)
    buffers = [pts.tobytes()]
    accessors = [{
        "bufferView": 0, "componentType": 5126, "count": n, "type": "VEC3",
        "min": pts.min(axis=0).tolist(), "max": pts.max(axis=0).tolist()}]
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": len(buffers[0])}]
    attributes = {"POSITION": 0}

    if colors is not None:
        cols = np.asarray(colors).reshape(-1, 3)
        if cols.dtype == np.uint8:
            cols = cols.astype(np.float32) / 255.0
        cols = np.clip(cols, 0, 1).astype(np.float32)
        off = sum(len(b) for b in buffers)
        buffers.append(cols.tobytes())
        views.append({"buffer": 0, "byteOffset": off,
                      "byteLength": len(buffers[-1])})
        accessors.append({"bufferView": 1, "componentType": 5126, "count": n,
                          "type": "VEC3"})
        attributes["COLOR_0"] = 1

    bin_blob = b"".join(buffers)
    pad = (-len(bin_blob)) % 4
    bin_blob += b"\x00" * pad

    gltf = {
        "asset": {"version": "2.0", "generator": "spann3r_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attributes, "mode": 0}]}],
        "buffers": [{"byteLength": len(bin_blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    json_blob = json.dumps(gltf).encode("utf-8")
    json_blob += b" " * ((-len(json_blob)) % 4)

    total = 12 + 8 + len(json_blob) + 8 + len(bin_blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_blob), 0x4E4F534A))
        f.write(json_blob)
        f.write(struct.pack("<II", len(bin_blob), 0x004E4942))
        f.write(bin_blob)
