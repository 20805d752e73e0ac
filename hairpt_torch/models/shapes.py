"""Shape construction, host side, at scene build (port of
hairpt/models/shapes.py; numpy, so the port's copy is the same code).

The reference's shape plugins (src/shapes/): obj, ply, serialized,
rectangle, sphere, disk, cube and cylinder, each an indexed triangle mesh
that the scene build flattens into one triangle pool. The teapot OBJ of
the reference's teapot scene is absent, so teapot_standin stands in for
it; heightfield, lerp_mesh and vertex_gaussian_curvature give the
loader's heightfield and deformable shapes and curvature texture.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class Mesh(NamedTuple):
    positions: np.ndarray  # [V, 3] float64
    normals: Optional[np.ndarray]   # [V, 3] or None
    uvs: Optional[np.ndarray]       # [V, 2] or None
    faces: np.ndarray      # [F, 3] int32
    colors: Optional[np.ndarray] = None  # [V, 3] vertex colors or None


def transform_mesh(mesh: Mesh, to_world: np.ndarray) -> Mesh:
    m = np.asarray(to_world, np.float64)
    pos = mesh.positions @ m[:3, :3].T + m[:3, 3]
    normals = mesh.normals
    if normals is not None:
        it = np.linalg.inv(m[:3, :3]).T
        normals = normals @ it.T
        ln = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = normals / np.maximum(ln, 1e-12)
    return Mesh(pos, normals, mesh.uvs, mesh.faces)


def load_obj(path: str) -> Mesh:
    """Wavefront OBJ (reference: src/shapes/obj.cpp; mtl handled by the
    scene loader's BSDF refs instead)."""
    vs, vns, vts = [], [], []
    fv, fn, ft = [], [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "vn":
                vns.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "vt":
                vts.append([float(t[1]), float(t[2])])
            elif t[0] == "f":
                idx = []
                for w in t[1:]:
                    parts = (w.split("/") + ["", ""])[:3]
                    vi = int(parts[0])
                    ti = int(parts[1]) if parts[1] else 0
                    ni = int(parts[2]) if parts[2] else 0
                    idx.append((vi, ti, ni))
                for k in range(1, len(idx) - 1):  # fan triangulation
                    fv.append([idx[0][0], idx[k][0], idx[k + 1][0]])
                    ft.append([idx[0][1], idx[k][1], idx[k + 1][1]])
                    fn.append([idx[0][2], idx[k][2], idx[k + 1][2]])
    vs = np.asarray(vs, np.float64)
    faces_v = np.asarray(fv, np.int64)
    faces_v = np.where(faces_v > 0, faces_v - 1, len(vs) + faces_v)

    # re-index so each vertex carries its own normal/uv
    fn_a = np.asarray(fn, np.int64)
    ft_a = np.asarray(ft, np.int64)
    has_n = len(vns) > 0 and fn_a.max() != 0
    has_t = len(vts) > 0 and ft_a.max() != 0
    if not has_n and not has_t:
        return Mesh(vs, None, None, faces_v.astype(np.int32))
    vns_a = np.asarray(vns, np.float64) if has_n else None
    vts_a = np.asarray(vts, np.float64) if has_t else None
    flat_pos = vs[faces_v.reshape(-1)]
    normals = None
    uvs = None
    if has_n:
        ni = np.where(fn_a > 0, fn_a - 1, len(vns) + fn_a).reshape(-1)
        normals = vns_a[ni]
    if has_t:
        ti = np.where(ft_a > 0, ft_a - 1, len(vts) + ft_a).reshape(-1)
        uvs = vts_a[ti]
    faces = np.arange(len(flat_pos), dtype=np.int32).reshape(-1, 3)
    return Mesh(flat_pos, normals, uvs, faces)


def load_ply_ascii(path: str) -> Mesh:
    """Minimal ascii/binary-LE PLY loader (reference: src/shapes/ply)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("latin1").splitlines()
    n_vert = n_face = 0
    fmt = "ascii"
    props = []
    cur = None
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = t[1]
            if t[1] == "vertex":
                n_vert = int(t[2])
            elif t[1] == "face":
                n_face = int(t[2])
        elif t[0] == "property" and cur == "vertex":
            props.append(t[2])
    if fmt == "ascii":
        body = data[header_end:].decode("latin1").split()
        stride = len(props)
        vals = np.asarray(body[:n_vert * stride], np.float64).reshape(n_vert,
                                                                      stride)
        pos = vals[:, :3]
        ptr = n_vert * stride
        faces = []
        for _ in range(n_face):
            k = int(body[ptr]); ptr += 1
            poly = [int(x) for x in body[ptr:ptr + k]]; ptr += k
            for j in range(1, k - 1):
                faces.append([poly[0], poly[j], poly[j + 1]])
        return Mesh(pos, None, None, np.asarray(faces, np.int32))
    else:  # binary_little_endian, float vertices + uchar/int faces
        off = header_end
        vdata = np.frombuffer(data, "<f4", count=n_vert * len(props),
                              offset=off).reshape(n_vert, len(props))
        pos = vdata[:, :3].astype(np.float64)
        off += n_vert * len(props) * 4
        faces = []
        for _ in range(n_face):
            k = data[off]; off += 1
            poly = np.frombuffer(data, "<i4", count=k, offset=off)
            off += 4 * k
            for j in range(1, k - 1):
                faces.append([poly[0], poly[j], poly[j + 1]])
        return Mesh(pos, None, None, np.asarray(faces, np.int32))


# ---------------------------------------------------------------------------
# analytic primitives (tessellated; reference: src/shapes/{rectangle,sphere,
# disk,cube,cylinder}.cpp)
# ---------------------------------------------------------------------------

def rectangle() -> Mesh:
    """[-1,1]^2 in the xy-plane, +z normal, like the reference rectangle."""
    pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                   np.float64)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    n = np.tile([[0.0, 0.0, 1.0]], (4, 1))
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return Mesh(pos, n, uv, faces)


def sphere(radius: float = 1.0, n_theta: int = 32, n_phi: int = 64) -> Mesh:
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(T) * np.cos(P)
    y = np.sin(T) * np.sin(P)
    z = np.cos(T)
    pos = np.stack([x, y, z], -1).reshape(-1, 3)
    uv = np.stack([P / (2 * np.pi), T / np.pi], -1).reshape(-1, 2)
    faces = []
    W = n_phi + 1
    for i in range(n_theta):
        for j in range(n_phi):
            a, b, c, d = i * W + j, i * W + j + 1, (i + 1) * W + j, \
                (i + 1) * W + j + 1
            faces.append([a, b, d])
            faces.append([a, d, c])
    return Mesh(pos * radius, pos.copy(), uv,
                np.asarray(faces, np.int32))


def disk(n_phi: int = 64) -> Mesh:
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    rim = np.stack([np.cos(ph), np.sin(ph), np.zeros_like(ph)], -1)
    pos = np.concatenate([[[0, 0, 0]], rim])
    n = np.tile([[0.0, 0.0, 1.0]], (len(pos), 1))
    faces = [[0, 1 + i, 1 + (i + 1) % n_phi] for i in range(n_phi)]
    return Mesh(pos, n, None, np.asarray(faces, np.int32))


def cube() -> Mesh:
    meshes = []
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            m = np.eye(4)
            # rotate rectangle's +z to the face direction
            r = rectangle()
            basis = np.zeros((3, 3))
            basis[:, 2] = 0
            z = np.zeros(3); z[axis] = sgn
            a = np.zeros(3); a[(axis + 1) % 3] = 1.0
            b = np.cross(z, a)
            basis[:, 0] = a; basis[:, 1] = b; basis[:, 2] = z
            m[:3, :3] = basis
            m[:3, 3] = z
            meshes.append(transform_mesh(r, m))
    return merge(meshes)


def cylinder(radius: float = 1.0, n_phi: int = 64) -> Mesh:
    """Open cylinder along z from 0 to 1 (reference: cylinder.cpp is along
    the segment p0→p1; the scene loader applies the transform)."""
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    ring = np.stack([np.cos(ph), np.sin(ph), np.zeros_like(ph)], -1)
    bottom = ring.copy()
    top = ring.copy(); top[:, 2] = 1.0
    pos = np.concatenate([bottom * [radius, radius, 1],
                          top * [radius, radius, 1]])
    n = np.concatenate([ring * [1, 1, 0], ring * [1, 1, 0]])
    W = n_phi + 1
    faces = []
    for j in range(n_phi):
        faces.append([j, j + 1, W + j + 1])
        faces.append([j, W + j + 1, W + j])
    return Mesh(pos, n, None, np.asarray(faces, np.int32))


def merge(meshes) -> Mesh:
    pos, norm, uv, faces = [], [], [], []
    off = 0
    any_n = any(m.normals is not None for m in meshes)
    any_t = any(m.uvs is not None for m in meshes)
    for m in meshes:
        pos.append(m.positions)
        if any_n:
            norm.append(m.normals if m.normals is not None
                        else np.zeros_like(m.positions))
        if any_t:
            uv.append(m.uvs if m.uvs is not None
                      else np.zeros((len(m.positions), 2)))
        faces.append(m.faces + off)
        off += len(m.positions)
    return Mesh(np.concatenate(pos),
                np.concatenate(norm) if any_n else None,
                np.concatenate(uv) if any_t else None,
                np.concatenate(faces).astype(np.int32))


# ---------------------------------------------------------------------------
# procedural stand-in for the missing teapot OBJs
# ---------------------------------------------------------------------------

def teapot_standin(scale: float = 3.0) -> Mesh:
    """A revolution-surface 'teapot' (body + lid knob + spout + handle);
    the reference's models/Mesh00{0,1}.obj are absent from the repo."""
    # body profile: radius as a function of height
    t = np.linspace(0, 1, 24)
    prof_r = 0.35 + 1.05 * np.sin(np.pi * (t * 0.82 + 0.07)) * (1 - 0.3 * t)
    prof_h = t * 1.5
    n_phi = 48
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    R, P = np.meshgrid(prof_r, ph, indexing="ij")
    H, _ = np.meshgrid(prof_h, ph, indexing="ij")
    pos = np.stack([R * np.cos(P), H, R * np.sin(P)], -1).reshape(-1, 3)
    faces = []
    W = n_phi + 1
    for i in range(len(t) - 1):
        for j in range(n_phi):
            a, b, c, d = i * W + j, i * W + j + 1, (i + 1) * W + j, \
                (i + 1) * W + j + 1
            faces.append([a, d, b]); faces.append([a, c, d])
    body = Mesh(pos, None, None, np.asarray(faces, np.int32))

    knob = sphere(0.18, 8, 16)
    knob = transform_mesh(knob, np.array([[1, 0, 0, 0], [0, 1, 0, 1.62],
                                          [0, 0, 1, 0], [0, 0, 0, 1.0]]))
    # spout: tilted cone of rings
    s_t = np.linspace(0, 1, 8)
    s_r = 0.22 - 0.12 * s_t
    cx = 1.05 + 1.0 * s_t
    cy = 0.55 + 0.75 * s_t
    rings = []
    for k in range(len(s_t)):
        ring = np.stack([np.full(12, cx[k]),
                         cy[k] + s_r[k] * np.sin(np.linspace(0, 2 * np.pi, 12,
                                                             endpoint=False)),
                         s_r[k] * np.cos(np.linspace(0, 2 * np.pi, 12,
                                                     endpoint=False))], -1)
        rings.append(ring)
    sp_pos = np.concatenate(rings)
    sp_faces = []
    for k in range(len(s_t) - 1):
        for j in range(12):
            a = k * 12 + j; b = k * 12 + (j + 1) % 12
            c = (k + 1) * 12 + j; d = (k + 1) * 12 + (j + 1) % 12
            sp_faces.append([a, b, d]); sp_faces.append([a, d, c])
    spout = Mesh(sp_pos, None, None, np.asarray(sp_faces, np.int32))

    # handle: torus arc
    u = np.linspace(-0.5 * np.pi, 0.5 * np.pi, 12)
    v = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    U, V = np.meshgrid(u, v, indexing="ij")
    hr, tr = 0.55, 0.08
    hx = -(1.05 + hr * np.sin(U) + tr * np.cos(V) * np.sin(U))
    hy = 0.85 + hr * np.cos(U) * 0.8 + tr * np.cos(V) * np.cos(U)
    hz = tr * np.sin(V)
    h_pos = np.stack([hx, hy, hz], -1).reshape(-1, 3)
    h_faces = []
    for i in range(len(u) - 1):
        for j in range(8):
            a = i * 8 + j; b = i * 8 + (j + 1) % 8
            c = (i + 1) * 8 + j; d = (i + 1) * 8 + (j + 1) % 8
            h_faces.append([a, b, d]); h_faces.append([a, d, c])
    handle = Mesh(h_pos, None, None, np.asarray(h_faces, np.int32))

    m = merge([body, knob, spout, handle])
    return Mesh(m.positions * scale, None, None, m.faces)


def compute_smooth_normals(mesh: Mesh) -> Mesh:
    """Area-weighted vertex normals (reference: TriMesh::computeNormals,
    src/librender/trimesh.cpp)."""
    pos = mesh.positions
    f = mesh.faces
    fn = np.cross(pos[f[:, 1]] - pos[f[:, 0]], pos[f[:, 2]] - pos[f[:, 0]])
    normals = np.zeros_like(pos)
    for k in range(3):
        np.add.at(normals, f[:, k], fn)
    ln = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.maximum(ln, 1e-12)
    return Mesh(pos, normals, mesh.uvs, mesh.faces)


def load_serialized(path: str, shape_index: int = 0) -> Mesh:
    """Mitsuba `.serialized` mesh format (reference:
    src/librender/trimesh.cpp:175-300 loadCompressed — little-endian header
    0x041C + version, zlib-compressed body with flags/counts/attribute
    blocks, end-of-file offset dictionary for multi-shape files)."""
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    fmt, version = np.frombuffer(data[:4], "<u2")
    if fmt != 0x041C:
        raise ValueError(f"not a .serialized file: {path}")
    offset = 0
    if shape_index != 0:
        count = int(np.frombuffer(data[-4:], "<u4")[0])
        if version == 0x0004:
            table = np.frombuffer(data[-4 - 8 * count:-4], "<u8")
        else:
            table = np.frombuffer(data[-4 - 4 * count:-4], "<u4")
        offset = int(table[shape_index])
    body = zlib.decompress(data[offset + 4:])

    pos = 0

    def take(n):
        nonlocal pos
        out = body[pos:pos + n]
        pos += n
        return out

    flags = int(np.frombuffer(take(4), "<u4")[0])
    if version == 0x0004:
        end = body.index(b"\0", pos)
        pos = end + 1
    n_vert = int(np.frombuffer(take(8), "<u8")[0])
    n_tri = int(np.frombuffer(take(8), "<u8")[0])
    double = bool(flags & 0x2000)
    ftype, fsize = ("<f8", 8) if double else ("<f4", 4)

    def farr(n):
        return np.frombuffer(take(n * fsize), ftype).astype(np.float64)

    positions = farr(n_vert * 3).reshape(-1, 3)
    normals = None
    if flags & 0x0001:
        normals = farr(n_vert * 3).reshape(-1, 3)
    uvs = None
    if flags & 0x0002:
        uvs = farr(n_vert * 2).reshape(-1, 2)
    if flags & 0x0008:
        farr(n_vert * 3)  # vertex colors (unused)
    faces = np.frombuffer(take(n_tri * 12), "<u4").astype(
        np.int32).reshape(-1, 3)
    return Mesh(positions, normals, uvs, faces)


def heightfield(heights, scale_xy: float = 1.0, scale_z: float = 1.0,
                flip: bool = False) -> Mesh:
    """Regular-grid heightfield tessellated to triangles (reference:
    src/shapes/heightfield.cpp — that plugin intersects the grid
    analytically; a wavefront tracer over a triangle pool tessellates
    once at load instead).

    heights: [H, W] array; the surface spans x,y ∈ [-1, 1]·scale_xy with
    z = heights·scale_z (Mitsuba's heightfield convention, +z up in
    object space)."""
    h = np.asarray(heights, np.float32)
    H, W = h.shape
    xs = np.linspace(-1, 1, W, dtype=np.float32) * scale_xy
    ys = np.linspace(-1, 1, H, dtype=np.float32) * scale_xy
    px, py = np.meshgrid(xs, ys)
    pos = np.stack([px, py, h * scale_z], axis=-1).reshape(-1, 3)
    idx = np.arange(H * W).reshape(H, W)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    f1 = np.stack([a, b, c], axis=-1)
    f2 = np.stack([b, d, c], axis=-1)
    faces = np.concatenate([f1, f2]).astype(np.int32)
    if flip:
        faces = faces[:, ::-1]
    mesh = Mesh(positions=pos, faces=faces, normals=None, uvs=np.stack(
        [(px + scale_xy) / (2 * scale_xy), (py + scale_xy) /
         (2 * scale_xy)], -1).reshape(-1, 2).astype(np.float32))
    return compute_smooth_normals(mesh)


def lerp_mesh(a: Mesh, b: Mesh, t: float) -> Mesh:
    """Keyframe morph (reference: src/shapes/deformable.cpp evaluated at
    a fixed scene time; per-ray motion blur is a roadmap item)."""
    assert a.positions.shape == b.positions.shape
    pos = a.positions * (1.0 - t) + b.positions * t
    mesh = Mesh(positions=pos.astype(np.float32), faces=a.faces,
                normals=None, uvs=a.uvs)
    return compute_smooth_normals(mesh)


def vertex_gaussian_curvature(mesh: Mesh) -> np.ndarray:
    """Per-vertex Gaussian curvature via angle deficit
    (2π − Σ incident angles) / (mixed area) — feeds the `curvature`
    visualization texture (reference: src/textures/curvature.cpp uses the
    mesh differential geometry computed in trimesh.cpp)."""
    v = np.asarray(mesh.positions, np.float64)
    f = mesh.faces
    deficit = np.full(len(v), 2.0 * np.pi)
    area = np.zeros(len(v))
    for k in range(3):
        a = v[f[:, k]]
        b = v[f[:, (k + 1) % 3]]
        c = v[f[:, (k + 2) % 3]]
        e1 = b - a
        e2 = c - a
        cosang = (e1 * e2).sum(1) / np.maximum(
            np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1), 1e-20)
        ang = np.arccos(np.clip(cosang, -1, 1))
        np.subtract.at(deficit, f[:, k], ang)
        tri_a = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        np.add.at(area, f[:, k], tri_a / 3.0)
    return (deficit / np.maximum(area, 1e-12)).astype(np.float32)
